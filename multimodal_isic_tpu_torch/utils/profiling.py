"""Timing on the card.

Counterpart of ``multimodal_isic_tpu/utils/profiling.py::timeit_closed``
(:78): a chain of calls closed by one completion wait.  Here the chain is
bracketed by ``torch.cuda.Event``s and closed by a synchronize, so the time is
the device's, not the enqueue's.  A CPU tensor path has no such clock: the
function raises without CUDA rather than report a host time as a device one.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def timeit_closed(fn: Callable[[], object], iters: int = 10,
                  repeats: int = 3, warmup: int = 1) -> Dict[str, float]:
    """Per-call seconds of ``fn`` on the current CUDA stream: ``repeats``
    chains of ``iters`` calls, each timed by CUDA events → best, median and
    worst chain, plus every chain."""
    if not torch.cuda.is_available():
        raise RuntimeError("timeit_closed needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / iters)
    return {"best": min(times), "median": float(np.median(times)),
            "worst": max(times), "all": times}
