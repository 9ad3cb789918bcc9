"""The resident training loop: the fold's crops live on the card, and each
step gathers its rows by the seeded order, runs the task's ``augment`` and
``model_step`` (the port's policy and training step) with no read-back.

Set-up drives the port's training-step object through its first
``compare_steps`` steps with the window's own calls (they warm up every
shape, and the comparison reads them), then ``warmup_steps`` more.  The
window issues steps while it is open; its clock stops at a final
``synchronize()`` after the last step issued, so the host running ahead is
paid for.  The same object, not a copy, runs the window.
"""

from __future__ import annotations

import time
from typing import Dict

import torch
from torch.profiler import record_function

from gpubench.common import no_gc


def _steps(task, first: int, seconds: float = None, count: int = None,
           timed: bool = False, out: Dict = None):
    cuda = task.device.type == "cuda"
    k = first
    t0 = time.perf_counter()
    while (seconds is None or time.perf_counter() - t0 < seconds) and \
            (count is None or k - first < count):
        with record_function("gb:gather"):
            batch = task.gather(k)
        if timed and cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            e0.record()
        with record_function("gb:augment"):
            x = task.augment(batch)
        if timed and cuda:
            e1.record()
            out["events"].append((e0, e1))
        h0 = time.perf_counter()
        with record_function("gb:step"):
            task.model_step(x, batch)
        if timed:
            out["dispatch_ms"].append((time.perf_counter() - h0) * 1e3)
        k += 1
    with record_function("gb:sync"):
        if cuda:
            torch.cuda.synchronize()
    return k, time.perf_counter() - t0


def run(task, traffic: Dict, seed: int, seconds: float, trace: bool,
        device) -> Dict:
    from gpubench import trace as tr
    n_cmp = int(traffic["compare_steps"])
    out = {"program": task.first_steps(n_cmp)}
    k, _ = _steps(task, n_cmp, count=int(traffic["warmup_steps"]))
    out["t_window"] = time.perf_counter()
    timed = {"events": [], "dispatch_ms": []}
    with no_gc():
        k2, window = _steps(task, k, seconds=seconds, timed=trace, out=timed)
    out.update(steps=k2 - k, img_s=(k2 - k) * task.batch / window)
    if trace:
        out["augment_ms"] = [e0.elapsed_time(e1) for e0, e1 in timed["events"]]
        out["dispatch_ms"] = timed["dispatch_ms"]
        if task.device.type == "cuda":
            n = int(traffic["trace_steps"])
            with tr.Segment(cpu=False) as seg:
                k3, _ = _steps(task, k2, count=n)
            out["segment"] = seg.summary(units=n)
            with tr.Segment(cpu=True) as seg:
                _steps(task, k3, count=tr.GAP_UNITS)
            gaps = seg.summary(tr.GAP_UNITS)["idle_gaps"]
            out["segment"]["idle_gaps"] = gaps
    return out


def check(task, readings: Dict, device) -> Dict[str, float]:
    """The first steps against the reference's, after ``task.release()``."""
    from gpubench.tasks import train_numbers
    ref = task.reference_steps(int(task.traffic["compare_steps"]))
    return train_numbers(readings["program"], ref)


def control(task, readings: Dict, device) -> Dict[str, float]:
    """The control put in the program's place: the reference with TF32 on
    against the reference with it off, over the same first steps."""
    from gpubench.tasks import train_numbers
    n = int(task.traffic["compare_steps"])
    return train_numbers(task.reference_steps(n, "tf32"),
                         task.reference_steps(n))
