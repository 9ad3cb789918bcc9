"""Helpers the per-layer readers in ``metrics/`` share.  A reader gets the
run's context: ``config``, ``traffic``, ``readings`` (the driver's),
``segment`` (the traced segment's summary, or None), ``builder`` (the
configuration's builder module) and ``memory_peak_bytes``.  It returns a
number, or None when it finds nothing to read."""

from __future__ import annotations

import re
import sys
from statistics import mean, median
from typing import Dict, Optional

from . import flops, trace


def mean_of(ctx: Dict, key: str) -> Optional[float]:
    vals = ctx["readings"].get(key) or []
    return mean(vals) if vals else None


def median_of(ctx: Dict, key: str) -> Optional[float]:
    vals = ctx["readings"].get(key) or []
    return median(vals) if vals else None


def roofline(ctx: Dict, pattern: str, bound_ms_per_unit: float,
             launches_per_unit: Optional[int]) -> Optional[float]:
    """Σ bound over Σ device time of the kernels matching ``pattern`` in the
    traced segment, in %: the bound of one unit (a batch or a step) times
    the units traced.  No match reads None: the harness then fails the
    run."""
    seg = ctx["segment"]
    if seg is None:
        return None
    seconds, launches = trace.kernel_seconds(seg, re.compile(pattern))
    if launches == 0:
        return None
    if launches_per_unit is not None and \
            launches != launches_per_unit * seg["units"]:
        print(f"gpubench: {launches} launches of {pattern!r} in "
              f"{seg['units']} units, expected {launches_per_unit} a unit",
              file=sys.stderr)
    return 100.0 * bound_ms_per_unit * 1e-3 * seg["units"] / seconds


def mfu(ctx: Dict, train: bool) -> Optional[float]:
    f = ctx["builder"].forward_flops(ctx["config"], ctx["traffic"])
    if train:
        f = flops.train_flops(f)
    peak = flops.PEAK_FLOPS[ctx["traffic"]["dtype"]]
    return 100.0 * f * ctx["readings"]["img_s"] / peak


def idle(ctx: Dict) -> Optional[float]:
    seg = ctx["segment"]
    if seg is None:
        return None
    return 100.0 * (1.0 - seg["busy_s"] / seg["window_s"])


def peak_gib(ctx: Dict) -> Optional[float]:
    peak = ctx["memory_peak_bytes"]
    return peak / 2 ** 30 if peak else None
