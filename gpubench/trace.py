"""The traced segments: ``torch.profiler`` over stretches of the loop that
start and end with the device idle, and what the per-layer readers take
from them.

A :class:`Segment` traces the device alone (``cpu=False``: kernels, copies,
sets and the CUDA runtime calls) or the host's operators and the harness's
``gb:`` spans too (``cpu=True``).  Recording every host operator slows the
host of these eager steps enough to starve the card, so busy time, the
window and kernel times come from a device-only segment, and only the
idle gaps' attribution from a short host-and-device one.
A summary gives the device operations with their times, the union of their
intervals (``busy_s``) from the first device operation to the last
(``window_s``), the operations that took most time, and the idle gaps
summed by what the host was doing: the innermost ``gb:`` span and the
``aten::`` operator the host's main thread was in at the gap's middle.
A segment that recorded no device operation raises: a reader never reads a
dropped trace as zero.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Tuple

SPAN = "gb:"
GAP_UNITS = 4  # batches or steps of the host-and-device segment


class Segment:
    def __init__(self, cpu: bool):
        self.cpu = cpu

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                          if self.cpu else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.stop()
        return False

    def summary(self, units: int) -> Dict:
        """``units``: the batches or steps the segment ran."""
        return summarize(self.prof.profiler.kineto_results.events(),
                         self.t0, self.t1, units)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _innermost(starts, events, t):
    """The latest-starting event of ``events`` (sorted by start) that
    contains ``t``; scans back over at most 64 earlier starts."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 64, -1), -1):
        s, e, name = events[j]
        if e >= t:
            return name
    return None


def summarize(events, t0: int, t1: int, units: int) -> Dict:
    from torch.autograd import DeviceType
    device, spans, ops = [], [], []
    for ev in events:
        s, e = ev.start_ns(), ev.end_ns()
        if ev.device_type() == DeviceType.CUDA:
            # the harness's spans also appear on the device's track
            if e > s and not ev.name().startswith(SPAN):
                device.append((max(s, t0), min(e, t1), ev.name()))
        elif ev.name().startswith(SPAN):
            spans.append((s, e, ev.name()[len(SPAN):]))
        elif ev.name().startswith("aten::"):
            ops.append((s, e, ev.name()))
    if not device:
        raise RuntimeError("the traced segment recorded no device operation: "
                           "the profiler saw no CUDA activity")
    merged = _union([(s, e) for s, e, _ in device])
    busy = sum(e - s for s, e in merged)
    # the window: from the first device operation to the last (the
    # profiler's own start-up before the first is not the program's)
    t0, t1 = merged[0][0], merged[-1][1]
    by_name = defaultdict(float)
    for s, e, name in device:
        by_name[name] += (e - s) / 1e9
    gaps = []
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    for i in range(0, len(edges), 2):
        if edges[i + 1] > edges[i]:
            gaps.append((edges[i], edges[i + 1]))
    spans.sort()
    ops.sort()
    span_starts = [s for s, _, _ in spans]
    op_starts = [s for s, _, _ in ops]
    idle = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        span = _innermost(span_starts, spans, mid) or "-"
        op = _innermost(op_starts, ops, mid) or "-"
        idle[f"{span}:{op}"] += (g1 - g0) / 1e9

    def top(d):
        return [[k[:160], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"kernels": [(name, (e - s) / 1e9) for s, e, name in device],
            "busy_s": busy / 1e9, "window_s": (t1 - t0) / 1e9,
            "units": units,
            "device_ops": top(by_name), "idle_gaps": top(idle)}


def kernel_seconds(segment: Dict, pattern) -> Tuple[float, int]:
    """(seconds, launches) of the segment's device operations whose name
    matches the compiled regex ``pattern``."""
    hits = [d for name, d in segment["kernels"] if pattern.search(name)]
    return sum(hits), len(hits)
