"""Readers of the program's own spans (the port's ``utils/trace.py``).

The port keeps its spans in memory while a profiler records, so after a
traced run they hold the device-only segment's units first, then the
host-and-device segment's.  A reader takes the first ``units`` closed
records of its span, the device-only segment's: the later segment records
every host operator and starves the card.  That holds while no profiler
runs in the process before the device-only segment; a driver that traces
earlier has to call ``trace.reset()`` just before that segment.  A program
without the spans, or a run without a segment, reads None.

A span's stream ms is the time between its two CUDA events on its stream:
the device's work inside the span and any wait of the stream for the host
there, so a starved card reads longer.  A span's host ms is read under the
device-only profiler, whose callbacks run at every launch: it is the
host's time under that profiler, not its dispatch time without one.
"""

from __future__ import annotations

from statistics import mean, median
from typing import Dict, List, Optional


def records(ctx: Dict, name: str) -> List:
    """The first ``segment["units"]`` closed records of the span ``name``."""
    seg = ctx.get("segment")
    if seg is None:
        return []
    try:
        from multimodal_isic_tpu_torch.utils import trace
    except ImportError:
        return []
    recs = [r for r in trace.spans() if r.name == name
            and r.end_ns is not None]
    return recs[:seg["units"]]


def stream_ms(ctx: Dict, name: str) -> Optional[float]:
    """Mean stream ms of the span ``name`` an occurrence."""
    vals = [r.device_ms for r in records(ctx, name)
            if r.device_ms is not None]
    return mean(vals) if vals else None


def host_ms(ctx: Dict, *names: str) -> Optional[float]:
    """Median host ms of the first of ``names`` that has records."""
    for name in names:
        recs = records(ctx, name)
        if recs:
            return median(r.host_ms for r in recs)
    return None
