"""Readers of the program's spans that record many times a unit (a span a
block, 24 blocks a step), beside ``spans.py``, whose ``records`` takes one
record a unit.

A record's ``unit`` is the id of the outermost span open when it opened:
the step's, for every span inside one train step.  The device-only
segment's steps are the first ``segment["units"]`` units that hold the
span, in the order they opened (``spans.py``: the segment's records come
first).  A program without the span, or a run without a segment, reads
None.
"""

from __future__ import annotations

from statistics import mean
from typing import Dict, List, Optional


def unit_groups(ctx: Dict, name: str) -> List[List]:
    """The closed records of the span ``name``, grouped by unit, of the
    first ``segment["units"]`` units that hold it."""
    seg = ctx.get("segment")
    if seg is None:
        return []
    try:
        from multimodal_isic_tpu_torch.utils import trace
    except ImportError:
        return []
    groups: Dict[int, List] = {}
    for r in trace.spans():
        if r.name == name and r.end_ns is not None:
            groups.setdefault(r.unit, []).append(r)
    return list(groups.values())[:seg["units"]]


def summed_stream_ms(ctx: Dict, name: str) -> Optional[float]:
    """The stream ms of every occurrence of the span ``name`` in a unit,
    summed, mean over the units; None where a record has no stream time."""
    groups = unit_groups(ctx, name)
    if not groups or any(r.device_ms is None for g in groups for r in g):
        return None
    return mean(sum(r.device_ms for r in g) for g in groups)
