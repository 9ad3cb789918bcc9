"""Spans of the program's layers, kept in memory.

A span marks where one layer's work happens: a batch's preprocess, a
model's forward, the phases of a train step.  It records only while a
``torch.profiler`` is recording or inside :func:`recording`; otherwise
entering it is one flag test and a return (no ``record_function``, no CUDA
event, no allocation, no lock), and it records nothing during a CUDA-graph
capture either.

A record holds the span's name, its id, its parent's id, its unit's id
(the outermost span open on the thread when it opened, shared by every span
of one batch or step) and its host start and end in ns.  Durations come
from a monotonic clock; timestamps are on the clock of the profiler's
events (ns since the Unix epoch), through an offset taken when a unit
opens, so a long recording does not drift from the profiler's clock.
Where CUDA is initialised, a span also records a pair of timing events on
the current stream; :func:`spans` resolves them to ``device_ms``, so the
hot path never waits for the card.  ``device_ms`` is the stream's time
between the two events: the work launched inside the span, and any wait of
the stream for the host there.

Spans are not profiler ranges: a ``record_function`` range also lands on
the profiler's device track when the host is traced, where it would count
as device work, and costs microseconds a call with no profiler running.  A span
opened directly inside one of the same name records nothing, so nested
policies give one ``preprocess`` a batch.  Each thread has its own stack of
open spans.  Records accumulate, each with its two CUDA events until
:func:`spans` resolves them, until :func:`reset`: a long profiled run
resets between the stretches it reads.

    trace.reset()
    with trace.recording():
        step(batch)
    for r in trace.spans():
        print(r.name, r.host_ms, r.device_ms)
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Callable, Iterator, List, Optional

import torch
import torch.autograd.profiler as _profiler


class Record:
    """One span: ``end_ns`` is None while it is open; ``device_ms`` (the
    stream's time between the span's events) is None on the CPU and until
    :func:`spans` resolves it."""

    __slots__ = ("name", "id", "parent", "unit", "start_ns", "end_ns",
                 "device_ms", "_t0", "_e0", "_e1")

    def __init__(self, name: str, id: int, parent: Optional[int], unit: int,
                 start_ns: int, t0: int):
        self.name, self.id, self.parent, self.unit = name, id, parent, unit
        self.start_ns, self.end_ns, self._t0 = start_ns, None, t0
        self.device_ms = self._e0 = self._e1 = None

    @property
    def host_ms(self) -> Optional[float]:
        return None if self.end_ns is None else \
            (self.end_ns - self.start_ns) / 1e6

    def __repr__(self) -> str:
        return (f"Record({self.name!r}, id={self.id}, parent={self.parent}, "
                f"unit={self.unit}, host_ms={self.host_ms}, "
                f"device_ms={self.device_ms})")


class _Recorder:
    def __init__(self):
        self.forced = 0          # open recording() blocks
        self.records: List[Record] = []
        self.ids = itertools.count()
        self.local = threading.local()  # .stack of open records, .offset

    def stack(self) -> List[Record]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "record", "stack")

    def __init__(self, name: str):
        self.name = name
        self.record = None

    def __enter__(self):
        stack = _REC.stack()
        if stack and stack[-1].name == self.name:
            return self
        cuda = torch.cuda.is_initialized()
        if cuda and torch.cuda.is_current_stream_capturing():
            return self
        t0 = time.monotonic_ns()
        if not stack:
            _REC.local.offset = time.time_ns() - t0
        i = next(_REC.ids)
        r = Record(self.name, i, stack[-1].id if stack else None,
                   stack[0].id if stack else i, t0 + _REC.local.offset, t0)
        if cuda:
            r._e0 = torch.cuda.Event(enable_timing=True)
            r._e0.record()
        stack.append(r)
        _REC.records.append(r)
        self.record, self.stack = r, stack
        return self

    def __exit__(self, *exc) -> bool:
        r = self.record
        if r is None:
            return False
        if r._e0 is not None:
            r._e1 = torch.cuda.Event(enable_timing=True)
            r._e1.record()
        r.end_ns = r.start_ns + time.monotonic_ns() - r._t0
        self.stack.remove(r)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the span ``name`` while recording is
    on (module docstring), else does nothing."""
    if not (_REC.forced or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


def spanned(name: str) -> Callable:
    """The decorator form of :func:`span`: each call of the function is
    one span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not (_REC.forced or _profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside this block, with or without a profiler."""
    _REC.forced += 1
    try:
        yield
    finally:
        _REC.forced -= 1


def spans() -> List[Record]:
    """Every record since the last :func:`reset`, in the order the spans
    opened, each closed span's ``device_ms`` resolved (waiting for its end
    event)."""
    out = list(_REC.records)
    for r in out:
        if r._e1 is not None:
            r._e1.synchronize()
            r.device_ms = r._e0.elapsed_time(r._e1)
            r._e0 = r._e1 = None
    return out


def reset() -> None:
    """Drop every record."""
    _REC.records = []
