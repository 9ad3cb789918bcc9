"""The closed inference loop: ``in_flight`` batches in flight, each handed
to the loop as a slice of the pinned host pool.

Per batch: the rows go to the card on a side copy stream (the port's
``DeviceLoader`` does the same), then the task's ``preprocess`` and
``model`` run on the main stream under ``torch.inference_mode()``, and the
output comes back into a pinned host buffer.  A batch's latency runs from
the moment it is handed to the loop to the moment the host sees its output
complete.  The loop hands a new batch whenever fewer than ``in_flight`` are
pending and the window is open, then drains; the window's length is from
its start to the last completion, and every batch issued counts.

The answers compared are a sample of the completed batches, drawn from the
seed (reservoir sampling, ``sample_batches`` of them), kept in pinned
buffers of their own and compared with the reference once the window has
closed and the port's state is freed.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from gpubench.common import no_gc, sub_seed


class Loop:
    def __init__(self, task, traffic: Dict, seed: int, device):
        self.task, self.traffic = task, traffic
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.b = int(traffic["batch"])
        self.n_pool = int(next(iter(task.pool.values())).shape[0])
        self.k = int(traffic["in_flight"])
        shape, dtype = task.out_shape()
        n_out = self.k + int(traffic["sample_batches"])
        self.free = [torch.empty(shape, dtype=dtype, pin_memory=self.cuda)
                     for _ in range(n_out)]
        self.dev_in = [{key: torch.empty((self.b, *v.shape[1:]), dtype=v.dtype,
                                         device=self.device)
                        for key, v in task.pool.items()}
                       for _ in range(self.k)]
        self.copy_stream = torch.cuda.Stream() if self.cuda else None
        self.rng = np.random.RandomState(sub_seed(seed, "sample") % 2 ** 32)
        self.kept: List = []  # (batch index, host output)
        self.seen = 0         # window batches completed
        self.events = None    # (start, end) CUDA events around preprocess
        self.host_ms: List[float] = []

    def rows(self, i: int) -> np.ndarray:
        start = (i * self.b) % self.n_pool
        return (start + np.arange(self.b)) % self.n_pool

    def _h2d(self, i: int, slot: int) -> None:
        start = (i * self.b) % self.n_pool
        first = min(self.b, self.n_pool - start)
        for key, host in self.task.pool.items():
            dst = self.dev_in[slot][key]
            dst[:first].copy_(host[start:start + first], non_blocking=True)
            if first < self.b:
                dst[first:].copy_(host[:self.b - first], non_blocking=True)

    def issue(self, i: int, timed: bool):
        """Hand batch ``i`` to the loop → (handed at, done event, output)."""
        t_hand = time.perf_counter()
        slot = i % self.k
        with record_function("gb:h2d"):
            if self.cuda:
                with torch.cuda.stream(self.copy_stream):
                    self._h2d(i, slot)
                    copied = torch.cuda.Event()
                    copied.record()
                torch.cuda.current_stream().wait_event(copied)
            else:
                self._h2d(i, slot)
        batch = self.dev_in[slot]
        out = self.free.pop()
        with torch.inference_mode():
            if timed and self.cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            with record_function("gb:preprocess"):
                x = self.task.preprocess(batch)
            if timed and self.cuda:
                e1.record()
                self.events.append((e0, e1))
            t0 = time.perf_counter()
            with record_function("gb:model"):
                y = self.task.model(x, batch)
            if timed:
                self.host_ms.append((time.perf_counter() - t0) * 1e3)
            with record_function("gb:d2h"):
                out.copy_(y, non_blocking=True)
        done = None
        if self.cuda:
            done = torch.cuda.Event()
            done.record()
        return t_hand, done, out

    def complete(self, i: int, out) -> None:
        """Keep batch ``i``'s output in the sample or free its buffer."""
        n_keep = int(self.traffic["sample_batches"])
        self.seen += 1
        if len(self.kept) < n_keep:
            self.kept.append((i, out))
            return
        j = self.rng.randint(0, self.seen)
        if j < n_keep:
            self.free.append(self.kept[j][1])
            self.kept[j] = (i, out)
        else:
            self.free.append(out)

    def run(self, seconds: float = None, first: int = 0, timed: bool = False,
            keep: bool = True, max_batches: int = None) -> Dict:
        """Batches ``first``, ``first + 1``, ... while the window is open
        (``seconds`` of it, or ``max_batches``); → latencies (s), batches,
        window (s)."""
        if timed:
            self.events, self.host_ms = [], []
        pending, lat = deque(), []
        i = first
        t0 = time.perf_counter()
        t_end = t0
        while True:
            open_ = (seconds is None or time.perf_counter() - t0 < seconds) \
                and (max_batches is None or i - first < max_batches)
            if open_ and len(pending) < self.k:
                pending.append((i, *self.issue(i, timed)))
                i += 1
                continue
            if not pending:
                break
            j, t_hand, done, out = pending.popleft()
            if done is not None:
                with record_function("gb:wait"):
                    done.synchronize()
            t_end = time.perf_counter()
            lat.append(t_end - t_hand)
            if keep:
                self.complete(j, out)
            else:
                self.free.append(out)
        return {"latency_s": lat, "batches": len(lat),
                "window_s": t_end - t0, "next": i}


def run(task, traffic: Dict, seed: int, seconds: float, trace: bool,
        device) -> Dict:
    """Warm-up (the cell's shapes only), the window, and with ``trace`` a
    profiled segment after it → the driver's readings."""
    from gpubench import trace as tr
    loop = Loop(task, traffic, seed, device)
    warm = loop.run(max_batches=int(traffic["warmup_batches"]), keep=False)
    if loop.cuda:
        torch.cuda.synchronize()
    out = {"t_window": time.perf_counter()}
    with no_gc():
        win = loop.run(seconds, first=warm["next"], timed=trace)
    out.update(batches=win["batches"], latency_s=win["latency_s"],
               img_s=win["batches"] * loop.b / win["window_s"])
    if trace:
        out["augment_ms"] = [e0.elapsed_time(e1) for e0, e1 in loop.events]
        out["dispatch_ms"] = loop.host_ms
        if loop.cuda:
            with tr.Segment(cpu=False) as seg:
                s = loop.run(float(traffic["trace_seconds"]),
                             first=win["next"], keep=False)
            out["segment"] = seg.summary(units=s["batches"])
            with tr.Segment(cpu=True) as seg:
                g = loop.run(max_batches=tr.GAP_UNITS, first=s["next"],
                             keep=False)
            gaps = seg.summary(g["batches"])["idle_gaps"]
            out["segment"]["idle_gaps"] = gaps
    out["kept"] = loop.kept
    out["rows"] = loop.rows
    return out


def _sampled(task, readings: Dict, device):
    """(kept output, its batch's inputs) of each sampled batch: the inputs
    are its pool rows again, copied to the card."""
    for i, host_out in readings["kept"]:
        rows = torch.as_tensor(readings["rows"](i))
        yield host_out, {k: v[rows].to(device) for k, v in task.pool.items()}


def check(task, readings: Dict, device) -> Dict[str, float]:
    """The sampled answers against the reference, after
    ``task.release()``."""
    from gpubench.tasks import infer_numbers
    outs, refs = [], []
    for host_out, batch in _sampled(task, readings, device):
        refs.append(task.reference(batch).float().cpu())
        outs.append(host_out.clone())
    return infer_numbers(task.compare, outs, refs)


def control(task, readings: Dict, device) -> Dict[str, float]:
    """The control put in the program's place: the reference in float8
    (``reference.lowp.fp8``) on the same sampled batches, against the
    float32 reference."""
    from gpubench.reference.lowp import fp8
    from gpubench.tasks import infer_numbers
    outs, refs = [], []
    for _, batch in _sampled(task, readings, device):
        refs.append(task.reference(batch).float().cpu())
        outs.append(task.reference(batch, fp8).float().cpu())
    return infer_numbers(task.compare, outs, refs)
