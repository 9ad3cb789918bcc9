"""Multi-process HPO: trials sharded across processes, scheduler state
global.

Counterpart of ``multimodal_isic_tpu/hpo/distributed.py`` (:1-171).  The
reference hands Ray fractional GPUs and lets Ray's head process own the global
ASHA state and the results table (``tune_mil.py:142-149,243-274``).  Here
the single-process engines (the sequential ``run_search`` and the packed
cohorts) stay as they are and the distribution sits above them: each
process of a ``torch.distributed`` group runs a round-robin slice of the
trials on its own card, and the pieces Ray keeps in one place live
in a ``torch.distributed.Store`` (the default group's, or one passed in):

- :class:`CoordinationRungBoard`: ASHA rung results.  Each recorded value
  goes into the store and each stop decision reads the rung back, so a
  trial in one process is judged against the rungs of the others.
- :func:`publish_result` / :func:`collect_results`: the results table.
  Every process publishes its finished trials as JSON and then reads the
  full table back, so the best pick is the same everywhere (process 0
  alone writes the artifacts).
- :func:`global_failure_count`: the reference's ``max_failures`` budget
  counted across processes.

A store lists no directory, where JAX's coordination service does
(``key_value_dir_get``).  So every list here is a counter key and indexed
slots: ``store.add(counter, 1)`` hands out the next slot, the value goes to
``{prefix}/{slot}``, and a reader takes ``store.add(counter, 0)`` slots and
reads ``0..n-1`` (``store.get`` waits for a slot handed out and not yet
written).

In a single process (no initialised group of more than one, and no store
passed) everything is an in-memory no-op: the engines never branch on the
number of processes.  The group, its size and this process's rank are
``parallel.distributed``'s: ``cli.tune_mil`` joins it through
``cli.common.setup_processes`` (the ``ISIC_*`` variables).
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Dict, List, Optional

from ..parallel.distributed import process_count, process_index  # noqa: F401

_SEARCH_SEQ = itertools.count()


def default_store():
    """The default group's store when more than one process runs, else
    None."""
    if process_count() <= 1:
        return None
    from torch.distributed import distributed_c10d
    return distributed_c10d._get_default_store()


def search_namespace() -> str:
    """A store namespace for one search.  Every process calls the engines
    in the same order, so a counter of this process gives the same name in
    every process without an exchange."""
    return f"s{next(_SEARCH_SEQ)}"


def shard_indices(n: int, rank: Optional[int] = None,
                  world: Optional[int] = None) -> List[int]:
    """This process's round-robin slice of ``range(n)`` (all of it in one
    process).  Round-robin, not contiguous, so ASHA's first rungs see every
    process's trials from the start."""
    world = process_count() if world is None else world
    rank = process_index() if rank is None else rank
    if world <= 1:
        return list(range(n))
    return list(range(rank, n, world))


def _slots(store, prefix: str) -> List[str]:
    """Every value written under ``prefix`` so far, in slot order."""
    n = int(store.add(f"{prefix}/n", 0))
    return [store.get(f"{prefix}/{i}").decode() for i in range(n)]


def _append(store, prefix: str, value: str) -> None:
    slot = int(store.add(f"{prefix}/n", 1)) - 1
    store.set(f"{prefix}/{slot}", value)


class CoordinationRungBoard:
    """ASHA rung storage in a store.

    ``append(rung, value)`` records this trial's rung value and returns
    every value recorded at that rung so far across all processes: the list
    the scheduler takes its percentile of.  Without a store it is a dict of
    this process (the scheduler's own ``_rungs``)."""

    def __init__(self, namespace: str, store=None):
        self.ns = namespace
        self._store = default_store() if store is None else store
        self._local: Dict[int, List[float]] = {}

    def append(self, rung: int, value: float) -> List[float]:
        if self._store is None:
            vals = self._local.setdefault(rung, [])
            vals.append(value)
            return list(vals)
        prefix = f"hpo/{self.ns}/rung/{rung:06d}"
        _append(self._store, prefix, repr(float(value)))
        return [float(v) for v in _slots(self._store, prefix)]


def publish_result(namespace: str, trial_index: int, payload: Dict,
                   store=None) -> None:
    """Record one finished trial (final metrics and bookkeeping) for every
    process to collect.  No-op in one process."""
    store = default_store() if store is None else store
    if store is None:
        return
    _append(store, f"hpo/{namespace}/result",
            json.dumps({"index": int(trial_index), "payload": payload}))


def collect_results(namespace: str, expected: int,
                    max_failures: Optional[int] = None,
                    timeout_s: Optional[float] = None,
                    store=None) -> Dict[int, Dict]:
    """Every process's published trials → {trial_index: payload} ({} in one
    process).

    Polls until ``expected`` results exist rather than waiting at a
    barrier: slices of trials of different costs finish at very different
    times, and a fast process keeps waiting.  The deadline
    (``ISIC_HPO_COLLECT_TIMEOUT_S``, or ``timeout_s``; 24 h by default)
    bounds only a wedged search.  A blown global failure budget raises here
    too: the process that owns the missing trials has aborted."""
    store = default_store() if store is None else store
    if store is None:
        return {}
    deadline = time.time() + float(
        timeout_s if timeout_s is not None
        else os.environ.get("ISIC_HPO_COLLECT_TIMEOUT_S", 86400))
    prefix = f"hpo/{namespace}/result"
    while True:
        n = int(store.add(f"{prefix}/n", 0))
        if n >= expected:
            break
        if max_failures is not None:
            n_fail = global_failure_count(namespace, store=store)
            if n_fail >= max_failures:
                raise RuntimeError(
                    f"aborting search: {n_fail} trials failed across "
                    f"processes while waiting for results")
        if time.time() > deadline:
            raise RuntimeError(f"collect_results timed out: {n}/{expected} "
                               f"trial results published")
        time.sleep(0.5)
    out = {}
    for raw in _slots(store, prefix):
        entry = json.loads(raw)
        out[int(entry["index"])] = entry["payload"]
    return out


def global_failure_count(namespace: str, new_failure: bool = False,
                         store=None) -> Optional[int]:
    """The failed-trial count across processes, after recording one more
    failure where ``new_failure``; None in one process (the caller keeps
    its own count)."""
    store = default_store() if store is None else store
    if store is None:
        return None
    return int(store.add(f"hpo/{namespace}/failures",
                         1 if new_failure else 0))
