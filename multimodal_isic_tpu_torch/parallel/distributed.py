"""Multi-process runtime: the ``torch.distributed`` group, a rank's card,
its rows of a global batch and the host-side gathers.

Counterpart of ``multimodal_isic_tpu/parallel/distributed.py`` (:1-220).
JAX joins every process to one runtime whose global arrays span every chip,
and XLA inserts the collectives.  Here each process is one rank of a
``torch.distributed`` group with one device, a rank holds its own rows of
a global batch, and the collectives are explicit (``parallel.sharding``,
``parallel.batchnorm``, ``parallel.tp``, the train steps).

- :func:`initialize` joins the group: explicit arguments win, then
  ``ISIC_COORDINATOR`` (``host:port``) / ``ISIC_NUM_PROCESSES`` /
  ``ISIC_PROCESS_ID``; with neither a coordinator, a process count nor a
  store it stays single-process.  It is idempotent.  The rendezvous is
  ``tcp://`` at the coordinator (``host:port``), a ``FileStore`` where the
  coordinator is a ``file://`` URL (ranks of one host; the tests and the
  launcher, ``parallel.launch``), or the ``torch.distributed.Store`` the
  caller passes.
- The backend (:func:`choose_backend`): ``nccl`` when every rank has a
  card of its own, ``gloo`` when ranks share a card (NCCL refuses two
  ranks on one device; an indexed ``cuda:N`` is every rank's card) or run
  on the CPU; the caller (``backend=``) or the launcher (``ISIC_BACKEND``)
  may name one.  The choice is printed, and nothing switches backend after
  a failure.  Gloo takes CUDA tensors only in
  ``broadcast`` and ``all_reduce``, so every collective of the port is one
  of those two (a gather is an ``all_reduce`` of zero-filled slots,
  :func:`gather_to_host`).
- The ranks run on one host: a rank's card (:func:`rank_device`) is its
  rank modulo the device count.
- :func:`process_epoch_order` / :func:`process_local_rows` are numpy: the
  same slices as JAX's for every rank and world size.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

ENV_COORD = "ISIC_COORDINATOR"      # e.g. "10.0.0.1:8476"
ENV_NPROC = "ISIC_NUM_PROCESSES"
ENV_PID = "ISIC_PROCESS_ID"
ENV_BACKEND = "ISIC_BACKEND"        # 'nccl' or 'gloo' instead of the rule
MULTIPROCESS_ENV = (ENV_COORD, ENV_NPROC, ENV_PID)
BACKENDS = ("nccl", "gloo")


def _dist():
    import torch.distributed as dist
    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The default group's world size, 1 without a group."""
    return _dist().get_world_size() if is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default group, 0 without a group."""
    return _dist().get_rank() if is_initialized() else 0


def is_coordinator() -> bool:
    """True on the process that writes checkpoints, logs and artifacts
    (rank 0)."""
    return process_index() == 0


def rank_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The rank's device: for ``'cuda'`` (no index) the rank modulo the
    device count; an indexed card or the CPU as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for and this machine "
                           "has none; set device: cpu to run on the CPU")
    return torch.device("cuda", process_index() % torch.cuda.device_count())


def choose_backend(requested: Optional[str], device: torch.device,
                   ranks: int) -> Tuple[str, str]:
    """→ (backend, why): the requested one, else ``nccl`` where the
    ``ranks`` have a card each and ``gloo`` where they share one or run on
    the CPU.  An indexed card (``cuda:N``) is every rank's card, so more
    than one rank there share it."""
    if requested:
        if requested not in BACKENDS:
            raise ValueError(f"backend {requested!r}: expected one of "
                             f"{BACKENDS}")
        if requested == "nccl" and device.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device")
        return requested, "asked for"
    if device.type != "cuda":
        return "gloo", "CPU ranks"
    if device.index is not None and ranks > 1:
        return "gloo", f"{ranks} ranks share card cuda:{device.index}"
    cards = torch.cuda.device_count()
    if ranks <= cards:
        return "nccl", f"{ranks} rank(s) on {cards} card(s), one each"
    return "gloo", f"{ranks} ranks share {cards} card(s)"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, store=None,
               backend: Optional[str] = None,
               device: Union[str, torch.device] = "cuda") -> bool:
    """Join (or create) the default group → True, or stay single-process
    → False (no coordinator, process count or store anywhere).  Explicit
    arguments win over the ``ISIC_*`` variables.  ``device`` is the device
    kind the ranks compute on ('cuda' or 'cpu'; it picks the backend and,
    on a card, the rank's card is made current).  Idempotent: once joined,
    another call is a no-op (True)."""
    if is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(ENV_COORD)
    if num_processes is None and os.environ.get(ENV_NPROC):
        num_processes = int(os.environ[ENV_NPROC])
    if process_id is None and os.environ.get(ENV_PID):
        process_id = int(os.environ[ENV_PID])
    if coordinator_address is None and num_processes is None and store is None:
        return False
    if num_processes is None or process_id is None or (
            coordinator_address is None and store is None):
        raise ValueError(
            "multi-process run: give the coordinator (or a store), the "
            f"process count and the process id ({ENV_COORD}, {ENV_NPROC}, "
            f"{ENV_PID}), got {coordinator_address!r}, {num_processes!r}, "
            f"{process_id!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside "
                         f"{num_processes} processes")
    dev = torch.device(device)
    name, why = choose_backend(backend or os.environ.get(ENV_BACKEND), dev,
                               num_processes)
    card = ""
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else (
            process_id % torch.cuda.device_count())
        torch.cuda.set_device(index)
        card = f", card cuda:{index}"
    if store is not None:
        kwargs = {"store": store}
    else:
        kwargs = {"init_method": (
            coordinator_address if coordinator_address.startswith("file://")
            else f"tcp://{coordinator_address}")}
    print(f"torch.distributed: rank {process_id} of {num_processes}, "
          f"backend {name} ({why}){card}", flush=True)
    _dist().init_process_group(name, world_size=num_processes,
                               rank=process_id, **kwargs)
    return True


def shutdown() -> None:
    """Leave the default group (a no-op without one)."""
    if is_initialized():
        _dist().destroy_process_group()


def process_local_rows(n_global: int, world: Optional[int] = None,
                       rank: Optional[int] = None) -> slice:
    """The [start, stop) rows of a global batch of ``n_global`` this
    process loads (contiguous, in rank order)."""
    world = process_count() if world is None else world
    rank = process_index() if rank is None else rank
    if n_global % world:
        raise ValueError(f"global batch {n_global} not divisible by "
                         f"{world} processes")
    per = n_global // world
    return slice(rank * per, (rank + 1) * per)


def process_epoch_order(order, global_batch_size: int,
                        pad_to_full: bool = False,
                        world: Optional[int] = None,
                        rank: Optional[int] = None):
    """Split a global epoch order into this process's rows of each global
    batch → ``(local_order, per_process_batch_size, n_true)``.

    Global batch ``k`` covers ``order[k·G:(k+1)·G]`` and rank ``r`` loads
    its contiguous ``G/world`` rows, so the ranks' rows in rank order are
    the global batch.  Rows past the last full global batch are dropped,
    unless ``pad_to_full`` wraps the order to fill it (evaluation: trim the
    gathered results to ``n_true``).  An order shorter than one global
    batch raises."""
    order = np.asarray(order)
    world = process_count() if world is None else world
    rank = process_index() if rank is None else rank
    if global_batch_size % world:
        raise ValueError(f"global batch {global_batch_size} not divisible "
                         f"by {world} processes")
    per = global_batch_size // world
    n_true = len(order)
    if pad_to_full and n_true % global_batch_size:
        pad = global_batch_size - n_true % global_batch_size
        reps = -(-pad // max(n_true, 1))
        order = np.concatenate([order] + [order] * reps)[:n_true + pad]
    nb = len(order) // global_batch_size
    if nb == 0:
        raise ValueError(
            f"epoch order has {n_true} rows < one global batch "
            f"({global_batch_size}); shrink the global batch or pass "
            f"pad_to_full=True")
    local = order[:nb * global_batch_size].reshape(nb, world, per)[:, rank]
    return local.reshape(-1), per, n_true


def _group_size(group) -> int:
    return _dist().get_world_size(group) if is_initialized() else 1


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (one shape on every rank) stacked on dim 0 in
    rank order, on ``x``'s device: one ``all_reduce`` of zero-filled
    slots, so it runs on gloo with CUDA tensors (which has no
    ``all_gather`` for them) and on NCCL alike, and is exact (x + 0)."""
    world = _group_size(group)
    if world == 1:
        return x
    dist = _dist()
    wide = x.to(torch.uint8) if x.dtype == torch.bool else x
    slots = torch.zeros((world, *wide.shape), dtype=wide.dtype,
                        device=wide.device)
    slots[dist.get_rank(group)] = wide
    dist.all_reduce(slots, group=group)
    out = slots.reshape(world * wide.shape[0], *wide.shape[1:]) \
        if wide.dim() else slots
    return out.to(torch.bool) if x.dtype == torch.bool else out


def gather_to_host(x, group=None) -> np.ndarray:
    """``np.asarray`` of the rows of every rank in rank order (a tensor's
    rows in one process): the host copy of a batch-sharded value."""
    if isinstance(x, torch.Tensor):
        return gather_rows(x.detach(), group).cpu().numpy()
    return np.asarray(x)


def all_processes_equal(value: float, atol: float = 0.0) -> bool:
    """Whether every rank holds ``value`` (within ``atol``): a debugging
    aid for divergence hunts."""
    got = gather_rows(torch.tensor([float(value)], dtype=torch.float64,
                                   device=_collective_device()))
    return bool((got - got[0]).abs().max() <= atol)


def _collective_device() -> torch.device:
    """Where small host values go for a collective: the current card under
    NCCL, else the CPU."""
    if is_initialized() and _dist().get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_object(obj, group=None) -> list:
    """Every rank's picklable ``obj`` in rank order (``[obj]`` in one
    process): host values, so any backend takes them."""
    if _group_size(group) == 1:
        return [obj]
    out = [None] * _group_size(group)
    _dist().all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (``obj`` itself in one process)."""
    if process_count() == 1:
        return obj
    box = [obj]
    _dist().broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Wait for every rank (a no-op in one process)."""
    if process_count() > 1:
        _dist().barrier()


def setup(device: Union[str, torch.device] = "cuda", n_model: int = 1):
    """One-call bootstrap for the CLIs: join the group (``ISIC_*`` or the
    arguments) and, with more than one process, build the ``(data,
    model)`` grid → ``(multiproc, grid, rank_device)``; ``(False, None,
    device)`` in one process (``'cuda'`` is ``cuda:0`` there)."""
    device = torch.device(device)
    initialize(device=device)
    if process_count() <= 1:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", 0)
        return False, None, device
    from .sharding import make_grid
    return True, make_grid(n_model=n_model), rank_device(device)
