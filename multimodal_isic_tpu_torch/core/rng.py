"""Seeded RNG streams of ``torch.Generator``s.

Counterpart of ``multimodal_isic_tpu/core/rng.py``: a root seed fans out into
named streams, one per consumer (augmentation, dropout, shuffles, init), so
adding a consumer never perturbs another.  A stream's name is hashed by the
same stable hash (:19-24); where JAX folds the counter into a key, a stream
here hands out a fresh generator seeded from (root seed, name hash, index).
The generators live on the stream's device (the card unless the caller
asks for the CPU), so draws on the card need no host round trip.  The
numbers are not JAX's: ``jax.random`` and ``torch.Generator`` differ from
one seed.  Under data parallelism a :class:`ShardedGenerator` makes a
rank's batch draws (:func:`batch_rand`, :func:`batch_draws`) the rows of
the global batch's.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Union

import torch

Device = Union[str, torch.device]


def _stable_hash(name: str) -> int:
    """Deterministic 31-bit hash of a stream name (stable across processes,
    unlike Python's builtin ``hash``)."""
    digest = hashlib.sha256(name.encode()).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF


def _derive(*parts: int) -> int:
    """A 63-bit generator seed from integers."""
    digest = hashlib.sha256(b"".join(int(p).to_bytes(8, "little", signed=True)
                                     for p in parts)).digest()
    return int.from_bytes(digest[:8], "little") & 0x7FFFFFFFFFFFFFFF


def generator(seed: int, device: Device = "cuda") -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


class RngStream:
    """A named, stateful stream of generators derived from a root seed.

    >>> rng = RngStream(42, "augment", "cpu")
    >>> g1 = rng.next()      # a distinct generator each call
    >>> g_ep = rng.at(epoch) # or a pure, index-addressed one
    """

    def __init__(self, seed: int, name: str, device: Device = "cuda"):
        self.name = name
        self.device = torch.device(device)
        self._base = (int(seed), _stable_hash(name))
        self._counter = 0

    def at(self, index: int) -> torch.Generator:
        """Pure access: the generator for a given step or epoch index."""
        return generator(_derive(*self._base, index), self.device)

    def next(self) -> torch.Generator:
        g = self.at(self._counter)
        self._counter += 1
        return g

    def split(self, n: int) -> List[torch.Generator]:
        """n generators from one step of the stream."""
        base = _derive(*self._base, self._counter)
        self._counter += 1
        return [generator(_derive(base, i), self.device) for i in range(n)]


class RngPool:
    """Factory handing out independent :class:`RngStream` s from one seed."""

    def __init__(self, seed: int, device: Device = "cuda"):
        self.seed = int(seed)
        self.device = torch.device(device)
        self._streams: Dict[str, RngStream] = {}

    def stream(self, name: str) -> RngStream:
        if name not in self._streams:
            self._streams[name] = RngStream(self.seed, name, self.device)
        return self._streams[name]

    def __getitem__(self, name: str) -> RngStream:
        return self.stream(name)

    def state(self) -> Dict[str, object]:
        """The pool's position: its seed and each stream's counter (what a
        checkpoint needs to resume the same draws)."""
        return {"seed": self.seed,
                "counters": {k: s._counter for k, s in self._streams.items()}}

    def load_state(self, state: Dict[str, object]) -> None:
        if int(state["seed"]) != self.seed:
            raise ValueError(f"RNG state of seed {state['seed']} loaded into "
                             f"a pool of seed {self.seed}")
        for name, counter in dict(state["counters"]).items():
            self.stream(name)._counter = int(counter)


class ShardedGenerator:
    """A generator whose batch draws are those of the global batch.

    Under data parallelism each rank holds ``rows`` of a global batch of
    ``world · rows`` samples, and every rank's streams give the same
    generators (one seed).  A draw through :func:`batch_rand` or
    :func:`batch_draws` is made at the global batch's shape and the rank's
    rows ``[rank · rows, (rank + 1) · rows)`` are kept, so the ranks
    together draw exactly what one process draws for the global batch: the
    counterpart of ``jax.random`` drawing at a global array's shape
    (dropout, drop-connect, the augmentations' parameters and the MAE
    masks).  With ``world`` 1 the draws are the generator's own."""

    def __init__(self, generator: torch.Generator, world: int, rank: int):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        self.generator, self.world, self.rank = generator, int(world), int(rank)

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def get_state(self) -> torch.Tensor:
        return self.generator.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.generator.set_state(state)

    def rows(self, n: int) -> slice:
        """The rank's rows of a global batch of ``world · n``."""
        return slice(self.rank * n, (self.rank + 1) * n)


Rng = Union[torch.Generator, ShardedGenerator]


def batch_rand(rng: Rng, shape, device: Device) -> torch.Tensor:
    """``torch.rand(shape)`` from ``rng``, dim 0 the batch: a
    :class:`ShardedGenerator` draws the global batch and keeps its rows."""
    if not isinstance(rng, ShardedGenerator):
        return torch.rand(shape, generator=rng, device=device)
    n = shape[0]
    full = torch.rand((rng.world * n, *shape[1:]), generator=rng.generator,
                      device=device)
    return full[rng.rows(n)]


def batch_draws(rng: Rng, draw, bsz: int, *args):
    """``draw(generator, bsz, *args)``, a dict (of dicts) of tensors whose
    dim 0 is the batch: a :class:`ShardedGenerator` draws the global batch
    and keeps its rows of every tensor."""
    if not isinstance(rng, ShardedGenerator):
        return draw(rng, bsz, *args)
    rows = rng.rows(bsz)

    def keep(tree):
        if isinstance(tree, dict):
            return {k: keep(v) for k, v in tree.items()}
        return tree[rows]

    return keep(draw(rng.generator, rng.world * bsz, *args))


def at_state(rng: Rng, state: torch.Tensor) -> Rng:
    """A fresh generator of ``rng``'s kind and device at ``state``."""
    if isinstance(rng, ShardedGenerator):
        return ShardedGenerator(at_state(rng.generator, state), rng.world,
                                rng.rank)
    g = torch.Generator(device=rng.device)
    g.set_state(state)
    return g
