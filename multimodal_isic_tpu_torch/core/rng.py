"""Seeded RNG streams of ``torch.Generator``s.

Counterpart of ``multimodal_isic_tpu/core/rng.py``: a root seed fans out into
named streams, one per consumer (augmentation, dropout, shuffles, init), so
adding a consumer never perturbs another.  A stream's name is hashed by the
same stable hash (:19-24); where JAX folds the counter into a key, a stream
here hands out a fresh generator seeded from (root seed, name hash, index).
The generators live on the stream's device (the card unless the caller
asks for the CPU), so draws on the card need no host round trip.  The
numbers are not JAX's: ``jax.random`` and ``torch.Generator`` differ from
one seed.
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
