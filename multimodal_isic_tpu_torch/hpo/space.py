"""Hyperparameter search spaces.

Counterpart of ``multimodal_isic_tpu/hpo/space.py`` (:1-101), pure numpy:
the same samplers (Ray Tune's primitives) and the reference's two spaces
(``tune_mil.py:161-200``), distribution for distribution, so one
``np.random.RandomState`` seed gives JAX's configs draw for draw.  The
classic-MIL space: hidden/att dims 32-1024, dropout 0-0.75, adam/adamw,
log-uniform lr, LINEAR-uniform wd ∈ [0, 1e-3].  The 19-dim Graph-MIL space:
gat/transformer, layers ∈ {2..8}, grid/knn graphs, k ∈ {4,8,12,16}, heads ∈
{1,2,4,8}, dims ∈ {64,128,256,384,512}, dropouts ∈ {0.3..0.75},
residual/layer-norm toggles, lr loguniform(1e-6,1e-3), wd
loguniform(1e-8,1e-3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence

import numpy as np


@dataclass(frozen=True)
class Uniform:
    low: float
    high: float

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))


@dataclass(frozen=True)
class LogUniform:
    low: float
    high: float

    def sample(self, rng):
        return float(np.exp(rng.uniform(np.log(self.low), np.log(self.high))))


@dataclass(frozen=True)
class QRandInt:
    low: int
    high: int
    q: int = 1

    def sample(self, rng):
        v = rng.randint(self.low, self.high + 1)
        return int(round(v / self.q) * self.q)


@dataclass(frozen=True)
class Choice:
    options: Sequence[Any]

    def sample(self, rng):
        return self.options[rng.randint(len(self.options))]


def sample_config(space: Dict[str, Any], rng: np.random.RandomState) -> Dict[str, Any]:
    out = {}
    for key, spec in space.items():
        out[key] = spec.sample(rng) if hasattr(spec, "sample") else spec
    return out


# the reference's classic-MIL space (tune_mil.py:162-169): randint(32, 1025)
# over both dims, uniform dropout and weight_decay (tune.uniform(0, 1e-3) is
# LINEAR, not log — wd=0 is in-support), log-uniform lr
MIL_SPACE: Dict[str, Any] = {
    "hidden_dim": QRandInt(32, 1024),
    "att_dim": QRandInt(32, 1024),
    "dropout": Uniform(0.0, 0.75),
    "optimizer": Choice(["adam", "adamw"]),
    "lr": LogUniform(1e-7, 1e-3),
    "weight_decay": Uniform(0.0, 1e-3),
}

# the reference's Graph-MIL space (tune_mil.py:172-200), distribution-exact:
# every discrete key is tune.choice over the SAME menu (incl. att_heads=8,
# classifier_dim 384/512, the {0.3..0.75} dropout grids), lr loguniform
# (1e-6, 1e-3), weight_decay loguniform(1e-8, 1e-3)
GRAPH_MIL_SPACE: Dict[str, Any] = {
    "gnn_type": Choice(["gat", "transformer"]),
    "gnn_hidden": Choice([64, 128, 256, 384, 512]),
    "gnn_layers": Choice([2, 3, 4, 5, 6, 7, 8]),
    "gnn_dropout": Choice([0.3, 0.4, 0.5, 0.6, 0.7, 0.75]),
    "gnn_heads": Choice([1, 2, 4, 8]),
    "gnn_concat": Choice([True, False]),
    "graph_type": Choice(["grid", "knn"]),
    "k_neighbors": Choice([4, 8, 12, 16]),
    "connect_diagonals": Choice([False, True]),
    "att_dim": Choice([64, 128, 256, 384, 512]),
    "att_heads": Choice([1, 2, 4, 8]),
    "pool_dropout": Choice([0.3, 0.4, 0.5, 0.6, 0.7, 0.75]),
    "classifier_dim": Choice([64, 128, 256, 384, 512]),
    "classifier_light": Choice([True, False]),
    "use_residual": Choice([True, False]),
    "use_layer_norm": Choice([True, False]),
    "optimizer": Choice(["adam", "adamw"]),
    "lr": LogUniform(1e-6, 1e-3),
    "weight_decay": LogUniform(1e-8, 1e-3),
}
