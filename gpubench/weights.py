"""Seeded weights by parameter name and shape, made on the device in two
large draws.

Both sides of a cell get the same tensors: the port loads them into its
module, the reference reads them as they are.  Nothing comes from the
port's own initialisers.  The rules go by the name's last part and the
tensor's rank:

- matrices and conv kernels (rank >= 2): normal with std 1/sqrt(fan_in)
  (fan_in: the elements of one output's slice), embeddings std
  1/sqrt(width), ``pos_embed`` and ``mask_token`` std 0.02;
- a rank-1 ``weight`` (a LayerNorm or BatchNorm scale): uniform 0.8-1.2;
- ``running_var``: uniform 0.5-1.5; ``running_mean``: normal std 0.1;
- any other rank-1 tensor (biases): normal std 0.02.

BatchNorm statistics that are not the identity keep the serving path's BN
fold from being vacuous.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Tuple

import torch

Shapes = Iterable[Tuple[str, Tuple[int, ...]]]
EMBEDDING = re.compile(r"(^|\.)\w+_emb(_\d+)?\.weight$")  # nn.Embedding tables


def _kind(name: str, shape: Tuple[int, ...]) -> Tuple[str, float, float]:
    """(draw, a, b): 'normal' with std ``a`` or 'uniform' on [a, b)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("pos_embed", "mask_token"):
        return "normal", 0.02, 0.0
    if EMBEDDING.search(name) and len(shape) == 2:
        return "normal", 1.0 / math.sqrt(shape[1]), 0.0
    if len(shape) >= 2:
        fan_in = math.prod(shape[1:])
        return "normal", 1.0 / math.sqrt(fan_in), 0.0
    if leaf == "running_var":
        return "uniform", 0.5, 1.5
    if leaf == "running_mean":
        return "normal", 0.1, 0.0
    if leaf == "weight":
        return "uniform", 0.8, 1.2
    return "normal", 0.02, 0.0


def seeded_state(shapes: Shapes, seed: int, device,
                 dtype: torch.dtype = torch.float32
                 ) -> Dict[str, torch.Tensor]:
    """name → tensor for every (name, shape), in ``dtype`` on ``device``:
    one normal and one uniform draw of all the elements, cut into the
    tensors in name order."""
    items = sorted((n, tuple(s)) for n, s in shapes)
    kinds = {n: _kind(n, s) for n, s in items}
    counts = {"normal": 0, "uniform": 0}
    for n, s in items:
        counts[kinds[n][0]] += math.prod(s)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    pool = {"normal": torch.randn(counts["normal"], generator=g,
                                  device=device, dtype=torch.float32),
            "uniform": torch.rand(counts["uniform"], generator=g,
                                  device=device, dtype=torch.float32)}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for n, s in items:
        draw, a, b = kinds[n]
        size = math.prod(s)
        flat = pool[draw][at[draw]:at[draw] + size]
        at[draw] += size
        t = flat * a if draw == "normal" else a + (b - a) * flat
        out[n] = t.reshape(s).to(dtype)
    return out
