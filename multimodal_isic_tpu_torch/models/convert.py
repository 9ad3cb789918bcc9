"""Carry the JAX package's parameters over to the port's modules.

Reads either the nested flax dicts (``params``, ``batch_stats``) as numpy
arrays, or a checkpoint directory written by the JAX package's
``core/checkpoint.py::save_checkpoint`` (``arrays.npz`` plus
``manifest.json``, whose ``paths`` are "/"-joined, checkpoint.py:53-76),
with numpy and json alone.  Returns a state dict for
``models.efficientnet.EfficientNet`` or ``models.fusion.MultiModalFusionNet``
(the port names its submodules after the flax tree; ``block_<i>`` becomes
``blocks.<i>``).

Leaf mappings:
- Dense ``kernel`` [in, out] → ``weight`` [out, in];
- Conv ``kernel`` HWIO → ``weight`` OIHW; depthwise [K, K, 1, C] → [C, 1, K, K]
  (the same transpose);
- BatchNorm / LayerNorm ``scale`` → ``weight``, ``bias`` → ``bias``;
  ``batch_stats`` ``mean`` / ``var`` → ``running_mean`` / ``running_var``;
- ``Embed.embedding`` → ``Embedding.weight``;
- the fusion ``weights`` vector → the ``weights`` Parameter.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _module_key(parts: Tuple[str, ...]) -> str:
    return ".".join(re.sub(r"^block_(\d+)$", r"blocks.\1", p) for p in parts)


def _param(path: Tuple[str, ...], a: np.ndarray) -> Tuple[str, np.ndarray]:
    leaf = path[-1]
    if leaf == "kernel":
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    elif leaf not in ("bias", "weights"):
        raise KeyError(f"unknown flax leaf {'/'.join(path)}")
    return _module_key(path[:-1] + (leaf,)), a


def flax_to_state_dict(params: Dict[str, Any],
                       batch_stats: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, torch.Tensor]:
    """Nested flax ``params`` (+ ``batch_stats``) → torch state dict."""
    out = {}
    for path, a in _leaves(params):
        key, a = _param(path, a)
        out[key] = torch.from_numpy(np.array(a, np.float32, order="C"))
    for path, a in _leaves(batch_stats or {}):
        key = _module_key(path[:-1] + (_STATS[path[-1]],))
        out[key] = torch.from_numpy(np.array(a, np.float32, order="C"))
    return out


def read_checkpoint(path: str) -> Dict[str, Any]:
    """A ``save_checkpoint`` directory → the nested dict it was saved from
    (numpy leaves)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tree: Dict[str, Any] = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, p in enumerate(manifest["paths"]):
            parts = [s.lstrip(".") for s in p.split("/")]
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[f"arr_{i}"]
    return tree


def state_dict_from_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint of ``{"params", "batch_stats"}`` (or a TrainState, or a
    bare params tree) → torch state dict."""
    tree = read_checkpoint(path)
    if "params" not in tree:
        return flax_to_state_dict(tree)
    return flax_to_state_dict(tree["params"], tree.get("batch_stats"))
