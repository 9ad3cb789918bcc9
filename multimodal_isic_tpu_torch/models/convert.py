"""Carry the JAX package's parameters over to the port's modules.

Reads either the nested flax dicts (``params``, ``batch_stats``) as numpy
arrays, or a checkpoint directory written by the JAX package's
``core/checkpoint.py::save_checkpoint`` (``arrays.npz`` plus
``manifest.json``, whose ``paths`` are "/"-joined, checkpoint.py:53-76),
with numpy and json alone.  A checkpoint the port wrote in the same layout
(``core/checkpoint.py``, manifest ``treedef`` "state_dict") is read as the
state dict it holds.  Returns a state dict for
``models.efficientnet.EfficientNet`` or ``models.fusion.MultiModalFusionNet``
(the port names its submodules after the flax tree; ``block_<i>`` becomes
``blocks.<i>``), or, through :func:`convmae_state_dict`, for
``models.convmae.ConvMAE`` (the upstream ConvMAE checkpoint naming); a JAX
``OptState`` of a ConvMAE becomes the port's AdamW state through
:func:`convmae_adamw_state`.

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

from ..core import checkpoint

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
    bare params tree), or one the port wrote → torch state dict."""
    with open(os.path.join(path, "manifest.json")) as f:
        if json.load(f).get("treedef") == checkpoint.TREEDEF:
            return checkpoint.restore_checkpoint(path)
    tree = read_checkpoint(path)
    if "params" not in tree:
        return flax_to_state_dict(tree)
    return flax_to_state_dict(tree["params"], tree.get("batch_stats"))


# ----------------------------------------------------------------- ConvMAE

_CBLOCK = {"LayerNorm_0": "norm1", "Conv_0": "conv1", "Conv_1": "attn",
           "Conv_2": "conv2", "LayerNorm_1": "norm2", "Conv_3": "mlp.fc1",
           "Conv_4": "mlp.fc2"}
_VIT = {("LayerNorm_0",): "norm1", ("Attention_0", "Dense_0"): "attn.qkv",
        ("Attention_0", "Dense_1"): "attn.proj", ("LayerNorm_1",): "norm2",
        ("Mlp_0", "Dense_0"): "mlp.fc1", ("Mlp_0", "Dense_1"): "mlp.fc2"}
_TOP = {"embed1": "patch_embed1.proj", "embed1_norm": "patch_embed1.norm",
        "embed2": "patch_embed2.proj", "embed2_norm": "patch_embed2.norm",
        "embed3": "patch_embed3.proj", "embed3_norm": "patch_embed3.norm",
        "encoder_norm": "norm", "decoder_embed": "decoder_embed",
        "decoder_norm": "decoder_norm", "decoder_pred": "decoder_pred"}


def _convmae_module(path: Tuple[str, ...]) -> str:
    """The flax module path of a JAX ConvMAE leaf → the port's (upstream
    ConvMAE) module name."""
    head = path[0]
    m = re.match(r"^(stage1|stage2|vit|dec_blocks)_(\d+)$", head)
    if m is None:
        return _TOP[head]
    kind, i = m.groups()
    prefix = {"stage1": "blocks1", "stage2": "blocks2", "vit": "blocks3",
              "dec_blocks": "decoder_blocks"}[kind]
    if kind.startswith("stage"):
        return f"{prefix}.{i}.{_CBLOCK[path[1]]}"
    return f"{prefix}.{i}.{_VIT[tuple(path[1:])]}"


def convmae_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``ConvMAE`` params (nested dicts of arrays) → the port's state
    dict, in the upstream ConvMAE naming: the exact inverse of the JAX
    ``models/convmae.py::port_torch_state_dict`` (conv HWIO → OIHW,
    depthwise [5, 5, 1, C] → [C, 1, 5, 5], Dense [in, out] → [out, in],
    LayerNorm scale → weight, ``pos_embed`` [N, D] → [1, N, D])."""
    out = {}
    for path, a in _leaves(params):
        if path == ("pos_embed",):
            key, a = "pos_embed", a[None]
        elif path == ("mask_token",):
            key = "mask_token"
        else:
            leaf = path[-1]
            if leaf == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                leaf = "weight"
            elif leaf == "scale":
                leaf = "weight"
            elif leaf != "bias":
                raise KeyError(f"unknown flax leaf {'/'.join(path)}")
            key = f"{_convmae_module(path[:-1])}.{leaf}"
        out[key] = torch.from_numpy(np.array(a, np.float32, order="C"))
    return out


def convmae_adamw_state(opt_state: Any, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """A JAX ``OptState(step, mu, nu)`` of a ConvMAE's AdamW
    (``core/optim.py:49-52``; moments as nested dicts of arrays, the params'
    tree) → a state dict for ``optimizer`` (the port's AdamW over
    ``model``'s parameters), to pass to ``optimizer.load_state_dict``.  The
    moments take the parameters' layout changes (:func:`convmae_state_dict`);
    every parameter gets JAX's step count."""
    step, mu, nu = opt_state
    mu_sd, nu_sd = convmae_state_dict(mu), convmae_state_dict(nu)
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    state = {i: {"step": torch.tensor(float(np.asarray(step))),
                 "exp_avg": mu_sd[names[id(p)]],
                 "exp_avg_sq": nu_sd[names[id(p)]]}
             for i, p in enumerate(params)}
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}
