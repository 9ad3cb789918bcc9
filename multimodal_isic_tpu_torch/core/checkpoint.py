"""Save and restore a state dict in the JAX package's checkpoint layout.

Counterpart of ``multimodal_isic_tpu/core/checkpoint.py::save_checkpoint/
restore_checkpoint`` (:53-100): a directory holding ``arrays.npz`` (the
leaves, ``arr_<i>``) and ``manifest.json`` (``num_leaves``, ``dtypes``,
``shapes``, "/"-joined ``paths``, ``metadata``), the manifest written last and
atomically.  The leaves here are a torch state dict, its "."-joined keys
stored as "/"-joined paths, and the manifest's ``treedef`` is
``"state_dict"``; ``models/convert.py::state_dict_from_checkpoint`` reads
this layout and the JAX package's alike.  Sharding has no counterpart here:
one process, one card.

:func:`save_train_state` / :func:`restore_train_state` keep a whole training
state in the same layout, as the JAX MAE loop saves params + optimizer +
step + RNG (``train/mae.py:278-283``): the model's state dict under
``model.``, the optimizer's per-parameter tensors (AdamW's ``step``,
``exp_avg``, ``exp_avg_sq``) under ``opt.<index>.``, and in the manifest's
metadata the step, the optimizer's parameter groups and the ``RngPool``'s
stream counters (its generators are derived from them, so they are its
state).

:func:`restore_partial` (JAX :102-160) restores by name into a target state
dict, from a checkpoint the port wrote or one the JAX package wrote.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"
TREEDEF = "state_dict"


def save_checkpoint(directory: str, state_dict: StateDict,
                    step: Optional[int] = None,
                    metadata: Optional[dict] = None) -> str:
    """Write ``state_dict`` under ``directory/step_<N>`` (or ``directory``
    itself when ``step`` is None).  Returns the checkpoint path."""
    path = directory if step is None else os.path.join(directory,
                                                       f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    keys = list(state_dict)
    arrays = [state_dict[k].detach().cpu().numpy() for k in keys]
    np.savez(os.path.join(path, ARRAYS), *arrays)
    manifest = {
        "treedef": TREEDEF,
        "num_leaves": len(arrays),
        "dtypes": [str(a.dtype) for a in arrays],
        "shapes": [list(a.shape) for a in arrays],
        "paths": [k.replace(".", "/") for k in keys],
        "metadata": metadata or {},
    }
    tmp = os.path.join(path, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(path, MANIFEST))  # atomic: manifest last
    return path


def restore_checkpoint(path: str, target: Optional[StateDict] = None,
                       device: Union[str, torch.device, None] = None
                       ) -> StateDict:
    """Read a state dict written by :func:`save_checkpoint`.  With
    ``target`` (e.g. ``model.state_dict()``) the keys and shapes must match
    it and the tensors land on its devices; else on ``device`` (default the
    CPU)."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("treedef") != TREEDEF:
        raise ValueError(f"{path} is not a state-dict checkpoint (treedef "
                         f"{manifest.get('treedef')!r}); models/convert.py "
                         "reads the JAX package's checkpoints")
    with np.load(os.path.join(path, ARRAYS)) as data:
        out = {p.replace("/", "."): torch.from_numpy(data[f"arr_{i}"])
               for i, p in enumerate(manifest["paths"])}
    if target is not None:
        if out.keys() != target.keys():
            raise ValueError(f"checkpoint keys differ from the target's: "
                             f"{sorted(out.keys() ^ target.keys())[:8]}")
        for k, t in target.items():
            if tuple(out[k].shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch at {k}: checkpoint "
                                 f"{tuple(out[k].shape)} vs {tuple(t.shape)}")
            out[k] = out[k].to(t.device)
    elif device is not None:
        out = {k: v.to(device) for k, v in out.items()}
    return out


def _named_tensors(path: str, manifest: dict) -> StateDict:
    """A checkpoint's tensors under the port's state-dict names, with the
    aliases :func:`restore_partial` matches: a port train state's
    ``model.`` keys also without the prefix; a JAX tree's ConvMAE leaves
    through ``models/convert.py::convmae_state_dict`` (leaves no ConvMAE has
    are left out), a ``params/`` namespace (a JAX ``TrainState``) taken as
    the parameters, exact names first."""
    if manifest.get("treedef") == TREEDEF:
        out: StateDict = {}
        arrays = restore_checkpoint(path)
        for k, v in arrays.items():
            out.setdefault(k, v)
        for k, v in arrays.items():
            if k.startswith("model."):
                out.setdefault(k[len("model."):], v)
        return out
    from ..models.convert import convmae_state_dict, read_checkpoint
    tree = read_checkpoint(path)
    out = convmae_state_dict(tree, skip_unknown=True)
    if isinstance(tree.get("params"), dict):
        for k, v in convmae_state_dict(tree["params"],
                                       skip_unknown=True).items():
            out.setdefault(k, v)
    return out


def restore_partial(path: str, target: StateDict, strict: bool = False
                    ) -> StateDict:
    """Name-matched restore (the torch ``load_state_dict(strict=False)`` the
    reference relies on, ``train_ae.py:141``, ``save_latent.py:49``; JAX
    :102-160) → a new state dict: each ``target`` key the checkpoint holds
    with the same shape takes the checkpoint's tensor (on the target's
    device, in its dtype); the others keep the target's; extra checkpoint
    tensors are ignored.  Reads the port's checkpoints (a train state's
    ``model.`` prefix as an alias) and the JAX package's (ConvMAE params,
    bare or under ``params/``).  ``strict=True`` raises ``KeyError`` where
    a target key is missing or mismatched; 0 matched keys raise
    ``ValueError`` either way (random weights must not pass as restored)."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if "paths" not in manifest:
        raise ValueError("checkpoint has no leaf paths (older format)")
    found = _named_tensors(path, manifest)
    out: StateDict = {}
    missing = []
    for k, t in target.items():
        v = found.get(k)
        if v is not None and tuple(v.shape) == tuple(t.shape):
            out[k] = v.to(device=t.device, dtype=t.dtype)
        else:
            missing.append(k)
            out[k] = t
    if strict and missing:
        raise KeyError(f"missing/mismatched leaves in checkpoint: "
                       f"{missing[:8]}{'...' if len(missing) > 8 else ''}")
    if target and len(missing) == len(target):
        raise ValueError(
            f"restore_partial matched 0 of {len(target)} target leaves from "
            f"{path}; checkpoint paths look like {manifest['paths'][:3]} — "
            "wrong checkpoint or namespace")
    return out


def read_metadata(path: str) -> dict:
    """The ``metadata`` of a checkpoint's manifest."""
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)["metadata"]


def save_train_state(directory: str, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, step: int,
                     rng_pool: Any = None,
                     metadata: Optional[dict] = None) -> str:
    """Write model + optimizer + step + RNG under ``directory/step_<step>``
    → the checkpoint path."""
    arrays: StateDict = {f"model.{k}": v for k, v in model.state_dict().items()}
    opt = optimizer.state_dict()
    for idx, state in opt["state"].items():
        for name, t in state.items():
            arrays[f"opt.{idx}.{name}"] = torch.as_tensor(t)
    meta = {"step": int(step), "param_groups": opt["param_groups"],
            "rng_pool": rng_pool.state() if rng_pool is not None else None,
            **(metadata or {})}
    return save_checkpoint(directory, arrays, step=step, metadata=meta)


def restore_train_state(path: str, model: torch.nn.Module,
                        optimizer: Optional[torch.optim.Optimizer] = None,
                        rng_pool: Any = None) -> dict:
    """Load a :func:`save_train_state` checkpoint into ``model`` (and
    ``optimizer`` and ``rng_pool`` when given) → its metadata."""
    arrays = restore_checkpoint(path)
    meta = read_metadata(path)
    model.load_state_dict({k[len("model."):]: v for k, v in arrays.items()
                           if k.startswith("model.")})
    if optimizer is not None:
        state: Dict[int, Dict[str, torch.Tensor]] = {}
        for k, v in arrays.items():
            if k.startswith("opt."):
                _, idx, name = k.split(".", 2)
                state.setdefault(int(idx), {})[name] = v
        groups = [{**g, "betas": tuple(g["betas"])} if "betas" in g else g
                  for g in meta["param_groups"]]  # JSON made the tuple a list
        optimizer.load_state_dict({"state": state, "param_groups": groups})
    if rng_pool is not None and meta.get("rng_pool") is not None:
        rng_pool.load_state(meta["rng_pool"])
    return meta
