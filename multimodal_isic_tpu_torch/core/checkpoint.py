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
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Union

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
