"""Patient bags from patch-level latents.

Counterpart of ``multimodal_isic_tpu/analysis/bags.py`` (:19-69), the
reference's grouping (``tune_mil.py:66-120``, ``use_latent.py:172-233``):
the patient id is the image basename's second underscore field, a
patient's patches are sorted by ``patch_id`` (stable sort), the bag's label
is the modal target, and patients come in sorted id order (pandas' default
``groupby`` sorts its keys; bag order feeds the stratified splitters, so
this order is what reproduces the reference's fold membership).  Bags are
host numpy arrays; pandas is imported where a frame is read.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Bags = Tuple[List[np.ndarray], List[int], List[str]]


def patient_id_from_path(image_path: str) -> str:
    """``basename.split('_')[1]`` (``tune_mil.py:66-71``); the stem where
    the name has no second field."""
    base = os.path.basename(str(image_path)).split(".")[0]
    parts = base.split("_")
    return parts[1] if len(parts) > 1 else base


def build_patient_bags(patch_df, latent_col: str = "patch_latent_pca"
                       ) -> Bags:
    """Patch-level DataFrame → (bags [N_i, D] float32, modal labels,
    patient ids)."""
    df = patch_df.copy()
    df["patient_id"] = df["image_path"].map(patient_id_from_path)
    bags, labels, patients = [], [], []
    for pid, group in df.groupby("patient_id", sort=True):
        group = group.sort_values("patch_id", kind="stable")
        bags.append(np.stack([np.asarray(v, np.float32)
                              for v in group[latent_col]]))
        labels.append(int(Counter(group["target"].astype(int))
                          .most_common(1)[0][0]))
        patients.append(pid)
    return bags, labels, patients


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def bags_from_table(table: Dict[str, torch.Tensor],
                    image_paths: Sequence[str],
                    latent_col: str = "patch_latent_pca") -> Bags:
    """The same bags from a dense table (``analysis.latent_pipeline.
    patch_table`` / ``apply_pca``: tensors on any device, or numpy), each
    patch's patient from ``image_paths[image_idx]``."""
    feats = _host(table[latent_col] if latent_col in table
                  else table["patch_latent"])
    image_idx, patch_id = _host(table["image_idx"]), _host(table["patch_id"])
    target = _host(table["target"])
    pids = np.array([patient_id_from_path(image_paths[i])
                     for i in image_idx])
    bags, labels, patients = [], [], []
    for pid in np.unique(pids):
        sel = np.where(pids == pid)[0]
        sel = sel[np.argsort(patch_id[sel], kind="stable")]
        bags.append(np.asarray(feats[sel], np.float32))
        labels.append(int(Counter(target[sel].tolist())
                          .most_common(1)[0][0]))
        patients.append(str(pid))
    return bags, labels, patients
