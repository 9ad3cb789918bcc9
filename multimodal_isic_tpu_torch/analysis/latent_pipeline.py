"""Latent extraction (the ``save_latent.py`` workload) with dense tables.

Counterpart of ``multimodal_isic_tpu/analysis/latent_pipeline.py``: the
mask-ratio-0 ConvMAE encoder over batches, per-image [P, D] patch latents,
pooled max and mean, patch ↔ lesion-mask overlap flags, the dense
patch-level table and PCA(0.90) fit on the train patches.  Everything stays
a tensor on the model's device (the JAX module copies to numpy) until
``extract_latents`` builds the reference's six pandas frames
(``bundle_to_frames``, ``table_to_frame``; JAX :118-187), with each row's
image and segmentation paths.  pandas is imported where a frame is built.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..models.convmae import ConvMAE
from ..ops.patches import patch_overlap_mask
from ..train.mae import make_encoder_step
from . import pca as PCA

Table = Dict[str, torch.Tensor]


class LatentBundle(NamedTuple):
    """Dense per-image latents for one split."""
    latents: torch.Tensor         # [N, P, D] float32
    pooled_max: torch.Tensor      # [N, D]
    pooled_mean: torch.Tensor     # [N, D]
    ids_restore: torch.Tensor     # [N, P]
    lesion_overlap: torch.Tensor  # [N, P] bool
    targets: torch.Tensor         # [N]
    image_paths: List
    segmentation_paths: List


def extract_latent_bundle(model: ConvMAE, loader: Iterable[Dict],
                          paths_from: Optional[Tuple[Sequence, Sequence]]
                          = None) -> LatentBundle:
    """Run the encoder over a loader of device batches: dicts with 'image'
    [B, 224, 224, 3] (normalised), 'mask' [B, 224, 224] and 'target'.
    ``paths_from`` gives (image paths, segmentation paths) in the loader's
    order (else None for each row)."""
    step = make_encoder_step(model)
    lat, ids, overlap, targets = [], [], [], []
    for batch in loader:
        latent, ids_restore = step(batch["image"])
        lat.append(latent)
        ids.append(ids_restore)
        overlap.append(patch_overlap_mask(batch["mask"], 16))
        targets.append(batch["target"])
    latents = torch.cat(lat)
    image_paths, seg_paths = (paths_from if paths_from is not None
                              else ([None] * len(latents),) * 2)
    return LatentBundle(latents, latents.amax(dim=1), latents.mean(dim=1),
                        torch.cat(ids), torch.cat(overlap), torch.cat(targets),
                        list(image_paths), list(seg_paths))


def patch_table(bundle: LatentBundle, remove_background: bool = False
                ) -> Table:
    """Dense patch-level view: [N, P, D] → [N·P, D] with aligned image
    indices, patch ids, in-mask flags and targets, optionally without the
    background patches.  At mask ratio 0 the encoder keeps the grid order,
    so row (n, p)'s flag is ``lesion_overlap[n, ids_restore[n, p]]``, the
    reference's per-row lookup (``save_latent.py:121-127``)."""
    n, p, d = bundle.latents.shape
    dev = bundle.latents.device
    patch_ids = bundle.ids_restore.reshape(-1)
    image_idx = torch.arange(n, device=dev).repeat_interleave(p)
    in_mask = bundle.lesion_overlap[image_idx, patch_ids].to(torch.int32)
    table = {
        "image_idx": image_idx,
        "patch_id": patch_ids,
        "patch_latent": bundle.latents.reshape(n * p, d),
        "patch_in_mask": in_mask,
        "target": bundle.targets.repeat_interleave(p),
    }
    if remove_background:
        keep = in_mask.bool()
        table = {k: v[keep] for k, v in table.items()}
    return table


def apply_pca(train_table: Table, test_table: Table, variance: float = 0.90
              ) -> Tuple[Table, Table, PCA.PCAState]:
    """PCA(variance) fit on the train patches, both tables transformed
    (``save_latent.py:159-181``)."""
    state = PCA.fit(train_table["patch_latent"], variance)
    train_table = dict(train_table)
    test_table = dict(test_table)
    train_table["patch_latent_pca"] = PCA.transform(
        state, train_table["patch_latent"])
    test_table["patch_latent_pca"] = PCA.transform(
        state, test_table["patch_latent"])
    return train_table, test_table, state


def extract_latent_tables(model: ConvMAE, train_loader: Iterable[Dict],
                          test_loader: Iterable[Dict], train_paths=None,
                          test_paths=None, remove_background: bool = False,
                          pca_enabled: bool = False):
    """The ``extract_latents`` workload (``save_latent.py:13-200``) up to
    the dense tables → (train_table, test_table, train_bundle, test_bundle,
    PCA state or None).  Without PCA the tables' ``patch_latent_pca`` is
    ``patch_latent``, as the reference copies it."""
    train_bundle = extract_latent_bundle(model, train_loader, train_paths)
    test_bundle = extract_latent_bundle(model, test_loader, test_paths)
    train_table = patch_table(train_bundle, remove_background)
    test_table = patch_table(test_bundle, remove_background)
    print(f"Total lesion-overlapping patches (train_val): "
          f"{int(train_table['patch_in_mask'].sum())}")
    print(f"Total lesion-overlapping patches (test): "
          f"{int(test_table['patch_in_mask'].sum())}")
    state = None
    if pca_enabled:
        train_table, test_table, state = apply_pca(train_table, test_table)
        print(f"PCA reduced dimensions from {train_bundle.latents.shape[-1]} "
              f"to {state.components.shape[0]}")
    else:
        print("PCA disabled via config; using raw patch_latent as "
              "patch_latent_pca.")
        for table in (train_table, test_table):
            table["patch_latent_pca"] = table["patch_latent"]
    return train_table, test_table, train_bundle, test_bundle, state


# ------------------------------------------------- reference-API DataFrames

def _rows(t: torch.Tensor) -> list:
    """A [N, ...] tensor → a list of N numpy rows (an object column)."""
    return list(t.cpu().numpy())


def bundle_to_frames(bundle: LatentBundle):
    """(pooled frame, raw frame) with the reference's columns
    (``save_latent.py:65-96``; JAX :118-138)."""
    import pandas as pd  # local: host-only dependency

    targets = bundle.targets.cpu().numpy()
    pooled = pd.DataFrame({
        "image_path": bundle.image_paths,
        "segmentation_path": bundle.segmentation_paths,
        "target": targets,
        "latent_pooled_max": _rows(bundle.pooled_max),
        "latent_pooled_mean": _rows(bundle.pooled_mean),
        "ids_restore": _rows(bundle.ids_restore),
    })
    g = int(round(bundle.lesion_overlap.shape[1] ** 0.5))
    raw = pd.DataFrame({
        "image_path": bundle.image_paths,
        "segmentation_path": bundle.segmentation_paths,
        "target": targets,
        "latent": _rows(bundle.latents),
        "ids_restore": _rows(bundle.ids_restore),
        "lesion_mask_patches": _rows(bundle.lesion_overlap.reshape(-1, g, g)),
    })
    return pooled, raw


def table_to_frame(table: Table, bundle: LatentBundle):
    """The patch-level frame with the reference's columns
    (``save_latent.py:129-149``; JAX :141-157)."""
    import pandas as pd  # local: host-only dependency

    idx = table["image_idx"].cpu().numpy()
    frame = pd.DataFrame({
        "image_path": [bundle.image_paths[i] for i in idx],
        "segmentation_path": [bundle.segmentation_paths[i] for i in idx],
        "target": table["target"].cpu().numpy(),
        "patch_id": table["patch_id"].cpu().numpy(),
        "patch_latent": _rows(table["patch_latent"]),
        "patch_in_mask": table["patch_in_mask"].cpu().numpy(),
    })
    frame["patch_latent_pca"] = _rows(table["patch_latent_pca"])
    return frame


def extract_latents(model: ConvMAE, train_loader: Iterable[Dict],
                    test_loader: Iterable[Dict], train_paths=None,
                    test_paths=None, remove_background: bool = False,
                    pca_enabled: bool = False):
    """The full ``extract_latents`` contract (``save_latent.py:13-200``;
    JAX :160-187) → (patch_level_train_df, patch_level_test_df,
    latent_pooled_train, latent_pooled_test, latent_raw_train,
    latent_raw_test)."""
    train_table, test_table, train_bundle, test_bundle, _ = \
        extract_latent_tables(model, train_loader, test_loader, train_paths,
                              test_paths, remove_background, pca_enabled)
    pooled_train, raw_train = bundle_to_frames(train_bundle)
    pooled_test, raw_test = bundle_to_frames(test_bundle)
    return (table_to_frame(train_table, train_bundle),
            table_to_frame(test_table, test_bundle),
            pooled_train, pooled_test, raw_train, raw_test)
