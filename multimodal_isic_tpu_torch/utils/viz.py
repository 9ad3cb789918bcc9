"""Training visualisations of the MAE CLI (the reference's
``utils.py:34-148``, written to local PNG artifacts).

Counterpart of the parts of ``multimodal_isic_tpu/utils/viz.py`` that
``cli/train_ae.py`` uses (:23-63, :92-134):

- ``latent_scatter``: PCA(0.90) → the top-2 principal components scattered
  by class;
- ``reconstruction_grid``: original / mask / reconstruction / overlay panels
  from an MAE output (unpatchify, ImageNet de-normalisation, the same
  clipping rules).

Inputs are numpy arrays or CPU tensors.  matplotlib is imported inside each
function with the Agg backend.
"""

from __future__ import annotations

import numpy as np
import torch

from ..analysis import pca as P
from ..data.augment import IMAGENET_MEAN, IMAGENET_STD
from ..ops.patches import unpatchify


def latent_scatter(latent_feats, targets, out_path: str, title: str = "",
                   seed: int = 42, balance_classes: bool = False,
                   max_per_class: int = 100) -> str:
    """(N, D) latent summaries + labels → scatter PNG; returns the path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    feats = np.asarray(latent_feats)
    targets = np.asarray(targets)
    if balance_classes:
        rng = np.random.RandomState(seed)
        counts = np.bincount(targets)
        per_class = min(max_per_class, int(counts[counts > 0].min()))
        keep = []
        for cls in np.unique(targets):
            idx = np.where(targets == cls)[0]
            keep.extend(rng.choice(idx, per_class, replace=False)
                        if len(idx) > per_class else idx)
        keep = np.asarray(keep)
        feats, targets = feats[keep], targets[keep]

    state = P.fit(feats, n_components=0.90)
    z = P.transform(state, feats).cpu().numpy()
    emb = (z[:, :2] if z.shape[1] >= 2
           else np.pad(z, ((0, 0), (0, 2 - z.shape[1]))))

    fig, ax = plt.subplots(figsize=(6, 6))
    cmap = plt.get_cmap("tab10")
    for i, lbl in enumerate(np.unique(targets)):
        sel = targets == lbl
        ax.scatter(emb[sel, 0], emb[sel, 1], s=5, color=cmap(i % 10),
                   label=str(int(lbl)), alpha=0.8)
    ax.set_title(title or f"MomentsConcat PCA{z.shape[1]} scatter")
    ax.axis("off")
    ax.legend(title="class", markerscale=3, fontsize="small",
              bbox_to_anchor=(1.05, 1), loc="upper left")
    plt.tight_layout()
    plt.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def _denorm(img: np.ndarray) -> np.ndarray:
    return img * np.asarray(IMAGENET_STD) + np.asarray(IMAGENET_MEAN)


def reconstruction_grid(image, pred_patches, mask, out_path: str,
                        norm_pix_loss: bool = False) -> str:
    """One sample's 4-panel grid (reference ``visualize_model_outputs``).

    image: [H, W, 3] normalised input; pred_patches: [N, p·p·3] decoder
    output; mask: [N] 1 = masked patch.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pred = torch.as_tensor(np.asarray(pred_patches))
    recon = unpatchify(pred[None], 16, 3)[0].numpy()
    mask = np.asarray(mask)
    img_vis = _denorm(np.asarray(image) / 1.0)
    recon_vis = _denorm(recon)
    g = int(round(mask.shape[0] ** 0.5))
    binary = np.repeat(np.repeat(mask.reshape(g, g), 16, 0), 16, 1)[..., None]

    if norm_pix_loss:
        mean, std = img_vis.mean(), img_vis.std()
        img_vis = (img_vis - mean) / (std + 1e-6)
        recon_vis = (recon_vis - mean) / (std + 1e-6)

    overlay = recon_vis * binary + img_vis * (1 - binary)
    panels = [np.clip(img_vis, 0, 1), np.clip(binary[..., 0], 0, 1),
              np.clip(recon_vis, 0, 1), np.clip(overlay, 0, 1)]
    titles = ["Original", "Mask", "Reconstruction", "Overlay"]

    fig, axs = plt.subplots(1, 4, figsize=(16, 4))
    for ax, panel, title in zip(axs, panels, titles):
        ax.imshow(panel, cmap="gray" if panel.ndim == 2 else None)
        ax.set_title(title)
        ax.axis("off")
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close(fig)
    return out_path
