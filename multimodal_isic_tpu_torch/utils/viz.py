"""Training visualisations of the MAE CLI (the reference's
``utils.py:34-148``, written to local PNG artifacts).

Counterpart of ``multimodal_isic_tpu/utils/viz.py`` (:1-199):

- ``latent_scatter``: PCA(0.90) → the top-2 principal components scattered
  by class;
- ``reconstruction_grid``: original / mask / reconstruction / overlay panels
  from an MAE output (unpatchify, ImageNet de-normalisation, the same
  clipping rules);
- ``embedding_scatter`` and ``interactive_scatter_html``: a precomputed
  2-D embedding as a PNG scatter and as one self-contained HTML page with
  a hover tooltip (``cli.cluster_latents --viz_out``; the reference's UMAP
  and bokeh plots, ``cluster_latents.py:175-225``), the JAX code copied.

Inputs are numpy arrays or CPU tensors.  matplotlib is imported inside each
function with the Agg backend.
"""

from __future__ import annotations

from typing import Optional

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


def embedding_scatter(emb2d: np.ndarray, targets: np.ndarray, out_path: str,
                      title: str = "") -> str:
    """Precomputed 2-D embedding + labels → scatter PNG (the reference's
    filtered UMAP plots, ``cluster_latents.py:175-217``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    emb = np.asarray(emb2d)
    targets = np.asarray(targets)
    fig, ax = plt.subplots(figsize=(6, 6))
    cmap = plt.get_cmap("tab10")
    for i, lbl in enumerate(np.unique(targets)):
        sel = targets == lbl
        ax.scatter(emb[sel, 0], emb[sel, 1], s=5, color=cmap(i % 10),
                   label=str(int(lbl)), alpha=0.8)
    ax.set_title(title or "neighbor embedding")
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


def interactive_scatter_html(emb2d: np.ndarray, targets: np.ndarray,
                             out_path: str, hover: Optional[list] = None,
                             title: str = "embedding") -> None:
    """Self-contained interactive 2-D scatter (pan-free canvas + hover
    tooltip), the dependency-free stand-in for the reference's bokeh plot
    (``cluster_latents.py:220-225``).  One HTML file, inline data, no CDN."""
    import html as _html
    import json

    emb2d = np.asarray(emb2d, np.float64)
    targets = np.asarray(targets).astype(int)
    hover = list(hover) if hover is not None else [str(t) for t in targets]
    data = [{"x": round(float(x), 4), "y": round(float(y), 4),
             "c": int(c), "t": str(h)}
            for (x, y), c, h in zip(emb2d, targets, hover)]
    title = _html.escape(str(title))
    palette = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
               "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"]
    html = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>{title}</title></head><body>
<h3>{title}</h3><canvas id="c" width="900" height="700"></canvas>
<div id="tip" style="position:absolute;background:#fff;border:1px solid #888;
padding:2px 6px;font:12px sans-serif;display:none"></div>
<script>
const data = {json.dumps(data).replace("</", "<\\/")};
const palette = {json.dumps(palette)};
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
// reduce, not Math.min(...xs): the spread form overflows the JS argument
// limit above ~65k points and patch-latent tables reach hundreds of
// thousands of rows
const xs = data.map(d=>d.x), ys = data.map(d=>d.y);
const x0 = xs.reduce((a,b)=>Math.min(a,b), Infinity);
const x1 = xs.reduce((a,b)=>Math.max(a,b), -Infinity);
const y0 = ys.reduce((a,b)=>Math.min(a,b), Infinity);
const y1 = ys.reduce((a,b)=>Math.max(a,b), -Infinity);
const px = d => 30 + (d.x - x0) / (x1 - x0 + 1e-9) * 840;
const py = d => 670 - (d.y - y0) / (y1 - y0 + 1e-9) * 640;
function draw() {{
  ctx.clearRect(0, 0, 900, 700);
  for (const d of data) {{
    ctx.fillStyle = d.c < 0 ? "#cccccc" : palette[d.c % palette.length];
    ctx.beginPath(); ctx.arc(px(d), py(d), 3, 0, 6.2832); ctx.fill();
  }}
}}
draw();
const tip = document.getElementById("tip");
cv.addEventListener("mousemove", ev => {{
  const r = cv.getBoundingClientRect();
  const mx = ev.clientX - r.left, my = ev.clientY - r.top;
  let best = null, bd = 64;
  for (const d of data) {{
    const dd = (px(d)-mx)**2 + (py(d)-my)**2;
    if (dd < bd) {{ bd = dd; best = d; }}
  }}
  if (best) {{
    tip.style.display = "block";
    tip.style.left = (ev.pageX + 12) + "px";
    tip.style.top = (ev.pageY + 12) + "px";
    tip.textContent = best.t + " (class " + best.c + ")";
  }} else tip.style.display = "none";
}});
</script></body></html>"""
    with open(out_path, "w") as f:
        f.write(html)
