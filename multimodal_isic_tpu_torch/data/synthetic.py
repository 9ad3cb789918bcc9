"""Synthetic ISIC-like samples (numpy).

Counterpart of ``multimodal_isic_tpu/data/synthetic.py:19-47``: the class and
metadata vocabularies and the per-sample renderer.  Writing a dataset to disk
(``make_synthetic_isic``, cv2 and pandas) comes with the host-data port.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

DX_CLASSES = ["akiec", "bcc", "bkl", "df", "mel", "nv", "vasc"]
SEX_VALUES = ["female", "male", "unknown"]
LOC_VALUES = [
    "abdomen", "acral", "back", "chest", "ear", "face", "foot", "genital",
    "hand", "lower extremity", "neck", "scalp", "trunk", "unknown",
    "upper extremity",
]
ARTIFACT_COLS = ["hair", "ruler_marks", "bubbles", "vignette", "frame", "other"]


def _render_sample(rng: np.random.RandomState, h: int, w: int,
                   class_idx: int) -> Tuple[np.ndarray, np.ndarray]:
    """A skin-toned noisy background with an elliptical 'lesion' whose colour
    and texture depend on the class, plus the binary mask (255 inside).
    Draws from ``rng`` in the JAX package's order, so a seed gives the same
    sample in both."""
    base = np.array([180, 140, 120], np.float32) + rng.randn(3) * 10
    img = base[None, None, :] + rng.randn(h, w, 3).astype(np.float32) * 8

    cy = rng.randint(h // 4, 3 * h // 4)
    cx = rng.randint(w // 4, 3 * w // 4)
    ry = rng.randint(h // 10, h // 4)
    rx = rng.randint(w // 10, w // 4)
    yy, xx = np.mgrid[0:h, 0:w]
    ellipse = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    mask = (ellipse * 255).astype(np.uint8)

    lesion_color = np.array([60 + 15 * class_idx, 40 + 8 * class_idx, 50],
                            np.float32)
    texture = rng.randn(h, w, 1).astype(np.float32) * (5 + 3 * class_idx)
    img = np.where(ellipse[..., None], lesion_color[None, None, :] + texture,
                   img)
    return np.clip(img, 0, 255).astype(np.uint8), mask
