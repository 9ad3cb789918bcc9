"""Synthetic ISIC-like dataset (numpy; cv2 and pandas to write it).

Counterpart of ``multimodal_isic_tpu/data/synthetic.py``: the class and
metadata vocabularies, the per-sample renderer (:19-47) and
``make_synthetic_isic`` (:50-115), which writes the reference's on-disk
contract (a metadata CSV, ``<image_id>.jpg`` photos and
``<image_id>_segmentation.png`` masks, label 255) with the same draws, so a
seed gives the same files in both packages.  cv2 and pandas are imported
inside it.
"""

from __future__ import annotations

import os
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


def make_synthetic_isic(
    root: str,
    n_train: int = 32,
    n_test: int = 16,
    image_hw: Tuple[int, int] = (450, 600),
    seed: int = 0,
    missing_fraction: float = 0.1,
) -> dict:
    """Write a synthetic dataset under ``root`` → a config ``dir`` dict
    pointing at it (the keys of the reference ``config.yml``)."""
    import cv2  # local: host-only dependencies
    import pandas as pd

    rng = np.random.RandomState(seed)
    h, w = image_hw
    layout = {}
    loc_pool = LOC_VALUES  # the test split draws only train-seen values
    for split, n in [("train", n_train), ("test", n_test)]:
        img_dir = os.path.join(root, split, "images")
        seg_dir = os.path.join(root, split, "segmentations")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(seg_dir, exist_ok=True)

        rows = []
        for i in range(n):
            dx_idx = (i % len(DX_CLASSES) if i < 2 * len(DX_CLASSES)
                      else rng.randint(len(DX_CLASSES)))
            image_id = f"SYN{split}_{i:07d}"
            img, mask = _render_sample(rng, h, w, dx_idx)
            cv2.imwrite(os.path.join(img_dir, f"{image_id}.jpg"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            cv2.imwrite(os.path.join(seg_dir, f"{image_id}_segmentation.png"),
                        mask)

            age = float(rng.choice([np.nan] * int(missing_fraction * 10)
                                   + list(range(20, 90, 5))))
            rows.append({
                "lesion_id": f"LES_{i:07d}",
                "image_id": image_id,
                "dx": DX_CLASSES[dx_idx],
                "dx_type": "histo",
                "age": age,
                "sex": rng.choice(SEX_VALUES[:2] + [np.nan],
                                  p=[0.45, 0.45, 0.1]),
                "localization": rng.choice(loc_pool),
                **{c: int(rng.rand() < 0.2) for c in ARTIFACT_COLS},
            })
        csv_path = os.path.join(root, split, "metadata.csv")
        frame = pd.DataFrame(rows)
        frame.to_csv(csv_path, index=False)
        layout[split] = {"csv": csv_path, "img": img_dir, "seg": seg_dir}
        if split == "train":
            loc_pool = sorted(frame["localization"].unique())

    return {
        "csv": layout["train"]["csv"],
        "img": layout["train"]["img"],
        "seg": layout["train"]["seg"],
        "df": os.path.join(root, "train", "df.pkl"),
        "radiomics": os.path.join(root, "train", "radiomics.pkl"),
        "radiomics_red": os.path.join(root, "train", "radiomics_red.pkl"),
        "csv_test": layout["test"]["csv"],
        "img_test": layout["test"]["img"],
        "seg_test": layout["test"]["seg"],
        "df_test": os.path.join(root, "test", "df.pkl"),
        "radiomics_test": os.path.join(root, "test", "radiomics.pkl"),
        "radiomics_test_red": os.path.join(root, "test", "radiomics_red.pkl"),
    }
