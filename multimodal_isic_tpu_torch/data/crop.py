"""Mask-centroid square cropping (numpy).

Counterpart of ``multimodal_isic_tpu/data/crop.py:20-56``: a ``min(H, W)``
square centred on the lesion-mask centroid, clamped to the image
(reference ``dataset.py:58-98``).  A mask of another size than the image is
rejected here; resizing it needs cv2, which comes with the host-data port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def centroid_crop_bounds(mask: np.ndarray, crop_size: int) -> Tuple[int, int]:
    """(y1, x1) of the crop window per the reference's clamping rules."""
    h, w = mask.shape[:2]
    ys, xs = np.where(mask > 0)
    if len(xs) == 0 or len(ys) == 0:
        cx, cy = w // 2, h // 2
    else:
        cx = int(np.mean(xs))
        cy = int(np.mean(ys))
    half = crop_size // 2
    x1 = max(cx - half, 0)
    y1 = max(cy - half, 0)
    x1 = min(x1, w - crop_size)
    y1 = min(y1, h - crop_size)
    return y1, x1


def centroid_crop(image: np.ndarray, mask: Optional[np.ndarray],
                  crop_size: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Crop image+mask to a square centred on the mask centroid.
    ``crop_size=None`` is the reference's ``min(H, W)``; a missing mask is an
    all-zero mask (centre crop)."""
    h, w = image.shape[:2]
    if mask is None:
        mask = np.zeros((h, w), dtype=np.uint8)
    elif mask.shape[:2] != (h, w):
        raise ValueError(f"mask {mask.shape[:2]} does not match image {(h, w)}")
    if crop_size is None:
        crop_size = min(h, w)
    y1, x1 = centroid_crop_bounds(mask, crop_size)
    return (image[y1:y1 + crop_size, x1:x1 + crop_size],
            mask[y1:y1 + crop_size, x1:x1 + crop_size])
