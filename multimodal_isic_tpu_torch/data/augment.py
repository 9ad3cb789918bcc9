"""Eval/serving preprocessing on the device: bilinear resize + ImageNet
normalize.

Counterpart of ``multimodal_isic_tpu/data/augment.py:22-116``.  The resize is
the same separable half-pixel-centre bilinear (cv2.INTER_LINEAR, no
antialias) written as two dense banded matmuls, ``A_h @ X @ A_wᵀ``, which
cuBLAS runs on the tensor cores in bf16 for the serving path.  The
train-time augmentations come with the training port.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=32)
def _bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense [n_out, n_in] float32 matrix of the half-pixel-centre 2-tap
    bilinear weights (edge-clamped), so ``W @ x`` is the 1-D resize.  The
    cached array is read-only."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    # clamp the raw tap indices independently: for src < 0 both taps land on
    # pixel 0 with total weight 1 (cv2's edge-replicate rule)
    lo_raw = np.floor(src).astype(np.int64)
    lo = np.clip(lo_raw, 0, n_in - 1)
    hi = np.clip(lo_raw + 1, 0, n_in - 1)
    frac = src - lo_raw
    w = np.zeros((n_out, n_in), np.float64)
    w[np.arange(n_out), lo] += 1.0 - frac
    w[np.arange(n_out), hi] += frac
    out = np.asarray(w, np.float32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=32)
def _resize_weights(n_in: int, n_out: int, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """:func:`_bilinear_matrix` on ``device``, uploaded once per shape (a
    host→device copy per batch would stall the serving stream)."""
    return torch.tensor(_bilinear_matrix(n_in, n_out), dtype=dtype,
                        device=device)


def resize_bilinear_mxu(imgs: torch.Tensor, out_hw: Tuple[int, int],
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched bilinear resize as two matmuls.

    imgs [B, H, W, C] (any real dtype, uint8 included) → [B, h, w, C] in
    ``dtype``.  float32 runs in full float32 (no TF32: cuBLAS's default);
    bfloat16 rounds like the JAX serving path's bf16 matmuls.
    """
    h_out, w_out = out_hw
    _, h_in, w_in, _ = imgs.shape
    wh = _resize_weights(h_in, h_out, dtype, imgs.device)
    ww = _resize_weights(w_in, w_out, dtype, imgs.device)
    x = imgs.to(dtype)
    t = torch.einsum("oh,bhwc->bowc", wh, x)       # contract H
    return torch.einsum("ow,bhwc->bhoc", ww, t)    # contract W


def normalize_imagenet(img: torch.Tensor,
                       mean: Tuple[float, ...] = IMAGENET_MEAN,
                       std: Tuple[float, ...] = IMAGENET_STD) -> torch.Tensor:
    """albumentations.Normalize: (img - 255*mean) / (255*std), in img.dtype."""
    m = torch.tensor(mean, dtype=img.dtype, device=img.device) * 255.0
    s = torch.tensor(std, dtype=img.dtype, device=img.device) * 255.0
    return (img - m) / s


def preprocess_eval_batch(imgs_u8: torch.Tensor, out_hw: Tuple[int, int],
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 batch [B, H, W, 3] → resize → ImageNet normalize, in ``dtype``,
    contiguous NHWC (the reference's deterministic eval transform,
    ``main.py:88-94``)."""
    return normalize_imagenet(resize_bilinear_mxu(imgs_u8, out_hw, dtype)
                              ).contiguous()
