"""Latent statistics over the patch axis.

Counterpart of ``multimodal_isic_tpu/analysis/latents.py``: the reference's
per-image latent summary (``utils.py:16-31``).
"""

from __future__ import annotations

import torch


def concat_patch_moments(latent: torch.Tensor, eps: float = 1e-6,
                         unbiased: bool = False) -> torch.Tensor:
    """(B, N, D) → (B, 6·D): [mean | max | std | median | skew | kurtosis]
    over the patch axis; std biased unless ``unbiased``; the median is the
    lower middle element for even N, as ``torch.median`` gives it."""
    mean = latent.mean(dim=1)
    maxv = latent.amax(dim=1)
    std = latent.std(dim=1, correction=1 if unbiased else 0)
    median = latent.median(dim=1).values
    centered = latent - mean[:, None, :]
    m3 = (centered ** 3).mean(dim=1)
    m4 = (centered ** 4).mean(dim=1)
    sigma = std.clamp_min(eps)
    skew = m3 / sigma ** 3
    kurtosis = m4 / sigma ** 4 - 3.0
    return torch.cat([mean, maxv, std, median, skew, kurtosis], dim=1)
