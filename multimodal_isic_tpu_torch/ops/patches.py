"""Patchify / unpatchify and the patch ↔ lesion-mask overlap.

Counterpart of ``multimodal_isic_tpu/ops/patches.py`` (:17-43): images are
NHWC, and each flattened patch keeps the (p, p, c) ordering of the torch
MAE implementation, so reconstructions and losses compare directly.
"""

from __future__ import annotations

import torch


def patchify(imgs: torch.Tensor, patch: int = 16) -> torch.Tensor:
    """[B, H, W, C] → [B, (H/p)*(W/p), p*p*C]."""
    b, h, w, c = imgs.shape
    gh, gw = h // patch, w // patch
    x = imgs.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def unpatchify(x: torch.Tensor, patch: int = 16, channels: int = 3
               ) -> torch.Tensor:
    """[B, N, p*p*C] → [B, H, W, C] (square grid)."""
    b, n, _ = x.shape
    g = int(round(n ** 0.5))
    x = x.reshape(b, g, g, patch, patch, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, g * patch, g * patch, channels)


def patch_overlap_mask(mask: torch.Tensor, patch: int = 16) -> torch.Tensor:
    """[B, H, W] binary lesion mask → [B, (H/p)*(W/p)] bool: does each patch
    hold any nonzero pixel (the reference's unfold-sum > 0,
    ``save_latent.py:80-86``)."""
    b, h, w = mask.shape
    gh, gw = h // patch, w // patch
    sums = mask.reshape(b, gh, patch, gw, patch).float().sum(dim=(2, 4))
    return (sums > 0).reshape(b, gh * gw)
