"""ConvMAE forward steps: latent extraction and the masked validation pass.

Counterpart of ``multimodal_isic_tpu/train/mae.py`` (:46-49 ``init_mae``,
:133-185 the eval and encoder steps).  The module holds its weights, so a
step is a closure over the model where the JAX step takes ``params``; each
runs under ``torch.inference_mode()`` with the model in eval mode (ConvMAE
has no dropout or batch statistics, so the mode changes nothing but is
restored all the same).  Masking draws come from a ``torch.Generator`` or
are given as ``(ids_keep, mask, ids_restore)``, so a validation pass can be
repeated on the same draws.  Training (AdamW with the encoder/decoder
learning-rate split, the epochs) comes with the backward kernels.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# init_mae(model, generator): the parameters initialised in place with the
# JAX initialisers' distributions
from ..models.convmae import ConvMAE, Masking
from ..models.convmae import init_convmae as init_mae  # noqa: F401
from .fusion import eval_mode


def make_mae_eval_step(model: ConvMAE, eval_mask_ratio: float) -> Callable:
    """→ ``step(images, generator=None, masking=None)`` → scalar loss."""

    def step(images: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             masking: Optional[Masking] = None) -> torch.Tensor:
        with torch.inference_mode(), eval_mode(model):
            loss, _, _ = model(images, eval_mask_ratio, generator,
                               masking=masking)
        return loss

    return step


def make_mae_eval_persample_step(model: ConvMAE,
                                 eval_mask_ratio: float) -> Callable:
    """→ ``step(images, generator=None, masking=None)`` → per-sample losses
    [B]: the same reconstruction loss reduced per sample.  A fixed mask
    ratio masks the same patch count in every sample, so the scalar batch
    loss is the mean of this vector (multi-process validation trims padded
    rows from it before averaging)."""

    def step(images: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             masking: Optional[Masking] = None) -> torch.Tensor:
        with torch.inference_mode(), eval_mode(model):
            _, pred, mask = model(images, eval_mask_ratio, generator,
                                  masking=masking)
            per_patch = model.per_patch_loss(images, pred)
            return ((per_patch * mask).sum(dim=1)
                    / mask.sum(dim=1).clamp_min(1.0))

    return step


def make_encoder_step(model: ConvMAE) -> Callable:
    """→ ``step(images)`` → (latent [B, 196, D] float32, ids_restore): the
    mask-ratio-0 encoder forward of latent extraction
    (``save_latent.py:60``)."""

    def step(images: torch.Tensor):
        with torch.inference_mode(), eval_mode(model):
            latent, _, ids_restore = model.encode(images, 0.0)
        return latent, ids_restore

    return step
