"""ConvMAE pretraining: the optimizer, the train and eval steps, the
device-resident epochs and the epoch loop; the forward steps of latent
extraction and validation.

Counterpart of ``multimodal_isic_tpu/train/mae.py``: AdamW with the
reference's encoder/decoder learning-rate split (enc 1e-5, dec 1e-3, betas
(0.9, 0.95), weight decay 0.05, ``train_ae.py:145-152``), train at
``masking_ratio`` with optional lesion-guided masking, validate at
``eval_masking_ratio``, keep the best-validation weights and checkpoint them
(model + optimizer + step + RNG) at each new best.

The module holds its weights and ``torch.optim.AdamW`` its moments: together
they are the JAX ``TrainState``.  ``torch.optim.AdamW`` applies
``p ← p·(1 − lr·wd) − lr·m̂/(√v̂ + eps)``, the update of the JAX ``adamw``
(``core/optim.py:101-131``) with its decay on the old weights.  Steps are
eager, so there is no ``lax.scan``: an epoch is a Python loop over
device-resident batches whose losses stay on the device until one readback
at its end.  Masking draws come from a ``torch.Generator`` or are given as
``(ids_keep, mask, ids_restore)``, so a step can be repeated on the same
draws.  Every forward step runs under ``torch.inference_mode()`` with the
model in eval mode (ConvMAE has no dropout or batch statistics, so the mode
changes nothing but is restored all the same).

:func:`train_mae` runs an epoch either device-resident (``fused_train`` /
``fused_val``) or over loaders of batches on the card (``train_batches`` /
``val_batches``, JAX :188-288), and calls ``epoch_hook`` after each epoch
(``cli/train_ae.py``'s diagnostics).

Several processes: ``make_mae_train_step(..., grid=)`` draws the masks of
the global batch and keeps the rank's rows (``core.rng.ShardedGenerator``;
every sample masks the same patch count, so the mean of the ranks' losses
is the global batch's) and averages the gradients and the loss over the
data group before the step; ``train_mae(val_n_true=)`` gathers the
per-sample validation losses in global order and trims the wrap-padded
rows (JAX :261-270).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core import checkpoint as ckpt
from ..parallel.sharding import shard_generator
# init_mae(model, generator): the parameters initialised in place with the
# JAX initialisers' distributions
from ..models.convmae import ConvMAE, Masking
from ..models.convmae import init_convmae as init_mae  # noqa: F401
from ..utils import trace
from .fusion import eval_mode


def mae_optimizer(model: ConvMAE, encoder_lr: float = 1e-5,
                  decoder_lr: float = 1e-3,
                  weight_decay: float = 0.05) -> torch.optim.AdamW:
    """AdamW in two parameter groups split on "decoder" in the parameter
    name, as the reference splits (``train_ae.py:145-146``): ``mask_token``
    has no "decoder" in its name and trains at the encoder rate there and
    here.  Every parameter is decayed, as in the JAX ``adamw``."""
    groups = {"encoder": [], "decoder": []}
    for name, p in model.named_parameters():
        groups["decoder" if "decoder" in name else "encoder"].append(p)
    lrs = {"encoder": encoder_lr, "decoder": decoder_lr}
    return torch.optim.AdamW(
        [{"params": ps, "lr": lrs[k], "name": k} for k, ps in groups.items()
         if ps],
        betas=(0.9, 0.95), eps=1e-8, weight_decay=weight_decay)


def optimizer_step_count(optimizer: torch.optim.Optimizer) -> int:
    """Optimizer steps taken (AdamW's per-parameter ``step``; 0 before the
    first)."""
    steps = [int(s["step"]) for s in optimizer.state.values() if "step" in s]
    return max(steps, default=0)


# -------------------------------------------------------------- train side

def make_mae_train_step(model: ConvMAE, optimizer: torch.optim.Optimizer,
                        mask_ratio: float, use_lesion_mask: bool = False,
                        grid=None) -> Callable:
    """→ ``step(images, lesion_mask=None, generator=None, masking=None)`` →
    the loss, a detached 0-d device tensor: the masked forward in the
    model's mode, backward, one optimizer step.  The lesion mask guides the
    masking only when ``use_lesion_mask`` is set.  With a
    ``parallel.sharding.Grid`` of more than one data rank ``images`` are
    the rank's rows of the global batch (module docstring).  A call is one
    ``step`` span holding ``step.forward``, ``step.backward`` and
    ``step.optimizer`` (``utils/trace.py``)."""
    group = grid.data_group if grid is not None else None

    @trace.spanned("step")
    def step(images: torch.Tensor, lesion_mask: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             masking: Optional[Masking] = None) -> torch.Tensor:
        with trace.span("step.forward"):
            loss, _, _ = model(images, mask_ratio,
                               shard_generator(generator, grid),
                               lesion_mask if use_lesion_mask else None,
                               masking)
        with trace.span("step.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        loss = loss.detach()
        with trace.span("step.optimizer"):
            if group is not None:
                from ..parallel.sharding import all_reduce_grads_
                loss = loss.reshape(1)
                all_reduce_grads_(model, group, [loss])
                loss = loss[0]
            optimizer.step()
        return loss

    return step


def _mean(losses) -> float:
    """The mean of device scalars in one device→host copy; nan for none."""
    return float(torch.stack(losses).mean()) if losses else float("nan")


def make_mae_train_epoch(model: ConvMAE, optimizer: torch.optim.Optimizer,
                         mask_ratio: float, use_lesion_mask: bool = False,
                         transform: Optional[Callable] = None) -> Callable:
    """One training epoch over a device-resident dataset
    (``data.pipeline.DeviceDataset``): per step, gather the batch on the
    device → ``transform(images, masks, aug_rng)`` → the train step with
    masking drawn from ``mask_rng``.  The losses stay on the device; the
    epoch reads their mean back once.

    Returned callable::

        epoch(images, masks, order, aug_rng, mask_rng) → mean loss
          images   (N,H,W,C) uint8 device-resident staging crops
          masks    (N,H,W) or None
          order    (n_steps, B) int gather indices (host-resampled)
          aug_rng, mask_rng  torch.Generators on the device, consumed in
                   step order (a manual loop over the step with the same
                   generators is bit-identical)
    """
    step = make_mae_train_step(model, optimizer, mask_ratio, use_lesion_mask)

    def epoch(images, masks, order, aug_rng, mask_rng) -> float:
        order = torch.as_tensor(np.asarray(order), dtype=torch.long,
                                device=images.device)
        losses = []
        for idx in order:
            img = images.index_select(0, idx)
            msk = masks.index_select(0, idx) if masks is not None else None
            if transform is not None:
                img, msk = transform(img, msk, aug_rng)
            losses.append(step(img, msk, mask_rng))
        return _mean(losses)

    return epoch


# --------------------------------------------------------------- eval side

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


def make_mae_eval_epoch(model: ConvMAE, eval_mask_ratio: float,
                        transform: Optional[Callable] = None) -> Callable:
    """Validation twin of :func:`make_mae_train_epoch`: per step, gather →
    the deterministic eval policy ``transform(images, masks)`` → the masked
    eval loss, masking drawn from ``generator``.  Returns
    ``epoch(images, masks, order, generator) → mean loss`` (one readback);
    the same generator seed gives the same draws."""
    step = make_mae_eval_step(model, eval_mask_ratio)

    def epoch(images, masks, order, generator) -> float:
        order = torch.as_tensor(np.asarray(order), dtype=torch.long,
                                device=images.device)
        losses = []
        for idx in order:
            img = images.index_select(0, idx)
            if transform is not None:
                msk = masks.index_select(0, idx) if masks is not None else None
                img, _ = transform(img, msk)
            losses.append(step(img, generator))
        return _mean(losses)

    return epoch


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


# -------------------------------------------------------------- the loop

def _weighted_mean(losses, sizes) -> float:
    """Σ lossᵢ·nᵢ / Σ nᵢ in float64 on the host, as the JAX loop sums
    ``float(loss) * n``, from one device→host copy; nan for none."""
    if not losses:
        return float("nan")
    values = torch.stack(losses).tolist()
    return sum(v * n for v, n in zip(values, sizes)) / sum(sizes)


def train_mae(model: ConvMAE, optimizer: torch.optim.Optimizer,
              fused_train: Optional[Callable] = None,
              fused_val: Optional[Callable] = None, num_epochs: int = 1,
              rng=None, logger=None, checkpoint_dir: Optional[str] = None,
              *, train_batches: Optional[Callable] = None,
              val_batches: Optional[Callable] = None,
              mask_ratio: float = 0.75, eval_mask_ratio: float = 0.75,
              use_lesion_mask: bool = False,
              epoch_hook: Optional[Callable] = None, grid=None,
              val_n_true: Optional[int] = None) -> Dict:
    """The epoch loop (``train_ae.py:163-216``; JAX :188-288).  ``rng`` is a
    ``core.rng.RngPool``; each epoch takes one generator of its ``mask``
    stream for the train masking and one of its ``eval`` stream for the
    validation masking, each consumed in step order.

    Train side, one of:
    - ``fused_train(epoch, aug_rng, mask_rng) → loss`` (device-resident,
      :func:`make_mae_train_epoch` bound to staged arrays and stepping
      ``optimizer``; ``aug_rng`` from the ``augment`` stream);
    - ``train_batches(epoch)``: an iterable of batches on the card ('image',
      and 'mask' for lesion-guided masking) for a train step at
      ``mask_ratio`` (the loader draws its own augmentation).
    Validation side, one of ``fused_val(generator) → loss`` or
    ``val_batches()`` for an eval step at ``eval_mask_ratio``.  A loader's
    epoch loss is the batch losses' mean weighted by batch size.

    Several processes (``grid``): the loaders give the rank's rows of each
    global batch, the train step is the data-parallel one, and with
    ``val_n_true`` (the validation loader's order wrap-padded to full
    global batches) the per-sample losses of every rank are gathered in
    global order and their first ``val_n_true`` averaged.

    At each new best validation loss the weights are copied (the live
    ``state_dict`` aliases the parameters that later steps change) and,
    with ``checkpoint_dir``, model + optimizer + step + RNG are saved.
    ``epoch_hook(epoch, model)`` runs after each epoch.
    → {model, optimizer, best_state, best_val_loss, history, checkpoint}."""
    if (fused_train is None) == (train_batches is None) or \
            (fused_val is None) == (val_batches is None):
        raise ValueError("give one of fused_train / train_batches and one "
                         "of fused_val / val_batches")
    train_step = (make_mae_train_step(model, optimizer, mask_ratio,
                                      use_lesion_mask, grid)
                  if fused_train is None else None)
    eval_step = (make_mae_eval_step(model, eval_mask_ratio)
                 if fused_val is None and val_n_true is None else None)
    persample = (make_mae_eval_persample_step(model, eval_mask_ratio)
                 if val_n_true is not None else None)
    best_val, best_state, path = float("inf"), None, None
    history = []
    for epoch in range(num_epochs):
        if fused_train is not None:
            train_loss = float(fused_train(epoch, rng["augment"].next(),
                                           rng["mask"].next()))
        else:
            gen = rng["mask"].next()
            losses, sizes = [], []
            for batch in train_batches(epoch):
                losses.append(train_step(batch["image"], batch.get("mask"),
                                         gen))
                sizes.append(batch["image"].shape[0])
            train_loss = _weighted_mean(losses, sizes)
        if fused_val is not None:
            val_loss = float(fused_val(rng["eval"].next()))
        elif val_n_true is not None:
            from ..parallel.distributed import gather_to_host
            gen = shard_generator(rng["eval"].next(), grid)
            group = grid.data_group if grid is not None else None
            per_sample = np.concatenate([
                gather_to_host(persample(batch["image"], gen), group)
                for batch in val_batches()])[:val_n_true]
            val_loss = (float(per_sample.astype(np.float64).mean())
                        if len(per_sample) else float("nan"))
        else:
            gen = rng["eval"].next()
            losses, sizes = [], []
            for batch in val_batches():
                losses.append(eval_step(batch["image"], gen))
                sizes.append(batch["image"].shape[0])
            val_loss = _weighted_mean(losses, sizes)
        history.append({"epoch": epoch, "train_loss": train_loss,
                        "val_loss": val_loss})
        if logger is not None:
            logger.log("train/loss", train_loss, step=epoch)
            logger.log("val/loss", val_loss, step=epoch)
            logger.print(f"Epoch [{epoch + 1}/{num_epochs}], Train Loss: "
                         f"{train_loss:.4f}, Val Loss: {val_loss:.4f}")
        if val_loss < best_val:
            best_val = val_loss
            best_state = {k: v.detach().clone()
                          for k, v in model.state_dict().items()}
            if checkpoint_dir is not None:
                path = ckpt.save_train_state(
                    checkpoint_dir, model, optimizer,
                    optimizer_step_count(optimizer), rng_pool=rng,
                    metadata={"epoch": epoch, "val_loss": val_loss})
        if epoch_hook is not None:
            epoch_hook(epoch, model)
    return {"model": model, "optimizer": optimizer, "best_state": best_state,
            "best_val_loss": best_val, "history": history, "checkpoint": path}
