"""Fusion classifier training and evaluation (the reference's
``net_utils.py`` + ``main.py`` workload).

Counterpart of ``multimodal_isic_tpu/train/fusion.py``: cross-entropy,
SGD(lr 1e-3, momentum 0, wd 1e-4) (``main.py:134-135``), the epoch loss as
the mean of batch losses (``net_utils.py:34``), the device-resident epochs
(``make_fusion_train_epoch``, ``make_fusion_eval_epoch``,
``padded_epoch_order``), the per-batch epoch and validation loops, and
``evaluate_test`` → (accuracy, classification_report digits=5)
(``net_utils.py:86-127``).

Several processes (JAX :250-315 and the data-parallel step XLA partitions
from the batch shardings): a rank holds its rows of each global batch.
``make_fusion_train_step(..., grid=)`` swaps in the global-batch BatchNorm
(``parallel.batchnorm``), draws dropout and drop-connect at the global
batch's shape and keeps the rank's rows (``core.rng.ShardedGenerator``),
and averages the gradients, the loss and the correct count over the data
group in one all-reduce, so each rank's SGD step is the one-process step on
the global batch.  ``validate_epoch(n_true=, group_size=)`` and
``evaluate_test(n_true=)`` gather the ranks' logits in global order and
trim the wrap-padded rows.

The module holds its weights and BatchNorm statistics, and
``torch.optim.SGD`` holds the optimizer state: together they are the JAX
``TrainState`` plus ``batch_stats``.  ``torch.optim.SGD`` at momentum 0
applies ``p -= lr·(g + wd·p)``, the update of the JAX ``sgd``
(``core/optim.py:72-98``).  The steps are eager, so there is no ``lax.scan``:
an epoch is a Python loop over device-resident batches whose losses and
correct counts stay on the device until one readback at its end.

Modes.  The train step runs the model in whatever mode it is in, which is
train mode unless a caller changed it: ``make_fusion_eval_step`` and
``make_fusion_eval_epoch`` put the model in eval mode for their call and
restore every submodule's mode after it, so validating between epochs does
not silently switch BatchNorm and dropout off for the rest of training.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import metrics as M
from ..data import augment as _aug
from ..models.efficientnet import BatchNorm
from ..models.fusion import MultiModalFusionNet
from ..models.maxvit import RelPosAttention
from ..parallel.distributed import process_count
from ..parallel.sharding import shard_generator
from ..utils import trace

BATCH_KEYS = ("image", "radiomics", "age", "sex", "loc", "artifacts")
_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]

Batch = Dict[str, torch.Tensor]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, targets.long())


def _inputs(batch: Batch) -> Batch:
    return {k: batch[k] for k in BATCH_KEYS if k in batch}


@contextlib.contextmanager
def eval_mode(model: nn.Module):
    """Eval mode for the body; every submodule's own mode restored after."""
    modes = [(m, m.training) for m in model.modules()]
    model.eval()
    try:
        yield model
    finally:
        for m, training in modes:
            m.training = training


# ------------------------------------------------------------------ set-up

@torch.no_grad()
def init_fusion(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter and BatchNorm statistic of ``model`` in
    place, from ``generator`` (on the model's device), with the JAX
    package's initializer families (flax defaults, ``init_fusion``):
    ``lecun_normal`` Dense and Conv kernels (normal truncated to ±2σ,
    σ = 1/sqrt(fan_in)/0.8796; fan_in of a depthwise kernel is K·K), zero
    biases, LayerNorm and BatchNorm scale 1 and bias 0, running mean 0 and
    variance 1, ``Embed`` normal with std 1/sqrt(features), and the
    weighted-fusion vector 1/M.  A MaxViT's relative-position tables (no
    JAX counterpart) are normal with std 0.02 truncated to ±2σ."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            std = 1.0 / math.sqrt(mod.weight[0].numel()) / _TRUNC
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, nn.Embedding):
            nn.init.normal_(mod.weight, 0.0, 1.0 / math.sqrt(mod.weight.shape[1]),
                            generator=generator)
        elif isinstance(mod, RelPosAttention):
            nn.init.trunc_normal_(mod.rel_bias, 0.0, 0.02, -0.04, 0.04,
                                  generator=generator)
    weights = getattr(model, "weights", None)
    if isinstance(weights, nn.Parameter):
        weights.fill_(1.0 / weights.numel())
    return model


def build_fusion(generator: torch.Generator, **model_kwargs) -> nn.Module:
    """A ``MultiModalFusionNet(**model_kwargs)`` built on the generator's
    device and initialised by :func:`init_fusion` from it.  The module is
    laid out on the meta device first, so neither host memory nor torch's
    global RNG is touched."""
    with torch.device("meta"):
        model = MultiModalFusionNet(**model_kwargs)
    model.to_empty(device=generator.device)
    return init_fusion(model, generator)


def fusion_optimizer(model: nn.Module, lr: float = 1e-3,
                     weight_decay: float = 1e-4) -> torch.optim.SGD:
    """The reference's optimizer: SGD without momentum (``main.py:135``)."""
    return torch.optim.SGD(model.parameters(), lr=lr, momentum=0.0,
                           weight_decay=weight_decay)


# -------------------------------------------------------------- train side

def make_fusion_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                           grid=None
                           ) -> Callable[[Batch, Optional[torch.Generator]],
                                         Tuple[torch.Tensor, torch.Tensor]]:
    """(batch, rng) → (loss, n_correct), both 0-d device tensors: forward
    in the model's mode (train mode: BatchNorm on batch statistics, which it
    moves into its running statistics; dropout and drop-connect drawn from
    ``rng``), backward, one optimizer step.

    With a ``parallel.sharding.Grid`` of more than one data rank, ``batch``
    is the rank's rows of the global batch: the model's BatchNorms become
    global-batch ones over the data group (in place), the draws are the
    global batch's (the rank's rows kept), and the gradients, the loss and
    the correct count are averaged over the group before the step (the
    loss is then the global batch's, the count its total).

    A call is one ``step`` span holding ``step.forward`` (the model, the
    loss and the count), ``step.backward`` and ``step.optimizer`` (the
    all-reduce, then the update); ``utils/trace.py``."""
    group = grid.data_group if grid is not None else None
    if group is not None:
        from ..parallel.batchnorm import convert
        convert(model, group)

    @trace.spanned("step")
    def step(batch: Batch, rng: Optional[torch.Generator] = None):
        with trace.span("step.forward"):
            logits = model(**_inputs(batch), rng=shard_generator(rng, grid))
            loss = cross_entropy(logits, batch["target"])
            correct = (logits.detach().argmax(dim=1) == batch["target"]).sum()
        with trace.span("step.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        loss = loss.detach()
        with trace.span("step.optimizer"):
            if group is not None:
                from ..parallel.sharding import all_reduce_grads_
                stats = torch.stack([loss, correct.to(loss.dtype)])
                all_reduce_grads_(model, group, [stats])
                loss, correct = stats[0], stats[1] * grid.n_data
            optimizer.step()
        return loss, correct

    return step


def make_fusion_train_epoch(model: nn.Module, optimizer: torch.optim.Optimizer,
                            transform: Optional[Callable] = None):
    """One training epoch over a device-resident dataset
    (``data.pipeline.DeviceDataset``): per step, gather the batch on the
    device → ``transform(images, masks, aug_rng)`` → the train step with
    ``drop_rng``.  The step's loss and correct count stay on the device;
    the epoch reads them back once.

    Returned callable::

        epoch(images, masks, meta, order, aug_rng, drop_rng)
          images   (N,H,W,C) uint8 device-resident staging crops
          masks    (N,H,W) or None
          meta     dict of (N,...) device columns incl. 'target'
          order    (n_steps, B) int gather indices (drop_last)
          aug_rng, drop_rng  torch.Generators on the device, consumed in
                   step order (a manual loop over the step with the same
                   generators is bit-identical)
          → (mean_loss, n_correct)
    """
    step = make_fusion_train_step(model, optimizer)

    def epoch(images, masks, meta, order, aug_rng, drop_rng):
        order = torch.as_tensor(np.asarray(order), dtype=torch.long,
                                device=images.device)
        losses, corrects = [], []
        for idx in order:
            batch = {k: v.index_select(0, idx) for k, v in meta.items()}
            img = images.index_select(0, idx)
            msk = masks.index_select(0, idx) if masks is not None else None
            if transform is not None:
                img, msk = transform(img, msk, aug_rng)
            batch["image"] = img
            loss, correct = step(batch, drop_rng)
            losses.append(loss)
            corrects.append(correct)
        return _read_back(losses, corrects)

    return epoch


def _read_back(losses, corrects) -> Tuple[float, int]:
    """(mean of the per-batch losses, total correct) of device scalars, in
    one device→host copy; (nan, 0) for no batches."""
    if not losses:
        return float("nan"), 0
    mean, total = torch.stack([torch.stack(losses).mean(),
                               torch.stack(corrects).sum().double()]).tolist()
    return mean, int(total)


def train_epoch(step_fn, model: nn.Module, loader: Iterable[Batch],
                rng_stream, logger=None, epoch: int = 0
                ) -> Tuple[float, float]:
    """One train epoch over a loader → (epoch_loss, epoch_acc); one dropout
    generator per batch from ``rng_stream``, one readback at the end.  In
    several processes the step is the data-parallel one over every rank
    (the CLIs run no tensor parallelism), whose loss and correct count are
    the global batch's, so the total counts every rank's rows."""
    losses, correct, total = [], [], 0
    for batch in loader:
        loss, ncorr = step_fn(batch, rng_stream.next())
        losses.append(loss)
        correct.append(ncorr)
        total += int(batch["target"].shape[0])
    epoch_loss, n_correct = _read_back(losses, correct)
    epoch_acc = n_correct / max(total * process_count(), 1)
    log_train_epoch(logger, model, epoch, epoch_loss, epoch_acc)
    return epoch_loss, epoch_acc


def log_train_epoch(logger, model: nn.Module, epoch: int, epoch_loss: float,
                    epoch_acc: float) -> None:
    """Per-epoch train logging (reference ``net_utils.py:34-43``): loss/acc
    plus the learnable fusion weights when present."""
    if logger is None:
        return
    logger.log("train/epoch_loss", epoch_loss, step=epoch)
    logger.log("train/epoch_acc", epoch_acc, step=epoch)
    weights = getattr(model, "weights", None)
    if isinstance(weights, nn.Parameter):  # fusion weights, net_utils.py:40-43
        for i, w in enumerate(weights.detach().cpu().tolist()):
            logger.log(f"model/fusion_weight_modality_{i}", w, step=epoch)
    logger.print(f"Epoch {epoch} - Train Loss: {epoch_loss:.4f}, "
                 f"Accuracy: {epoch_acc:.4f}")


# --------------------------------------------------------------- eval side

def make_fusion_eval_step(model: nn.Module
                          ) -> Callable[[Batch], Tuple[torch.Tensor,
                                                       torch.Tensor]]:
    """batch → (mean cross-entropy, logits), in eval mode without autograd;
    the model's modes are restored after each call."""

    @torch.inference_mode()
    def step(batch: Batch):
        with eval_mode(model):
            logits = model(**_inputs(batch))
        return cross_entropy(logits, batch["target"]), logits

    return step


def make_fusion_eval_epoch(model: nn.Module, out_hw=(380, 380)):
    """One validation epoch over a device-resident split: per step, gather
    → resize + normalize (``preprocess_eval_batch``) → eval forward →
    per-batch CE mean over the valid rows; one readback per epoch.  The
    statistic is ``validate_epoch``'s single-process one: the UNWEIGHTED
    mean of per-batch CE means, the final partial batch's mean over its
    valid rows only (``net_utils.py:34``).

    Returned callable::

        epoch(images, meta, order, valid)
          images (N,H,W,C) uint8   device-resident staging crops
          meta   dict of (N,...)   device columns incl. 'target'
          order  (n_steps, B) int  gather indices, final batch padded
          valid  (n_steps, B) bool False on padded slots
          → (epoch_loss, n_correct)
    """

    @torch.inference_mode()
    def epoch(images, meta, order, valid):
        dev = images.device
        order = torch.as_tensor(np.asarray(order), dtype=torch.long, device=dev)
        valid = torch.as_tensor(np.asarray(valid), dtype=torch.bool, device=dev)
        losses, corrects = [], []
        with eval_mode(model):
            for idx, vm in zip(order, valid):
                batch = {k: v.index_select(0, idx) for k, v in meta.items()}
                inputs = _inputs(batch)
                inputs["image"] = _aug.preprocess_eval_batch(
                    images.index_select(0, idx), out_hw)
                logits = model(**inputs)
                target = batch["target"].long()
                per = F.cross_entropy(logits, target, reduction="none")
                vmf = vm.to(per.dtype)
                losses.append((per * vmf).sum() / vmf.sum().clamp(min=1.0))
                corrects.append(((logits.argmax(dim=1) == target) & vm).sum())
        return _read_back(losses, corrects)

    return epoch


def padded_epoch_order(n: int, batch_size: int):
    """(order, valid) int32/bool [n_steps, batch_size] covering ALL n rows:
    the final partial batch is padded with row 0 and masked False — the
    eval-side counterpart of ``DeviceDataset.epoch_order``'s drop_last."""
    n_steps = -(-n // batch_size)
    order = np.zeros(n_steps * batch_size, np.int32)
    order[:n] = np.arange(n, dtype=np.int32)
    valid = np.zeros(n_steps * batch_size, bool)
    valid[:n] = True
    return (order.reshape(n_steps, batch_size),
            valid.reshape(n_steps, batch_size))


def validate_epoch(eval_fn, loader: Iterable[Batch], logger=None,
                   epoch: int = 0, n_true: Optional[int] = None,
                   group_size: Optional[int] = None) -> float:
    """Epoch val loss = mean of per-batch CE means (``net_utils.py:34``).

    ``n_true`` / ``group_size`` (JAX :250-290): a multi-process loader's
    order is wrap-padded to full global batches
    (``parallel.distributed.process_epoch_order(pad_to_full=True)``), and
    batch means over it would weight the duplicated rows twice.  So the
    logits of every rank are gathered in global order, trimmed to ``n_true`` and the per-sample
    losses (float64, on the host) regrouped into the ``group_size``
    batches, the last one partial, of the one-process loader: the statistic
    of the one-process run, up to the order of the float sums."""
    if n_true is not None:
        from ..parallel.distributed import gather_to_host

        logit_chunks, target_chunks = [], []
        for batch in loader:
            _, logits = eval_fn(batch)
            logit_chunks.append(gather_to_host(logits.float()))
            target_chunks.append(gather_to_host(batch["target"]))
        logits = np.concatenate(logit_chunks)[:n_true].astype(np.float64)
        targets = np.concatenate(target_chunks)[:n_true].astype(np.int64)
        shifted = logits - logits.max(axis=1, keepdims=True)
        logp = shifted - np.log(np.exp(shifted).sum(axis=1, keepdims=True))
        per_sample = -logp[np.arange(n_true), targets]
        g = group_size or n_true
        batch_means = [per_sample[k:k + g].mean() for k in range(0, n_true, g)]
        epoch_loss = float(np.mean(batch_means)) if batch_means else float("nan")
        n_correct = int(np.sum(np.argmax(logits, axis=1) == targets))
        total = n_true
    else:
        losses, correct, total = [], [], 0
        for batch in loader:
            loss, logits = eval_fn(batch)
            losses.append(loss)
            correct.append((logits.argmax(dim=1) == batch["target"]).sum())
            total += int(batch["target"].shape[0])
        epoch_loss, n_correct = _read_back(losses, correct)
    if logger is not None:
        logger.log("val/epoch_loss", epoch_loss, step=epoch)
        logger.log("val/epoch_acc", n_correct / max(total, 1), step=epoch)
        logger.print(f"Epoch {epoch} - Val Loss: {epoch_loss:.4f}, "
                     f"Accuracy: {n_correct / max(total, 1):.4f}")
    return epoch_loss


def evaluate_test(eval_fn, loader: Iterable[Batch], logger=None,
                  num_classes: int = 7, n_true: Optional[int] = None
                  ) -> Tuple[float, str]:
    """→ (accuracy, classification_report).  ``logger`` (optional) receives
    ``assign(key, value)`` for accuracy, balanced accuracy and the report,
    and ``print(text)``.  The predictions and targets of every rank (this
    process's alone without a group) are gathered in global order (JAX
    :300-315), and ``n_true`` trims the wrap-padded trailing rows."""
    from ..parallel.distributed import gather_to_host

    preds, targets = [], []
    for batch in loader:
        _, logits = eval_fn(batch)
        preds.append(gather_to_host(logits.argmax(dim=1)))
        targets.append(gather_to_host(batch["target"]))
    y_pred = np.concatenate(preds)[:n_true]
    y_true = np.concatenate(targets)[:n_true]
    acc = float(np.mean(y_pred == y_true))
    bacc = M.balanced_accuracy(y_true, y_pred, num_classes)
    report = M.classification_report(y_true, y_pred, digits=5)
    if logger is not None:
        logger.assign("test/accuracy", acc)
        logger.assign("test/balanced_accuracy", bacc)
        logger.assign("test/classification_report", report)
        logger.print(f"Test Accuracy: {acc:.4f}")
        logger.print("Classification Report:\n" + report)
    return acc, report
