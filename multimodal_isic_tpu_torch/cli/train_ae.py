"""CLI: ConvMAE pretraining (reference ``train_ae.py``; JAX
``cli/train_ae.py``).

    python -m multimodal_isic_tpu_torch.cli.train_ae --config_path config.yml

Counterpart of the JAX CLI's single-process branch (:1-249): manifests (and
the optional ISIC2019 merge) → ``StratifiedKFold(10)`` fold select →
``weighted_sample_indices`` each epoch → the ``mae_train`` loader (drop
last) and the ``mae_eval`` loader at 64 → the tiny or ConvViT-Base model,
initialised from ``pretrained_ckpt`` where one is given → AdamW with the
encoder/decoder rate split → ``train_mae`` at ``masking_ratio`` (optionally
lesion-guided), validated at ``eval_masking_ratio``, the resumable train
state under ``model_path/mae_ckpt`` → the best weights under a fresh uuid4
hex directory.  Every 10 epochs and at the last: the latent patch moments
(``latent_moments_ep{N}.npz``), their scatter and four reconstruction grids
in the run's artifacts.

- ``device_cache`` stages both splits on the card and runs device-resident
  epochs; the partial last validation batch is evaluated outside the epoch.
- Kernel flags: ``use_fused_mlp`` is on where the device is ``cuda`` (the
  JAX CLI turns it on where the backend is ``tpu``) and the dims allow it;
  ``use_flash_attention`` and ``remat_blocks`` come from the config; the
  fused front stays off, as the JAX CLIs leave it.
- Several processes (``ISIC_*``, ``cli.common.setup_processes``; JAX
  :39-42,73-86,114,144,178,220,235): every rank loads its rows of each
  global batch of ``batch_size`` from the same weighted order (no
  ``device_cache``), the train step is the data-parallel one (the masks
  and augmentations of the global batch, gradients averaged over the
  ranks), the validation loader wrap-pads to full global batches of 64 and
  its per-sample losses are gathered and trimmed (``val_n_true``); rank 0
  alone logs, keeps ``mae_ckpt/``, runs the diagnostics hook on its own
  (a loader of the whole validation split, no collective) and saves the
  best weights.

``main`` returns the run's results: the best checkpoint's path, the run
directory, the history and the best validation loss.
"""

from __future__ import annotations

import os
import uuid
from typing import Any, Dict

import numpy as np
import torch

from ..analysis.latents import concat_patch_moments
from ..core import checkpoint as ckpt
from ..core.rng import RngPool, generator
from ..core.splits import StratifiedKFold, weighted_sample_indices
from ..data import augment
from ..data.pipeline import DermRecords, DeviceDataset, DeviceLoader
from ..models.convmae import ConvMAE, build_convmae, load_pretrained
from ..parallel import distributed as dist
from ..parallel.sharding import replicate_, shard_transform
from ..train.fusion import eval_mode
from ..train.mae import (make_encoder_step, make_mae_eval_epoch,
                         make_mae_eval_step, make_mae_train_epoch,
                         mae_optimizer, train_mae)
from ..utils.logging import RunLogger
from .common import parse_config, setup_processes

VAL_BS = 64  # validation and diagnostics batch (JAX cli/train_ae.py:81-89)
HOOK_EVERY = 10  # epochs between diagnostics (train_ae.py:176)
TINY = dict(embed_dims=(32, 48, 64), depths=(1, 1, 2), num_heads=4,
            decoder_dim=32, decoder_depth=1, decoder_heads=4)


def model_config(params_cfg, device: torch.device) -> Dict[str, Any]:
    """The ``ConvMAE`` keyword arguments of the config's model (JAX
    :97-113): the tiny test model or ConvViT-Base."""
    cfg = dict(norm_pix_loss=params_cfg["norm_pix_loss"],
               use_flash_attention=bool(params_cfg.get("use_flash_attention",
                                                       False)),
               remat_blocks=bool(params_cfg.get("remat_blocks", False)))
    if params_cfg.get("model_size", "base") == "tiny":
        return {**TINY, **cfg}
    return {**cfg, "use_fused_mlp": (bool(params_cfg.get("use_fused_mlp",
                                                         True))
                                     and device.type == "cuda")}


def init_pretrained(model: ConvMAE, pretrained: str) -> None:
    """``pretrained_ckpt`` with ``strict=False`` semantics (the reference
    loads the upstream ConvMAE ``checkpoint.pth`` so, ``train_ae.py:
    136-141``): a ``.pth``/``.pt`` file through :func:`load_pretrained`, a
    checkpoint directory (the port's or the JAX package's) through
    ``restore_partial``."""
    if pretrained.endswith((".pth", ".pt")):
        blob = torch.load(pretrained, map_location="cpu", weights_only=False)
        if isinstance(blob, dict) and isinstance(blob.get("model"), dict):
            blob = blob["model"]  # upstream wraps the state dict
        load_pretrained(model, blob)
        print(f"Initialized from torch checkpoint {pretrained}")
    else:
        model.load_state_dict(ckpt.restore_partial(pretrained,
                                                   model.state_dict()))
        print(f"Initialized from checkpoint {pretrained}")


def main(argv=None) -> Dict[str, Any]:
    config = parse_config(argv)
    _, grid, device = setup_processes(config)
    # one run record a job, not a process: the other ranks stay silent
    logger = (RunLogger(config.get("log_dir", "runs"), config=config.to_dict())
              if dist.is_coordinator() else None)
    try:
        return _run(config, device, logger, grid)
    finally:
        if logger is not None:
            logger.close()


def _run(config, device: torch.device, logger, grid=None) -> Dict[str, Any]:
    import pandas as pd  # local: host-only dependency

    params_cfg = config["training_plan"]["parameters"]
    seed = config["seed"]
    pool = RngPool(seed, device)

    df_train_val = pd.read_pickle(config["dir"]["df"])
    df_test = pd.read_pickle(config["dir"]["df_test"])
    if config["dir"].get("isic2019_csv"):  # optional extra pretraining data
        from ..data.manifest import merge_isic2019
        df_train_val = merge_isic2019(
            df_train_val, df_test,
            pd.read_csv(config["dir"]["isic2019_csv"]),
            pd.read_csv(config["dir"]["isic2019_gt"]),
            config["dir"]["isic2019_img"])

    kf = StratifiedKFold(n_splits=10, shuffle=True, random_state=seed)
    folds = list(kf.split(df_train_val, df_train_val["dx"]))
    train_idx, val_idx = folds[params_cfg["fold"]]
    df_train = df_train_val.iloc[train_idx]
    labels = df_train["dx"].values.astype(int)
    train_records = DermRecords(df_train)
    val_records = DermRecords(df_train_val.iloc[val_idx])
    batch_size = params_cfg["batch_size"]
    sampler_rng = np.random.RandomState(seed)
    mask_ratio = params_cfg["masking_ratio"]
    eval_ratio = params_cfg["eval_masking_ratio"]
    lesion = params_cfg["include_lesion_mask"]
    print(f"decoder: {'native' if train_records.use_native else 'cv2'}")

    train_tf = shard_transform(augment.POLICIES["mae_train"], grid)

    def train_batches(epoch):
        order = weighted_sample_indices(labels, None, sampler_rng)
        bs = batch_size
        if grid is not None:  # one weighted order; each rank its rows
            order, bs, _ = dist.process_epoch_order(order, batch_size)
        return DeviceLoader(train_records, bs, order=order,
                            transform=train_tf, rng_stream=pool["augment"],
                            drop_last=True, device=device)

    def val_batches():
        """The whole validation split at ``VAL_BS`` (one process; the
        hook's loader on rank 0)."""
        return DeviceLoader(val_records, VAL_BS,
                            transform=augment.POLICIES["mae_eval"],
                            device=device)

    def rank_val_batches():
        """A rank's rows of the validation split wrap-padded to full
        global batches of ``VAL_BS``."""
        order, bs, _ = dist.process_epoch_order(
            np.arange(len(val_records)), VAL_BS, pad_to_full=True)
        return DeviceLoader(val_records, bs, order=order,
                            transform=augment.POLICIES["mae_eval"],
                            device=device)

    model = build_convmae(pool["init"].next(),
                          **model_config(params_cfg, device))
    if params_cfg.get("pretrained_ckpt", ""):
        init_pretrained(model, params_cfg["pretrained_ckpt"])
    replicate_(model)  # every rank starts from rank 0's weights
    model.train()
    optimizer = mae_optimizer(model)
    encoder_step = make_encoder_step(model)
    epochs = params_cfg["epochs"]

    def epoch_hook(epoch, model):
        if epoch % HOOK_EVERY and epoch != epochs - 1:
            return
        from ..utils.viz import latent_scatter, reconstruction_grid
        feats, targets = [], []
        for batch in val_batches():
            latent, _ = encoder_step(batch["image"])
            feats.append(concat_patch_moments(latent).cpu().numpy())
            targets.append(batch["target"].cpu().numpy())
        feats, targets = np.concatenate(feats), np.concatenate(targets)
        np.savez(logger.artifact_path(f"latent_moments_ep{epoch}.npz"),
                 feats=feats, targets=targets)
        latent_scatter(feats, targets,
                       logger.artifact_path(f"latent_scatter_ep{epoch}.png"),
                       title=f"MomentsConcat scatter (epoch {epoch})",
                       seed=seed)
        # reconstruction grids of 4 validation samples (utils.py:94-148)
        batch = next(iter(val_batches()))
        for i in range(min(4, batch["image"].shape[0])):
            img = batch["image"][i:i + 1]
            with torch.inference_mode(), eval_mode(model):
                _, pred, msk = model(img, mask_ratio,
                                     generator(epoch, device))
            reconstruction_grid(
                img[0].cpu().numpy(), pred[0].cpu().numpy(),
                msk[0].cpu().numpy(),
                logger.artifact_path(f"image_comparison_{i + 1}_ep{epoch}"
                                     ".png"),
                norm_pix_loss=params_cfg["norm_pix_loss"])

    loops: Dict[str, Any] = {"train_batches": train_batches,
                             "val_batches": val_batches}
    if grid is not None:
        loops.update(val_batches=rank_val_batches, grid=grid,
                     val_n_true=len(val_records))
    elif params_cfg["device_cache"]:
        # stage both splits on the card once: every epoch is device work
        train_dset = DeviceDataset.from_records(train_records, device=device)
        val_dset = DeviceDataset.from_records(val_records, device=device)
        print(f"device_cache: {len(train_dset)} train + {len(val_dset)} val "
              f"crops staged on {device}")
        train_ep = make_mae_train_epoch(model, optimizer, mask_ratio, lesion,
                                        augment.POLICIES["mae_train"])
        val_ep = make_mae_eval_epoch(model, eval_ratio,
                                     augment.POLICIES["mae_eval"])
        tail_step = make_mae_eval_step(model, eval_ratio)
        val_bs = min(VAL_BS, len(val_dset))
        n_full = len(val_dset) // val_bs
        val_order = np.arange(n_full * val_bs).reshape(-1, val_bs)
        tail = n_full * val_bs

        def fused_train(epoch, aug_rng, mask_rng):
            order = weighted_sample_indices(labels, None, sampler_rng)
            step_idx = train_dset.epoch_order(batch_size, order=order)
            return train_ep(train_dset.images, train_dset.masks, step_idx,
                            aug_rng, mask_rng)

        def fused_val(gen):
            loss = val_ep(val_dset.images, val_dset.masks, val_order,
                          gen) * val_order.size
            if tail < len(val_dset):  # the partial last batch
                img, _ = augment.POLICIES["mae_eval"](
                    val_dset.images[tail:], val_dset.masks[tail:])
                loss += float(tail_step(img, gen)) * (len(val_dset) - tail)
            return loss / len(val_dset)

        loops = {"fused_train": fused_train, "fused_val": fused_val}

    coord = logger is not None  # the checkpoints and the hook: rank 0
    result = train_mae(
        model, optimizer, num_epochs=epochs, rng=pool, logger=logger,
        checkpoint_dir=(os.path.join(config["model_path"], "mae_ckpt")
                        if coord else None),
        mask_ratio=mask_ratio, eval_mask_ratio=eval_ratio,
        use_lesion_mask=lesion, epoch_hook=epoch_hook if coord else None,
        **loops)

    model_path = None
    if coord:
        os.makedirs(config["model_path"], exist_ok=True)
        model_path = os.path.join(config["model_path"], uuid.uuid4().hex)
        ckpt.save_checkpoint(model_path, result["best_state"],
                             metadata={"val_loss": result["best_val_loss"]})
        logger.assign("best_model_path", model_path)
        logger.print(f"Saved Best Model at {model_path}")
    dist.barrier()
    return {"model_path": model_path,
            "run_dir": logger.dir if coord else None,
            "train_idx": train_idx, "val_idx": val_idx,
            "history": result["history"],
            "best_val_loss": result["best_val_loss"],
            "checkpoint": result["checkpoint"]}


if __name__ == "__main__":
    main()
