"""CLI: multimodal fusion training (reference ``main.py``, the primary entry).

    python -m multimodal_isic_tpu_torch.cli.main --config_path config.yml

Counterpart of the single-process branch of ``multimodal_isic_tpu/cli/
main.py`` (:38-250), step for step: manifests → ``StratifiedKFold(10)``
fold select → ``DermRecords`` / ``DeviceLoader`` at the global batch of 16
→ ``MultiModalFusionNet(modality, fusion_level, fusion)`` → SGD(1e-3, wd
1e-4) + cross-entropy → epochs with early stopping on the validation loss →
the best weights saved under a fresh hex name → a fresh model restored from
that checkpoint → the test report.

- ``device_cache`` stages the train and validation splits on the card
  (``DeviceDataset``) and runs device-resident epochs; otherwise batches
  stream through ``DeviceLoader`` with the policy of ``augment_fast``.
- Image-less modality subsets read metadata-only records (no decode).
- ``radiomics_dim`` is the width the records give (the 102-wide placeholder
  where the radiomics pickles are absent), the width the JAX model infers.
- The image size follows the backbone (``image_hw``): EfficientNet trains
  and evaluates at 380² (``FUSED_EVAL_HW``), a MaxViT preset at its own
  size (``maxvit.PARAMS``: 384² for ``maxvit-base``, whose 12-wide windows
  cannot tile 380/4 = 95); the policies are ``augment.fusion_policies``
  at that size.
- ``fold_bn_eval`` runs the final test pass on the BN-folded net with the
  fused MBConv kernels (``backbone_pallas_serving``), the faster path on the
  H100 (``PERF.md`` §5).  A backbone without that path (MaxViT) takes the
  unfolded net.
- Several processes (``ISIC_*``, ``cli.common.setup_processes``; JAX
  :50-57,95-105,149,172-184,204,212-250): every rank loads its rows of each
  global batch of 16 through the streaming loader (no ``device_cache``),
  the train step is the data-parallel one (global-batch BatchNorm, the
  draws of the global batch, gradients averaged over the ranks), the
  validation and test loaders wrap-pad to full global batches and the
  gathered results are trimmed to the true rows; rank 0 alone logs,
  writes the run record and saves the checkpoint (its name broadcast),
  which every rank restores for the test pass.

``main`` returns the run's results: the checkpoint path, the run directory,
the fold's indices, the test accuracy, report and logits.
"""

from __future__ import annotations

import os
import uuid
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..core import checkpoint as ckpt
from ..core.early_stopping import EarlyStopping
from ..core.rng import RngPool
from ..core.splits import StratifiedKFold
from ..data import augment
from ..data.pipeline import DermRecords, DeviceDataset, DeviceLoader
from ..models import maxvit
from ..models.fusion import MultiModalFusionNet, fold_fusion_params, is_maxvit
from ..parallel import distributed as dist
from ..parallel.sharding import replicate_, shard_transform
from ..train.fusion import (build_fusion, evaluate_test, fusion_optimizer,
                            log_train_epoch, make_fusion_eval_epoch,
                            make_fusion_eval_step, make_fusion_train_epoch,
                            make_fusion_train_step, padded_epoch_order,
                            train_epoch, validate_epoch)
from ..utils.logging import RunLogger
from .common import parse_config, setup_processes

# EfficientNet's training and evaluation image size (tests patch it to run
# small images)
FUSED_EVAL_HW = (380, 380)
GLOBAL_BS = 16  # reference batch size (main.py:120-126)


def _empty_model(device: torch.device, **cfg) -> MultiModalFusionNet:
    """A fusion net laid out on ``device`` without initialising it (a state
    dict is loaded next)."""
    with torch.device("meta"):
        model = MultiModalFusionNet(**cfg)
    return model.to_empty(device=device)


def image_hw(backbone: str) -> Tuple[int, int]:
    """The size ``backbone`` trains and evaluates at."""
    if is_maxvit(backbone):
        s = maxvit.PARAMS[backbone].image_size
        return s, s
    return FUSED_EVAL_HW


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

    plan = config["training_plan"]
    params_cfg = plan["parameters"]
    seed = config["seed"]
    pool = RngPool(seed, device)

    df_train_val = pd.read_pickle(config["dir"]["df"])
    df_test = pd.read_pickle(config["dir"]["df_test"])

    radiomics = radiomics_test = None
    rad_path = config["dir"].get("radiomics_red")
    if rad_path and os.path.exists(rad_path):
        radiomics = pd.read_pickle(rad_path).values
        radiomics_test = pd.read_pickle(
            config["dir"]["radiomics_test_red"]).values

    kf = StratifiedKFold(n_splits=10, shuffle=True, random_state=seed)
    folds = list(kf.split(df_train_val, df_train_val["dx"]))
    current_fold = params_cfg["fold"]
    train_idx, val_idx = folds[current_fold]
    df_train = df_train_val.iloc[train_idx]
    df_val = df_train_val.iloc[val_idx]
    print(f"Train set size: {len(df_train)}")
    print(f"Val set size: {len(df_val)}")
    print(f"Test set size: {len(df_test)}")

    # image-less modality subsets never read the image branch: no decode,
    # no augmentation (metadata-only records)
    with_image = "image" in plan["modality"]
    backbone = params_cfg["backbone"]
    hw = image_hw(backbone)
    policies = augment.fusion_policies(hw)
    train_policy = ("fusion_train_fast" if params_cfg["augment_fast"]
                    else "fusion_train")
    train_tf = policies[train_policy] if with_image else None
    eval_tf = policies["fusion_eval"] if with_image else None

    def records(df, rad, idx=None):
        r = rad[idx] if (rad is not None and idx is not None) else rad
        return DermRecords(df, radiomics=r, with_image=with_image)

    train_records = records(df_train, radiomics, train_idx)
    val_records = records(df_val, radiomics, val_idx)
    print(f"decoder: {'native' if train_records.use_native else 'cv2'}")

    def eval_loader(recs):
        """→ (loader, n_true): several processes wrap the order to full
        global batches (the gathered results are trimmed to n_true)."""
        if grid is None:
            return DeviceLoader(recs, GLOBAL_BS, transform=eval_tf,
                                device=device), None
        order, per_bs, n_true = dist.process_epoch_order(
            np.arange(len(recs)), GLOBAL_BS, pad_to_full=True)
        return DeviceLoader(recs, per_bs, order=order, transform=eval_tf,
                            device=device), n_true

    val_loader, val_n = eval_loader(val_records)
    test_loader, test_n = eval_loader(records(df_test, radiomics_test))

    model_cfg = dict(modality=plan["modality"],
                     fusion_level=plan["fusion_level"],
                     fusion_strategy=plan["fusion"],
                     radiomics_dim=train_records.radiomics_dim,
                     backbone=backbone)
    if logger is not None:
        logger.assign("group_tags",
                      list(plan["modality"]) + [plan["fusion"]])
        logger.assign("train/current_fold", current_fold)

    model = build_fusion(pool["init"].next(), **model_cfg,
                         backbone_remat=params_cfg["backbone_remat"])
    replicate_(model)  # every rank starts from rank 0's weights
    optimizer = fusion_optimizer(model, lr=1e-3, weight_decay=1e-4)
    train_step = make_fusion_train_step(model, optimizer, grid)
    eval_step = make_fusion_eval_step(model)
    early_stopping = EarlyStopping(patience=params_cfg["patience"],
                                   log=logger.log if logger else None)
    train_tf = shard_transform(train_tf, grid)

    # device_cache: stage the train and validation crops on the card once,
    # then run every epoch as device work (gather → augment → step); several
    # processes keep the streaming loader (a rank loads its rows)
    train_device = val_device = None
    if params_cfg["device_cache"] and with_image and grid is None:
        # the fast policy never reads masks: none are staged for it
        train_device = DeviceDataset.from_records(
            train_records, device=device,
            with_masks=not params_cfg["augment_fast"])
        fused_epoch = make_fusion_train_epoch(model, optimizer,
                                              transform=train_tf)
        val_device = DeviceDataset.from_records(val_records, device=device,
                                                with_masks=False)
        fused_val = make_fusion_eval_epoch(model, out_hw=hw)
        val_order, val_valid = padded_epoch_order(len(val_device), GLOBAL_BS)
        staged = train_device.images.nbytes + val_device.images.nbytes
        print(f"device_cache: {len(train_device)} train + {len(val_device)} "
              f"val crops staged on {device} ({staged / 1e9:.2f} GB)")

    for epoch in range(1, params_cfg["epochs"] + 1):
        order = np.random.RandomState(seed + epoch).permutation(len(df_train))
        batch_size = GLOBAL_BS
        if grid is not None:  # one permutation; each rank its rows
            order, batch_size, _ = dist.process_epoch_order(order, GLOBAL_BS)
        if train_device is not None:
            step_idx = train_device.epoch_order(GLOBAL_BS, order=order)
            loss, ncorr = fused_epoch(train_device.images, train_device.masks,
                                      train_device.meta, step_idx,
                                      pool["augment"].next(),
                                      pool["dropout"].next())
            log_train_epoch(logger, model, epoch, loss, ncorr / step_idx.size)
        else:
            train_loader = DeviceLoader(
                train_records, batch_size, order=order, transform=train_tf,
                rng_stream=pool["augment"] if with_image else None,
                device=device)
            train_epoch(train_step, model, train_loader, pool["dropout"],
                        logger=logger, epoch=epoch)
        if val_device is not None:
            val_loss, vcorr = fused_val(val_device.images, val_device.meta,
                                        val_order, val_valid)
            val_acc = vcorr / len(val_device)
            logger.log("val/epoch_loss", val_loss, step=epoch)
            logger.log("val/epoch_acc", val_acc, step=epoch)
            logger.print(f"Epoch {epoch} - Val Loss: {val_loss:.4f}, "
                         f"Accuracy: {val_acc:.4f}")
        else:
            val_loss = validate_epoch(eval_step, val_loader, logger=logger,
                                      epoch=epoch, n_true=val_n,
                                      group_size=GLOBAL_BS)
        if early_stopping(val_loss, model.state_dict()):
            print(f"Early stopping at epoch {epoch}")
            break

    best = early_stopping.get_best_params() or model.state_dict()
    # every rank restores the same path: rank 0's name, rank 0's file
    model_name = os.path.join(config["model_path"],
                              dist.broadcast_object(uuid.uuid4().hex))
    if dist.is_coordinator():
        os.makedirs(config["model_path"], exist_ok=True)
        ckpt.save_checkpoint(model_name, best)
        logger.assign("best_model_path", model_name)
    dist.barrier()

    restored = ckpt.restore_checkpoint(model_name, device=device)
    if params_cfg["fold_bn_eval"] and with_image and not is_maxvit(backbone):
        # serving path: backbone BN folded into the conv weights, the
        # stride-1 MBConv blocks on the fused kernels
        test_model = _empty_model(device, **model_cfg,
                                  backbone_bn_folded=True,
                                  backbone_pallas_serving=True)
        test_model.load_state_dict(fold_fusion_params(restored,
                                                      backbone=backbone))
    else:
        test_model = _empty_model(device, **model_cfg)
        test_model.load_state_dict(restored)
    test_step = make_fusion_eval_step(test_model)
    logits = []

    def keep_logits(batch):
        loss, out = test_step(batch)
        logits.append(dist.gather_to_host(out.float()))
        return loss, out

    acc, report = evaluate_test(keep_logits, test_loader, logger=logger,
                                n_true=test_n)
    return {"model_path": model_name,
            "run_dir": logger.dir if logger is not None else None,
            "train_idx": train_idx, "val_idx": val_idx, "accuracy": acc,
            "report": report,
            "logits": torch.from_numpy(np.concatenate(logits)[:test_n])}


if __name__ == "__main__":
    main()
