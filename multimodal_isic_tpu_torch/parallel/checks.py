"""Each parallel program of the port against one process, run by a rank.

A check runs the program on this rank's part (its rows of the global
batch, its slice of the blocks), and rank 0 then runs the one-process
program on the whole global batch with the same seeds and compares: the
parameters (and BatchNorm statistics) after the steps and the losses.
``entry.dryrun_multichip`` runs them in ranks on the CPU; the card's smoke
run at full width.  Each check returns a JSON-ready dict: the program's
losses, its wall seconds, the kernel launches of its run, and on rank 0
the reference's losses and seconds and ``err`` (:func:`compare_states`).

The seeds: weights from ``generator(seed)`` (then rank 0's broadcast),
batch draws from the ``augment`` / ``dropout`` / ``mask`` streams of
``RngPool(seed)``, one generator a step: equal on every rank and in the
reference, so the draws of the global batch are the reference's.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core.rng import RngPool, generator
from ..models.convmae import ConvMAE, build_convmae
from . import distributed as D
from .sharding import Grid, all_reduce_grads_, replicate_, shard_rows, \
    shard_transform

TINY_MAE = dict(img_size=64, embed_dims=(16, 24, 32), depths=(1, 1, 2),
                num_heads=4, decoder_dim=16, decoder_depth=1,
                decoder_heads=4)


def compare_states(got: Dict[str, torch.Tensor],
                   want: Dict[str, torch.Tensor], rtol: float,
                   atol: float) -> Dict:
    """→ {max_abs, worst (the entry of the largest excess), excess (the
    largest |got − want| − (atol + rtol·|want|): ≤ 0 everywhere when
    ``ok``), ok} over the floating entries of two state dicts."""
    if set(got) != set(want):
        raise KeyError(f"state dicts differ in keys: "
                       f"{sorted(set(got) ^ set(want))[:5]}")
    max_abs, excess, worst = 0.0, -float("inf"), ""
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        g, w = got[k].double().cpu(), w.double().cpu()
        diff = (g - w).abs()
        max_abs = max(max_abs, float(diff.max()))
        e = float((diff - atol - rtol * w.abs()).max())
        if e > excess:
            excess, worst = e, k
    return {"max_abs": max_abs, "worst": worst, "excess": excess,
            "ok": excess <= 0.0, "rtol": rtol, "atol": atol}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _losses_ok(got, want, rtol: float) -> bool:
    return bool(np.allclose(got, want, rtol=rtol, atol=0.0))


# ---------------------------------------------------------------- fusion

def fusion_requests(n: int, src_hw: int, seed: int = 0
                    ) -> Dict[str, np.ndarray]:
    """``n`` seeded fusion requests: uint8 [n, src, src, 3] crops and the
    metadata columns (int64)."""
    rng = np.random.RandomState(seed)
    return {"image": rng.randint(0, 256, (n, src_hw, src_hw, 3), np.uint8),
            "radiomics": rng.randn(n, 780).astype(np.float32),
            "age": rng.randn(n).astype(np.float32),
            "sex": rng.randint(0, 3, n).astype(np.int64),
            "loc": rng.randint(0, 15, n).astype(np.int64),
            "artifacts": rng.randint(0, 2, (n, 6)).astype(np.int64),
            "target": rng.randint(0, 7, n).astype(np.int64)}


def fusion_steps(grid: Optional[Grid], device, reqs, backbone: str, hw: int,
                batch: int, steps: int, seed: int):
    """``steps`` fast-policy train steps of the fusion net on global
    batches of ``batch`` (this rank's rows of each) → (model, losses,
    seconds after the first step)."""
    from ..data.augment import make_fusion_train_fast
    from ..ops.affine_warp import affine_warp_batch
    from ..train.fusion import (build_fusion, fusion_optimizer,
                                make_fusion_train_step)

    device = torch.device(device)
    model = build_fusion(generator(seed, device), backbone=backbone)
    if grid is not None:
        replicate_(model)
    step = make_fusion_train_step(model, fusion_optimizer(model), grid)
    policy = shard_transform(make_fusion_train_fast((hw, hw)), grid)
    pool = RngPool(seed, device)
    losses, t0 = [], None
    affine_warp_batch.launches = 0
    for s in range(steps):
        if s == 1:
            _sync(device)
            t0 = time.perf_counter()
        rows = {k: torch.from_numpy(v[s * batch:(s + 1) * batch])
                for k, v in reqs.items()}
        local = {k: v.to(device) for k, v in shard_rows(rows, grid).items()}
        local["image"], _ = policy(local["image"], None,
                                   pool["augment"].next())
        loss, _ = step(local, pool["dropout"].next())
        losses.append(float(loss))
    _sync(device)
    seconds = time.perf_counter() - t0 if t0 is not None else float("nan")
    return model, losses, seconds, affine_warp_batch.launches


def fusion_dp_check(grid: Grid, device, backbone: str = "efficientnet-b3",
                    hw: int = 64, src_hw: int = 80, batch: int = 4,
                    steps: int = 1, seed: int = 0, rtol: float = 1e-4,
                    atol: float = 1e-6) -> Dict:
    """The data-parallel fusion train step (global-batch BatchNorm, the
    draws of the global batch, gradients averaged) against one process."""
    device = torch.device(device)
    reqs = fusion_requests(batch * steps, src_hw, seed)
    model, losses, secs, warps = fusion_steps(grid, device, reqs, backbone,
                                             hw, batch, steps, seed)
    out = {"losses": losses, "seconds": secs, "warp_launches": warps,
           "img_s": batch * (steps - 1) / secs if steps > 1 else None}
    if grid.rank == 0:
        ref, ref_losses, ref_secs, _ = fusion_steps(
            None, device, reqs, backbone, hw, batch, steps, seed)
        out.update(ref_losses=ref_losses, ref_seconds=ref_secs,
                   ref_img_s=(batch * (steps - 1) / ref_secs
                              if steps > 1 else None),
                   err=compare_states(model.state_dict(), ref.state_dict(),
                                      rtol, atol),
                   losses_ok=_losses_ok(losses, ref_losses, 1e-5))
    D.barrier()
    return out


# ------------------------------------------------------------------ MAE

def mae_images(n: int, hw: int, seed: int = 0) -> np.ndarray:
    """``n`` seeded float32 [hw, hw, 3] images (the MAE step's input)."""
    return np.random.RandomState(seed).rand(n, hw, hw, 3).astype(np.float32)


def mae_step(grid: Optional[Grid], device, images, cfg: Dict,
             mask_ratio: float, seed: int, tp: bool):
    """One SGD(1e-2) MAE train step on this rank's rows (its blocks'
    slice with ``tp``) → (model, loss, seconds)."""
    from ..train.mae import make_mae_train_step
    from .tp import shard_convmae

    device = torch.device(device)
    model = build_convmae(generator(seed, device), **cfg)
    if grid is not None:
        replicate_(model)
        if tp:
            shard_convmae(model, grid)
    model.train()
    # SGD, not AdamW: Adam's first update is lr·sign(g), which turns the
    # reduction-order noise of near-zero gradients into full-rate flips
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    step = make_mae_train_step(model, opt, mask_ratio, grid=grid)
    local = shard_rows(torch.from_numpy(images), grid).to(device)
    _sync(device)
    t0 = time.perf_counter()
    loss = float(step(local, None, RngPool(seed, device)["mask"].next()))
    _sync(device)
    return model, loss, time.perf_counter() - t0


def _mae_launches() -> Dict[str, int]:
    from ..ops import attention, fused_mlp
    return {"fused_ln_mlp": fused_mlp.fused_ln_mlp.launches,
            "fused_ln_mlp_backward": fused_mlp.fused_ln_mlp_backward.launches,
            "flash_attention": attention.flash_attention.launches}


def _reset_mae_launches() -> None:
    from ..ops import attention, fused_mlp
    fused_mlp.fused_ln_mlp.launches = 0
    fused_mlp.fused_ln_mlp_backward.launches = 0
    attention.flash_attention.launches = 0


def mae_check(grid: Grid, device, cfg: Optional[Dict] = None,
              batch: int = 4, mask_ratio: float = 0.75, seed: int = 0,
              tp: bool = False, rtol: float = 1e-4,
              atol: float = 1e-6) -> Dict:
    """One MAE train step, data-parallel over ``grid``'s data ranks (and
    with ``tp`` its transformer blocks split over the model ranks),
    against one process with the replicated model."""
    from .tp import gather_convmae

    device = torch.device(device)
    cfg = dict(TINY_MAE if cfg is None else cfg)
    images = mae_images(batch, cfg.get("img_size", 224), seed)
    _reset_mae_launches()
    model, loss, secs = mae_step(grid, device, images, cfg, mask_ratio,
                                 seed, tp)
    out = {"loss": loss, "seconds": secs, "launches": _mae_launches()}
    state = gather_convmae(model, grid) if tp else model.state_dict()
    if grid.rank == 0:
        ref, ref_loss, ref_secs = mae_step(None, device, images, cfg,
                                           mask_ratio, seed, False)
        out.update(ref_loss=ref_loss, ref_seconds=ref_secs,
                   err=compare_states(state, ref.state_dict(), rtol, atol),
                   losses_ok=_losses_ok([loss], [ref_loss], 1e-5))
    D.barrier()
    return out


# ------------------------------------------------------------------ MIL

def mil_check(grid: Grid, device, bags: int = 4, seed: int = 0,
              rtol: float = 1e-4, atol: float = 1e-6) -> Dict:
    """The MIL loss and gradients of a batch of bags (eval mode), each
    rank its bags, against one process (JAX ``tests/test_parallel.py:
    116``: training itself is one bag at a time)."""
    from ..models.mil import AttentionMIL, mil_loss
    from ..train.mil import init_params_

    device = torch.device(device)
    rng = np.random.RandomState(seed)
    feats = torch.from_numpy(rng.randn(bags, 10, 12).astype(np.float32))
    valid = torch.ones(bags, 10, dtype=torch.bool)
    labels = torch.from_numpy(rng.randint(0, 3, bags))

    def run(g):
        model = AttentionMIL(input_dim=12, hidden_dim=16, att_dim=8,
                             num_classes=3)
        init_params_(model, seed)
        model.to(device)
        if g is not None:
            replicate_(model)
        f, v, y = (shard_rows(t, g).to(device) for t in (feats, valid, labels))
        loss = mil_loss(model(f, valid=v)[0], y).mean()
        loss.backward()
        loss = loss.detach().reshape(1)
        if g is not None:
            all_reduce_grads_(model, g.data_group, [loss])
        return {n: p.grad for n, p in model.named_parameters()}, float(loss)

    grads, loss = run(grid)
    out = {"loss": loss}
    if grid.rank == 0:
        ref_grads, ref_loss = run(None)
        out.update(ref_loss=ref_loss,
                   err=compare_states(grads, ref_grads, rtol, atol),
                   losses_ok=_losses_ok([loss], [ref_loss], 1e-5))
    D.barrier()
    return out
