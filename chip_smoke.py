#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving, training, radiomics and ConvMAE
slices on one CUDA card.

    python3 chip_smoke.py

Drives ``multimodal_isic_tpu_torch`` end to end at the full EfficientNet-B3
width with random weights from a seed:

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels (``csrc/fused_dwconv.cu``, ``csrc/affine_warp.cu``,
   ``csrc/glcm.cu``, ``csrc/glrlm_runs.cu``, ``csrc/histogram.cu``,
   ``csrc/connected_components.cu``), one nvcc per source, started together;
3. holds each fused MBConv kernel against its plain PyTorch version at every
   geometry the B3@380 serving forward gives it, in bf16 and float32;
4. serves 64 in-memory requests (rendered 450×600 samples, centroid-cropped
   to 450²) in batches of 16 through preprocess → BN-folded fusion net on the
   fused-kernel path → ``make_fusion_eval_step`` → ``evaluate_test``; checks
   the kernel launch counts, that the logits are finite and that they agree
   with the plain folded path and with the unfolded standard-BN model;
5. holds the warp kernel against its plain version and ``F.grid_sample`` at
   bs 16, 380², on the policy's draws, its domain corners, the identity, an
   overhang beyond 128 px, and at an odd non-square size;
6. trains: 160 rendered requests, ``StratifiedKFold(10)`` fold 0 staged in
   ``DeviceDataset``, the full B3 fusion net in float32 with the CLI's
   defaults, 2 device-resident epochs of the fast policy, validation epochs,
   early stopping, a checkpoint saved and restored into a fresh model, BN
   folded, and the kernel-path test pass; checks finite losses, moved
   weights and statistics, one warp launch per step, 2 + 20 fused launches
   per test forward, and that the restored model gives the saved one's
   logits;
7. trains 20 steps on one fixed batch (no augmentation, the same dropout
   masks every step) and checks that the loss falls;
8. times the kernels against their plain versions (and the warp against
   ``grid_sample``), the fast policy, the train step in img/s at bs 16 f32
   and bs 128 with a bf16 backbone, and preprocess + folded forward on the
   kernel path against the plain path, with CUDA events;
9. radiomics extraction (the 13-filter bank × six texture classes +
   shape2D, 4,872 features an image): holds the GLCM, GLRLM-runs,
   joint-histogram and connected-components kernels bit for bit against
   their plain versions on a real chunk's derived images (64 maps of
   450×600: original, LoG σ 3, wavelet-HH) and on full-frame edge cases;
   extracts 32 rendered 450×600 lesions (a depth cut of HAM10000's 10,015)
   in 2 chunks of 16 on the kernel path and checks the columns, shape2D
   across channels and 13 launches of each kernel per chunk; extracts them
   again on the plain path (NaNs at the same places, every feature within
   ``RAD_TOL``) and two small crops on the CPU; times each kernel against
   its plain version and ``torch.bincount`` where one call computes the same
   counts, extraction img/s on both paths, peak memory, and a profile of
   one chunk by kernel family;
10. ConvMAE (ConvViT-Base: dims 256/384/768, depths 2/2/11, 12 heads, full
   width and depth, seeded random weights): holds the fused LN-MLP,
   attention and fused-front kernels against their plain versions at every
   geometry of the two paths; extracts latents of 256 rendered lesions
   (450² centroid crops, a depth cut of HAM10000's 10,015) in bf16 batches
   of 128 through ``mae_eval_batch`` → encoder → bundles → patch tables →
   patch moments → PCA(0.90), with 4 fused LN-MLP launches a forward, then
   on the plain path and with attention and the front kernel on (11 + 4
   more launches a forward), each within ``LATENT_TOL`` of the other; runs
   the masked validation forward (decoder 512 × 8, bs 16 float32, mask
   0.75, norm-pix loss) with all three kernels and with none on one set of
   masking draws; times each kernel against its plain version, bound and
   (attention) ``F.scaled_dot_product_attention``, the encoder's img/s on
   the three configurations, the validation forward, peak memory and
   profiles;
11. ConvMAE training (the slice's configuration: bs 16 float32, mask 0.75,
   norm-pix loss, AdamW enc 1e-5 / dec 1e-3, betas (0.9, 0.95), wd 0.05,
   the fused LN-MLP on): holds the fused LN-MLP backward kernel against its
   plain version at every geometry of the path (stages 1 and 2 at bs 16
   float32 and bs 64 bf16, and an M that is not a multiple of the row
   block); checks one train step's gradients, kernel path against plain
   path, at full width and depth (no parameter without a finite gradient);
   trains 2 epochs on 160 rendered lesions (450² crops, 10% held out;
   ``weighted_sample_indices`` each epoch, ``DeviceDataset`` with masks,
   ``mae_train``) through ``train_mae`` with a validation epoch each on
   fixed draws, 4 forward and 4 backward fused launches a step, restores the
   best-validation checkpoint into a fresh model and optimizer and checks
   its validation loss bit for bit; runs one step with all three kernels and
   lesion-guided masking against the plain path; trains 20 steps on one
   fixed batch (the loss must fall); times the backward kernel against its
   plain version and bound, the train step in img/s at bs 16 float32 and
   bs 64 bf16 on the kernel and plain paths, peak memory and a profile.

Float32 on the card runs in full float32 here: TF32 is off for cuDNN and
cuBLAS throughout (``torch.backends.cudnn.allow_tf32 = False``).

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA the script exits non-zero
and prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SEED = 0
N_REQUESTS = 64
BATCH = 16                # the serving batch of the CLI's test pass
LARGE_BATCH = 128
SRC_HW = (450, 600)
IMG = 380
RADIOMICS_DIM = 780
N_TRAIN = 160             # rendered requests of the training slice
EPOCHS = 2
LEARN_STEPS = 20
RAD_N = 32                # rendered 450×600 samples (HAM10000 holds 10,015)
RAD_CHUNK = 16            # images per chunk, cli/extract_radiomics.py:24
RAD_CHECK_TYPES = ("original", "log-sigma-3-0-mm-3D", "wavelet-HH")
NG, MAX_LEN = 64, 640     # gray levels; glrlm_max_len
LAT_N = 256               # rendered lesions for latents (HAM10000: 10,015)
LAT_BATCH = 128           # cli/save_latent.py:61
VAL_BATCH = 16            # configs/config.yml batch_size, MAE validation
MASK_RATIO = 0.75         # configs/config.yml eval_masking_ratio
MAE_KERNELS = ("fused_ln_mlp", "flash_attention", "fused_front")
MAE_TRAIN_N = 160         # rendered lesions of the MAE training slice
MAE_EPOCHS = 2
MAE_LARGE_BATCH = 64      # the bf16 train step (the JAX bench's MAE batch)
MAE_LEARN_STEPS = 20
SOURCE = {"dw_silu_pool": "multimodal_isic_tpu_torch/csrc/fused_dwconv.cu",
          "expand_dw_silu_pool": "multimodal_isic_tpu_torch/csrc/fused_dwconv.cu",
          "affine_warp_batch": "multimodal_isic_tpu_torch/csrc/affine_warp.cu",
          "glcm_matrices": "multimodal_isic_tpu_torch/csrc/glcm.cu",
          "glrlm_runs": "multimodal_isic_tpu_torch/csrc/glrlm_runs.cu",
          "joint_histogram": "multimodal_isic_tpu_torch/csrc/histogram.cu",
          "connected_components":
              "multimodal_isic_tpu_torch/csrc/connected_components.cu",
          "fused_ln_mlp": "multimodal_isic_tpu_torch/csrc/fused_ln_mlp.cu",
          "flash_attention": "multimodal_isic_tpu_torch/csrc/flash_attention.cu",
          "fused_front": "multimodal_isic_tpu_torch/csrc/fused_front.cu",
          "fused_ln_mlp_backward":
              "multimodal_isic_tpu_torch/csrc/fused_ln_mlp_bwd.cu"}
REPLACES = {"dw_silu_pool": "multimodal_isic_tpu/ops/fused_dwconv.py:272",
            "expand_dw_silu_pool": "multimodal_isic_tpu/ops/fused_dwconv.py:326",
            "affine_warp_batch": "multimodal_isic_tpu/ops/pallas_warp.py:190",
            "glcm_matrices": "multimodal_isic_tpu/ops/pallas_glcm.py:95",
            "glrlm_runs": "multimodal_isic_tpu/ops/pallas_glrlm.py:105",
            "joint_histogram": "multimodal_isic_tpu/ops/pallas_hist.py:81",
            "connected_components": "multimodal_isic_tpu/ops/pallas_cc.py:148",
            "fused_ln_mlp": "multimodal_isic_tpu/ops/fused_mlp.py:196",
            "flash_attention": "multimodal_isic_tpu/ops/attention.py:93",
            "fused_front": "multimodal_isic_tpu/ops/fused_convblock.py:146",
            "fused_ln_mlp_backward": "multimodal_isic_tpu/ops/fused_mlp.py:312"}
RAD_KERNELS = ("glcm_matrices", "glrlm_runs", "joint_histogram",
               "connected_components")
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# and float32 CUDA-core FLOP/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12


def ops_ms(bf16: float = 0.0, f32: float = 0.0) -> float:
    """Least time of a call's operations: ``bf16`` FLOP of products of bf16
    operands (tensor cores) and ``f32`` FLOP of float32 work (CUDA cores).
    The two pipes run side by side, so the slower one bounds the call."""
    return max(bf16 / BF16_FLOPS, f32 / F32_FLOPS) * 1e3

# Kernel vs plain: |err| <= atol + rtol * |plain|.
#  float32: the same f32 arithmetic in another order (cuBLAS/cuDNN vs the
#    kernel's FMA loops, atomics in the pool): a few ulps of O(1) values.
#  bfloat16: the expand output and y are rounded to bf16 (2^-8 relative);
#    a different f32 summation order can flip one rounding, so allow ~2 ulps
#    on y; the pool is an f32 mean over H·W, where such flips average out.
TOL = {torch.float32: {"y": (1e-4, 1e-4), "pool": (1e-5, 1e-4)},
       torch.bfloat16: {"y": (2e-2, 2e-2), "pool": (1e-3, 1e-3)}}
# Logits of the folded bf16 fusion net, kernel path vs plain path: the two
# round the 22 fused blocks' outputs at different points (kernel: silu in
# f32 before one rounding; plain: conv output rounded, then silu in bf16).
LOGIT_TOL_PLAIN = dict(rtol=5e-2, atol=5e-2)
# Folded vs unfolded standard-BN model, as bench.py:150-151 held them.
LOGIT_TOL_UNFOLDED = dict(rtol=0.1, atol=0.15)
# Warp kernel vs its plain version, 0..255 scale, as
# tests/test_pallas_warp.py:49: the coordinates are the same f32 values
# (explicitly rounded, JAX order); only the four-tap blend rounds
# differently.  grid_sample works in normalised coordinates (|x_n| up to ~3
# with an overhang): their f32 rounding, times (n-1)/2 px, times up to 255
# per px, reaches ~0.05 at 380².
WARP_ATOL = 2e-2
GRID_SAMPLE_ATOL = 0.1
# Folded f32 kernel path vs the unfolded f32 model it was folded from: the
# fold is exact in float64, then rounded to f32 once.
LOGIT_TOL_FOLDED_F32 = dict(rtol=1e-3, atol=1e-3)
# Radiomics features, kernel path vs plain path on the card: the four
# kernels' outputs are bit-equal to their plain versions, so the features
# differ only where float sums go through atomics in another order (NGTDM's
# per-level Σ|diff| by index_add_); NaNs must sit at the same places.
RAD_TOL = dict(rtol=1e-5, atol=1e-6)
# Card (kernel path) vs CPU (plain path) on a small input: the same code, but
# CUDA's and the CPU's exp/log and reduction orders round differently; the
# tight comparison with the JAX package is in the CPU tests.
RAD_CPU_TOL = dict(rtol=1e-3, atol=1e-3)
# bf16 latents (|latent| up to ~4), kernel path vs plain path and flash +
# front vs the kernel path: the paths round at different points (the fused
# blocks add biases before rounding, flax's Conv after) and the flips carry
# through 15 blocks.  At full width on the CPU (plain versions, bs 2) the
# gaps were 0.9% relative RMS and 0.086 max: allow three times that.
LATENT_TOL = {"max_abs": 0.25, "rel_rms": 0.03}
# float32 validation losses (~2), all kernels vs none: summation order only.
VAL_TOL = dict(rtol=1e-4, atol=1e-5)
# One float32 train step's gradients, kernel path vs plain path, per
# parameter group (top-level module): ||kernel - plain|| / ||plain|| over the
# group.  The paths differ in float32 summation order only (kernels vs
# cuBLAS), carried through 15 encoder and 8 decoder blocks and back; a group
# norm, not a tensor's, because the key part of each qkv bias has an exactly
# zero gradient whose computed value is rounding noise.
MAE_GRAD_TOL = 1e-3


def serving_geometries(name: str = "efficientnet-b3", size: int = IMG):
    """(kind, H, Cin, Cmid, K) of every stride-1 MBConv block of the serving
    forward, in block order (H = W)."""
    from multimodal_isic_tpu_torch.models.efficientnet import block_args
    h = -(-size // 2)  # stem, stride 2
    out = []
    for expand, k, stride, cin, _ in block_args(name):
        if stride == 1:
            kind = "dw" if expand == 1 else "expand"
            out.append((kind, h, cin, cin * expand, k))
        else:
            h = -(-h // stride)
    return out


def seeded_init_(model: torch.nn.Module, seed: int) -> None:
    """Random weights from a seed: LeCun-normal matrices and conv kernels,
    small biases, and BatchNorm statistics that are not the identity, so
    that folding them is not vacuous."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            is_norm = any(s in name for s in ("_bn.", ".bn", ".ln"))
            if leaf == "weight" and p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p[0].numel()))
            elif leaf == "weight" and is_norm:
                p.copy_(torch.empty(p.shape).uniform_(0.8, 1.2, generator=g))
            else:
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(torch.empty(b.shape).uniform_(0.5, 1.5, generator=g))


def make_requests(n: int, src_hw=SRC_HW, seed: int = SEED):
    """n in-memory requests as the data pipeline would yield them: a uint8
    centroid crop of a rendered sample plus its metadata, stacked."""
    from multimodal_isic_tpu_torch.data.crop import centroid_crop
    from multimodal_isic_tpu_torch.data.synthetic import (ARTIFACT_COLS,
                                                          DX_CLASSES,
                                                          _render_sample)
    rng = np.random.RandomState(seed)
    crops, targets = [], []
    for i in range(n):
        cls = i % len(DX_CLASSES)
        img, mask = _render_sample(rng, *src_hw, cls)
        crops.append(centroid_crop(img, mask)[0])
        targets.append(cls)
    return {
        "image": np.stack(crops),
        "radiomics": rng.randn(n, RADIOMICS_DIM).astype(np.float32),
        "age": rng.randn(n).astype(np.float32),
        "sex": rng.randint(0, 3, n),
        "loc": rng.randint(0, 15, n),
        "artifacts": rng.randint(0, 2, (n, len(ARTIFACT_COLS))),
        "target": np.asarray(targets),
    }


def build_models(device, dtype=torch.bfloat16, name="efficientnet-b3",
                 radiomics_dim=RADIOMICS_DIM, seed=SEED):
    """(folded kernel-path, folded plain-path, unfolded standard-BN) fusion
    nets with the same seeded weights, backbone computing in ``dtype`` (the
    standard model on float32 master weights)."""
    from multimodal_isic_tpu_torch.models.fusion import (MultiModalFusionNet,
                                                         fold_fusion_params)
    kw = dict(backbone=name, radiomics_dim=radiomics_dim, dtype=dtype)
    standard = MultiModalFusionNet(**kw)
    seeded_init_(standard, seed)
    folded_sd = fold_fusion_params(standard.state_dict(), backbone=name)
    kernel = MultiModalFusionNet(**kw, backbone_bn_folded=True,
                                 backbone_pallas_serving=True)
    plain = MultiModalFusionNet(**kw, backbone_bn_folded=True)
    kernel.load_state_dict(folded_sd)
    plain.load_state_dict(folded_sd)
    return tuple(m.to(device).eval() for m in (kernel, plain, standard))


def _allclose_err(got, want, atol, rtol):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    return float(err.max()), ok


def _kernel_inputs(kind, bsz, h, cin, cmid, k, dtype, device, g):
    """Arguments as the model passes them: weights are views of OIHW conv
    parameters, everything in ``dtype``."""
    x = torch.randn(bsz, h, h, cin, generator=g, device=device).to(dtype)
    wd = (torch.randn(cmid, 1, k, k, generator=g, device=device) / k).to(dtype)
    bd = (torch.randn(cmid, generator=g, device=device) * 0.1).to(dtype)
    if kind == "dw":
        return (x, wd.permute(2, 3, 1, 0), bd)
    we = (torch.randn(cmid, cin, generator=g, device=device)
          / math.sqrt(cin)).to(dtype)
    be = (torch.randn(cmid, generator=g, device=device) * 0.1).to(dtype)
    return (x, we.t(), be, wd.permute(2, 3, 1, 0), bd)


def check_kernels(device, bsz=BATCH):
    """Every distinct slice geometry, bf16 and f32: kernel vs plain."""
    from multimodal_isic_tpu_torch.ops import fused_dwconv as fd
    fns = {"dw": (fd.dw_silu_pool, fd.dw_silu_pool_reference),
           "expand": (fd.expand_dw_silu_pool, fd.expand_dw_silu_pool_reference)}
    g = torch.Generator(device=device).manual_seed(SEED)
    print("kernel vs plain tolerance, |err| <= atol + rtol*|plain|, (atol, rtol): "
          + "; ".join(f"{str(dt)[6:]} y {t['y']} pool {t['pool']}"
                      for dt, t in TOL.items()))
    worst = {"dw_silu_pool": 0.0, "expand_dw_silu_pool": 0.0}
    failures = []
    for dtype in (torch.bfloat16, torch.float32):
        for geo in sorted(set(serving_geometries()), key=lambda t: (t[0], -t[1])):
            kind, h, cin, cmid, k = geo
            args = _kernel_inputs(kind, bsz, h, cin, cmid, k, dtype, device, g)
            fn, ref = fns[kind]
            y, pool = fn(*args)
            y_ref, pool_ref = ref(*args)
            torch.cuda.synchronize()
            assert y.shape == y_ref.shape and y.dtype == dtype
            assert pool.shape == (bsz, cmid) and pool.dtype == torch.float32
            ey, oky = _allclose_err(y, y_ref, *TOL[dtype]["y"])
            ep, okp = _allclose_err(pool, pool_ref, *TOL[dtype]["pool"])
            label = f"{kind:6s} {h}²·{cin}→{cmid} k{k} {str(dtype)[6:]}"
            print(f"check {label}: max_abs_err y {ey:.3e} pool {ep:.3e} "
                  f"({'ok' if oky and okp else 'FAIL'})")
            if dtype == torch.bfloat16:
                name = fn.__name__
                worst[name] = max(worst[name], ey)
            if not (oky and okp):
                failures.append(label)
    if failures:
        raise AssertionError(f"kernel vs plain out of tolerance: {failures}")
    return worst


def fused_bound_ms(geo, bsz=BATCH, esz=2):
    """(bytes ms, operations ms) of one fused-kernel call: x, y, weights and
    pool moved once; the expand on the bf16 tensor cores, the depthwise
    taps as float32 FMAs on the CUDA cores."""
    kind, h, cin, cmid, k = geo
    px = bsz * h * h
    we = cin * cmid if kind == "expand" else 0
    n_bias = 2 * cmid if kind == "expand" else cmid
    nbytes = ((px * (cin + cmid) + we + k * k * cmid) * esz
              + n_bias * 4 + bsz * cmid * 4)
    expand = 2 * px * cin * cmid if kind == "expand" else 0
    taps = 2 * k * k * px * cmid
    return nbytes / HBM_BPS * 1e3, ops_ms(bf16=expand, f32=taps)


def warp_bound_ms(bsz, h, w, c, out_hw):
    """(bytes ms, operations ms) of one warp call: the batch read once, the
    output written once, the affines and flags; about 20 + 7·C float32
    operations per output pixel (coordinates, reflection, blend)."""
    px = bsz * out_hw[0] * out_hw[1]
    nbytes = (bsz * h * w * c + px * c) * 4 + bsz * 25
    return nbytes / HBM_BPS * 1e3, px * (20 + 7 * c) / F32_FLOPS * 1e3


def time_kernels(device, bsz=BATCH, dtype=torch.bfloat16):
    """Per-geometry kernel vs plain time (ms) at the serving batch, and the
    per-forward totals over the blocks that use each geometry: kernel,
    plain, bound, and the bound's bytes and operations parts."""
    from multimodal_isic_tpu_torch.ops import fused_dwconv as fd
    from multimodal_isic_tpu_torch.utils.profiling import timeit_closed
    fns = {"dw": (fd.dw_silu_pool, fd.dw_silu_pool_reference),
           "expand": (fd.expand_dw_silu_pool, fd.expand_dw_silu_pool_reference)}
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    per_geo = {}
    geos = serving_geometries()
    for geo in dict.fromkeys(geos):
        kind, h, cin, cmid, k = geo
        args = _kernel_inputs(kind, bsz, h, cin, cmid, k, dtype, device, g)
        fn, ref = fns[kind]
        t_ref1 = timeit_closed(lambda: ref(*args), iters=20, repeats=5)
        t_ker1 = timeit_closed(lambda: fn(*args), iters=20, repeats=5)
        t_ker2 = timeit_closed(lambda: fn(*args), iters=20, repeats=5)
        t_ref2 = timeit_closed(lambda: ref(*args), iters=20, repeats=5)
        ker = min(t_ker1["median"], t_ker2["median"]) * 1e3
        pln = min(t_ref1["median"], t_ref2["median"]) * 1e3
        b_bytes, b_ops = fused_bound_ms(geo, bsz)
        per_geo[geo] = (ker, pln, max(b_bytes, b_ops), b_bytes, b_ops)
        print(f"time {kind:6s} {h}²·{cin}→{cmid} k{k} bs{bsz} "
              f"{str(dtype)[6:]}: kernel {ker:.4f} ms, plain {pln:.4f} ms "
              f"({pln / ker:.2f}x); bound {max(b_bytes, b_ops):.4f} ms "
              f"(bytes {b_bytes:.4f}, operations {b_ops:.4f}): "
              f"{max(b_bytes, b_ops) / ker:.1%} of it")
    totals = {"dw_silu_pool": [0.0] * 5, "expand_dw_silu_pool": [0.0] * 5}
    for geo in geos:
        name = "dw_silu_pool" if geo[0] == "dw" else "expand_dw_silu_pool"
        for i, v in enumerate(per_geo[geo]):
            totals[name][i] += v
    return totals


def _ssr_affines(cases, h, w, device):
    """(dx, dy, scale, angle°) cases → inverse affines [B, 6] on ``device``."""
    from multimodal_isic_tpu_torch.data.augment import ssr_inverse
    dx, dy, sc, an = (torch.tensor([c[i] for c in cases], dtype=torch.float32,
                                   device=device) for i in range(4))
    return ssr_inverse(h, w, dx, dy, sc, an)


def check_warp(device, bsz=BATCH):
    """Warp kernel vs its plain version and vs grid_sample: the policy's
    draws at bs 16, 380², and its domain corners, the identity, overhangs
    beyond 128 px and an odd non-square size → worst error vs plain."""
    from multimodal_isic_tpu_torch.data.augment import ssr_draw, ssr_inverse
    from multimodal_isic_tpu_torch.ops import affine_warp as aw
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    corners = [(sx * 0.05, sy * 0.05, sc, sa * 15.0) for sx in (-1, 1)
               for sy in (-1, 1) for sc in (0.9, 1.1) for sa in (-1, 1)]
    cases = {"policy draws": None,
             "domain corners + identity": corners + [(0.0, 0.0, 1.0, 0.0)],
             "overhang > 128 px": [(0.45, -0.4, 0.6, 170.0),
                                   (-0.6, 0.3, 1.4, -95.0),
                                   (0.35, 0.35, 0.5, 45.0)]}
    print(f"warp kernel, 0..255 scale, max_abs_err tolerance: vs plain "
          f"{WARP_ATOL} (same coordinates; blend rounding), vs grid_sample "
          f"{GRID_SAMPLE_ATOL} (its normalised coordinates round)")
    worst, failures = 0.0, []
    for label, hw in [(k, (IMG, IMG)) for k in cases] + [("odd 97x131",
                                                          (97, 131))]:
        h, w = hw
        if label == "policy draws":
            d = ssr_draw(g, bsz)
            inv = ssr_inverse(h, w, d["dx"], d["dy"], d["scale"], d["angle"])
            apply = d["apply"]
        else:
            inv = _ssr_affines(cases.get(label, corners[:6]), h, w, device)
            apply = None
        imgs = torch.randint(0, 256, (inv.shape[0], h, w, 3), generator=g,
                             device=device).float()
        out = aw.affine_warp_batch(imgs, inv, hw, apply=apply)
        torch.cuda.synchronize()
        ref = aw.affine_warp_batch_reference(imgs, inv, hw, apply=apply)
        lib = aw.affine_warp_grid_sample(imgs, inv, hw)
        if apply is not None:
            lib = torch.where(apply[:, None, None, None], lib, imgs)
        e_ref = float((out - ref).abs().max())
        e_lib = float((out - lib).abs().max())
        ok = e_ref <= WARP_ATOL and e_lib <= GRID_SAMPLE_ATOL
        print(f"check warp {label} {h}x{w} (B={inv.shape[0]}): max_abs_err "
              f"vs plain {e_ref:.3e}, vs grid_sample {e_lib:.3e} "
              f"({'ok' if ok else 'FAIL'})")
        worst = max(worst, e_ref)
        if not ok:
            failures.append(label)
    if failures:
        raise AssertionError(f"warp out of tolerance: {failures}")
    return worst


def empty_model(device, **cfg):
    """A fusion net laid out on ``device`` without initialising it (its
    state dict is loaded next)."""
    from multimodal_isic_tpu_torch.models.fusion import MultiModalFusionNet
    with torch.device("meta"):
        model = MultiModalFusionNet(**cfg)
    return model.to_empty(device=device)


def train_slice(device, test_reqs):
    """The training path at full width → (warp launches, train steps)."""
    from multimodal_isic_tpu_torch.core import checkpoint
    from multimodal_isic_tpu_torch.core.early_stopping import EarlyStopping
    from multimodal_isic_tpu_torch.core.rng import RngPool
    from multimodal_isic_tpu_torch.core.splits import StratifiedKFold
    from multimodal_isic_tpu_torch.data.augment import (POLICIES,
                                                        preprocess_eval_batch)
    from multimodal_isic_tpu_torch.data.pipeline import DeviceDataset
    from multimodal_isic_tpu_torch.models.fusion import fold_fusion_params
    from multimodal_isic_tpu_torch.ops import affine_warp as aw
    from multimodal_isic_tpu_torch.ops import fused_dwconv as fd
    from multimodal_isic_tpu_torch.train import fusion as T

    t0 = time.perf_counter()
    reqs = make_requests(N_TRAIN, seed=SEED + 1)
    meta = {k: v for k, v in reqs.items() if k != "image"}
    train_idx, val_idx = next(StratifiedKFold(
        10, shuffle=True, random_state=SEED).split(reqs["image"],
                                                   reqs["target"]))
    sub = lambda idx: {k: v[idx] for k, v in meta.items()}
    train_ds = DeviceDataset(reqs["image"][train_idx], sub(train_idx),
                             device=device, with_masks=False)
    val_ds = DeviceDataset(reqs["image"][val_idx], sub(val_idx),
                           device=device, with_masks=False)
    print(f"train: {N_TRAIN} rendered requests, StratifiedKFold(10) fold 0: "
          f"{len(train_ds)} train + {len(val_ds)} val staged on the card "
          f"({(train_ds.images.nbytes + val_ds.images.nbytes) / 1e6:.1f} MB) "
          f"in {time.perf_counter() - t0:.1f} s")

    pool = RngPool(SEED, device)
    cfg = dict(backbone="efficientnet-b3", radiomics_dim=RADIOMICS_DIM,
               fusion_level="intermediate", fusion_strategy="concat")
    model = T.build_fusion(pool["init"].next(), **cfg)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = T.fusion_optimizer(model, lr=1e-3, weight_decay=1e-4)
    epoch_fn = T.make_fusion_train_epoch(model, opt,
                                         POLICIES["fusion_train_fast"])
    val_fn = T.make_fusion_eval_epoch(model, (IMG, IMG))
    val_order, val_valid = T.padded_epoch_order(len(val_ds), BATCH)
    stopper = EarlyStopping(patience=5)

    aw.affine_warp_batch.launches = 0
    n_steps = 0
    for epoch in range(1, EPOCHS + 1):
        t0 = time.perf_counter()
        order = train_ds.epoch_order(
            BATCH, np.random.RandomState(SEED + epoch).permutation(len(train_ds)))
        n_steps += len(order)
        loss, correct = epoch_fn(train_ds.images, train_ds.masks,
                                 train_ds.meta, order, pool["augment"].next(),
                                 pool["dropout"].next())
        vloss, vcorrect = val_fn(val_ds.images, val_ds.meta, val_order,
                                 val_valid)
        stop = stopper(vloss, model.state_dict())
        print(f"epoch {epoch}: {len(order)} steps of {BATCH}, train loss "
              f"{loss:.4f} acc {correct / order.size:.4f}; val loss "
              f"{vloss:.4f} acc {vcorrect / len(val_ds):.4f}; patience "
              f"{stopper.counter}; {time.perf_counter() - t0:.1f} s")
        if not (math.isfinite(loss) and math.isfinite(vloss)):
            raise AssertionError("non-finite loss")
        if stop:
            break
    launches = aw.affine_warp_batch.launches
    print(f"warp launches in training: {launches} over {n_steps} train steps")
    if launches != n_steps:
        raise AssertionError(f"{launches} warp launches != {n_steps} steps")

    after = model.state_dict()
    params = dict(model.named_parameters())
    still = [k for k in before if torch.equal(before[k], after[k])]
    n_par = sum(k in params for k in still)
    n_stats = sum("running_" in k for k in still)
    print(f"moved: {len(params) - n_par}/{len(params)} parameter tensors, "
          f"{sum('running_' in k for k in before) - n_stats}/"
          f"{sum('running_' in k for k in before)} BN running statistics; "
          f"unmoved: {still[:8]}")
    # a weight-decayed tensor can round back when its gradient is 0 (an
    # embedding row no batch drew), so 1% of the parameter tensors may stay
    if n_stats or n_par > 0.01 * len(params):
        raise AssertionError(f"tensors that never moved: {still[:20]}")

    # best weights → checkpoint → a fresh model → the same logits
    best = stopper.get_best_params()
    model.load_state_dict(best)
    test_dev = to_device_batch(test_reqs, device)
    test_dev["image"] = preprocess_eval_batch(test_dev["image"], (IMG, IMG))
    test_batches = [{k: v[s:s + BATCH] for k, v in test_dev.items()}
                    for s in range(0, len(test_dev["target"]), BATCH)]
    step = T.make_fusion_eval_step(model)
    saved_logits = torch.cat([step(b)[1] for b in test_batches])
    path = checkpoint.save_checkpoint(
        str(Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"),
        best, metadata={"best_val_loss": stopper.best_loss})
    restored = checkpoint.restore_checkpoint(path, device=device)
    fresh = empty_model(device, **cfg)
    fresh.load_state_dict(restored)
    fresh_logits = torch.cat([T.make_fusion_eval_step(fresh)(b)[1]
                              for b in test_batches])
    err = float((fresh_logits - saved_logits).abs().max())
    print(f"checkpoint {Path(path).name}: restored logits vs saved model's: "
          f"max_abs_err {err:.3e} (must be 0)")
    if not torch.equal(fresh_logits, saved_logits):
        raise AssertionError("restored model's logits differ")

    # fold BN, the kernel-path test pass (float32, as the CLI folds)
    folded = empty_model(device, **cfg, backbone_bn_folded=True,
                         backbone_pallas_serving=True)
    folded.load_state_dict(fold_fusion_params(restored,
                                              backbone="efficientnet-b3"))
    fd.dw_silu_pool.launches = fd.expand_dw_silu_pool.launches = 0
    acc, _ = T.evaluate_test(T.make_fusion_eval_step(folded), test_batches)
    fused = (fd.dw_silu_pool.launches, fd.expand_dw_silu_pool.launches)
    n_fw = len(test_batches)
    print(f"test pass, folded f32 kernel path: {len(test_dev['target'])} "
          f"requests, accuracy {acc:.5f}; fused launches {fused} over "
          f"{n_fw} forwards")
    if fused != (2 * n_fw, 20 * n_fw):
        raise AssertionError(f"fused launches {fused} != (2, 20) x {n_fw}")
    folded_logits = torch.cat([T.make_fusion_eval_step(folded)(b)[1]
                               for b in test_batches])
    err = float((folded_logits - saved_logits).abs().max())
    print(f"folded kernel path vs unfolded: max_abs_err {err:.3e} "
          f"(tolerance {LOGIT_TOL_FOLDED_F32})")
    torch.testing.assert_close(folded_logits, saved_logits,
                               **LOGIT_TOL_FOLDED_F32)
    return launches, train_ds


def learning_evidence(device, train_ds):
    """20 SGD steps on one fixed batch of 16, no augmentation, the same
    dropout masks every step: the loss must fall."""
    from multimodal_isic_tpu_torch.core.rng import generator
    from multimodal_isic_tpu_torch.data.augment import preprocess_eval_batch
    from multimodal_isic_tpu_torch.train import fusion as T
    model = T.build_fusion(generator(SEED + 3, device),
                           backbone="efficientnet-b3",
                           radiomics_dim=RADIOMICS_DIM,
                           fusion_strategy="concat")
    step = T.make_fusion_train_step(model, T.fusion_optimizer(model))
    batch = {k: v[:BATCH] for k, v in train_ds.meta.items()}
    batch["image"] = preprocess_eval_batch(train_ds.images[:BATCH], (IMG, IMG))
    losses = [float(step(batch, generator(SEED + 4, device))[0])
              for _ in range(LEARN_STEPS)]
    print(f"fixed batch of {BATCH}, {LEARN_STEPS} steps, loss per step: "
          + " ".join(f"{v:.4f}" for v in losses))
    if not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall on a fixed batch")
    return losses


KERNEL_FAMILIES = (  # (label, substrings of the kernel name), first match
    ("fused LN-MLP backward kernels", ("ln_mlp_bwd",)),
    ("fused LN-MLP kernel", ("fused_ln_mlp",)),
    ("attention kernel", ("flash_attention",)),
    ("fused front kernel", ("fused_front",)),
    ("warp kernel", ("affine_warp",)),
    ("GLCM kernel", ("glcm_counts",)),
    ("GLRLM runs kernels", ("runs_rows", "runs_lines")),
    ("joint histogram kernel", ("joint_hist",)),
    ("connected-components kernels", ("cc_init", "cc_merge", "cc_compress")),
    ("sorts", ("sort", "radix")),
    ("scatters, index_add", ("scatter", "index_add", "indexfunc")),
    ("fused MBConv kernels", ("mbconv",)),
    ("convolutions and GEMMs", ("conv", "gemm", "xmma", "cutlass", "sm90",
                                "wgrad", "dgrad")),
    ("batch norm", ("batch_norm", "bn_")),
    ("softmax", ("softmax",)),
    ("reductions", ("reduce",)),
    ("gathers, copies, pads", ("index", "gather", "copy", "cat", "pad",
                               "flip")),
    ("elementwise", ("elementwise", "vectorized")),
)


def profile_steps(fn, label, steps=3):
    """torch.profiler over ``steps`` calls after a warm-up: the device's
    busy share of the window (kernel time summed on the one stream over the
    host-clock window) and the kernel time by family, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    fams = {}
    for e in kernels:
        name = e.name.lower()
        fam = next((lab for lab, keys in KERNEL_FAMILIES
                    if any(k in name for k in keys)), "other")
        fams[fam] = fams.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3
    print(f"profile {label}: per call wall {wall / steps:.2f} ms, device "
          f"kernels {busy / steps:.2f} ms ({len(kernels) / steps:.0f} "
          f"launches), busy share {busy / wall:.3f}; by family: "
          + ", ".join(f"{k} {v / steps:.2f} ms"
                      for k, v in sorted(fams.items(), key=lambda kv: -kv[1])))


def time_training(device, train_ds):
    """Warp kernel vs plain vs grid_sample at bs 16 and 128, the fast policy
    per batch, and the train step in img/s: bs 16 float32, bs 128 with a
    bf16 backbone."""
    from multimodal_isic_tpu_torch.core.rng import generator
    from multimodal_isic_tpu_torch.data.augment import (make_fusion_train_fast,
                                                        resize_bilinear_mxu,
                                                        ssr_draw, ssr_inverse)
    from multimodal_isic_tpu_torch.ops import affine_warp as aw
    from multimodal_isic_tpu_torch.train import fusion as T
    from multimodal_isic_tpu_torch.utils.profiling import timeit_closed

    g = generator(SEED + 5, device)
    n = len(train_ds)
    warp = {}
    for bsz in (BATCH, LARGE_BATCH):
        idx = torch.arange(bsz, device=device) % n
        imgs = resize_bilinear_mxu(train_ds.images[idx], (IMG, IMG)).contiguous()
        d = ssr_draw(g, bsz, p=1.0)
        inv = ssr_inverse(IMG, IMG, d["dx"], d["dy"], d["scale"], d["angle"])
        fns = {"kernel": lambda: aw.affine_warp_batch(imgs, inv, (IMG, IMG)),
               "plain": lambda: aw.affine_warp_batch_reference(imgs, inv,
                                                               (IMG, IMG)),
               "grid_sample": lambda: aw.affine_warp_grid_sample(imgs, inv,
                                                                 (IMG, IMG))}
        t = {k: [] for k in fns}
        for name in ("plain", "grid_sample", "kernel", "kernel", "grid_sample",
                     "plain"):
            t[name].append(timeit_closed(fns[name], iters=20, repeats=5))
        med = {k: min(r["median"] for r in v) * 1e3 for k, v in t.items()}
        b_bytes, b_ops = warp_bound_ms(bsz, IMG, IMG, 3, (IMG, IMG))
        warp[bsz] = (med, max(b_bytes, b_ops), b_bytes, b_ops)
        print(f"time warp bs{bsz} {IMG}² C3 f32: kernel {med['kernel']:.4f} "
              f"ms, plain {med['plain']:.4f} ms, grid_sample "
              f"{med['grid_sample']:.4f} ms; bound {max(b_bytes, b_ops):.4f} "
              f"ms (bytes {b_bytes:.4f}, operations {b_ops:.4f}): "
              f"{max(b_bytes, b_ops) / med['kernel']:.1%} of it")

    policy = make_fusion_train_fast((IMG, IMG))
    for bsz, dtype in ((BATCH, torch.float32), (LARGE_BATCH, torch.bfloat16)):
        idx = torch.arange(bsz, device=device) % n
        images = train_ds.images[idx]
        batch = {k: v[idx] for k, v in train_ds.meta.items()}
        t_pol = timeit_closed(lambda: policy(images, None, g), iters=10,
                              repeats=5)
        model = T.build_fusion(generator(SEED + 6, device),
                               backbone="efficientnet-b3",
                               radiomics_dim=RADIOMICS_DIM,
                               fusion_strategy="concat", dtype=dtype)
        step = T.make_fusion_train_step(model, T.fusion_optimizer(model))

        def train_step():
            batch["image"] = policy(images, None, g)[0]
            return step(batch, g)

        torch.cuda.reset_peak_memory_stats()
        iters = 5 if bsz == BATCH else 2
        t_step = timeit_closed(train_step, iters=iters, repeats=3, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"train step bs{bsz} ({str(dtype)[6:]} backbone, fast augment "
              f"+ forward + backward + SGD): {bsz / t_step['median']:.1f} "
              f"img/s (median, best {bsz / t_step['best']:.1f}); fast policy "
              f"alone {t_pol['median'] * 1e3:.3f} ms per batch (best "
              f"{t_pol['best'] * 1e3:.3f}); peak device memory {peak:.2f} GiB")
        profile_steps(train_step, f"train step bs{bsz} {str(dtype)[6:]}")
        del model, step
        torch.cuda.empty_cache()
    return warp


# ----------------------------------------------------------------- radiomics

def radiomics_samples(n: int = RAD_N, seed: int = SEED + 7):
    """n rendered 450×600 lesions (uint8 RGB) and their masks (255 inside)."""
    from multimodal_isic_tpu_torch.data.synthetic import (DX_CLASSES,
                                                          _render_sample)
    rng = np.random.RandomState(seed)
    imgs, masks = zip(*[_render_sample(rng, *SRC_HW, i % len(DX_CLASSES))
                        for i in range(n)])
    return np.stack(imgs), np.stack(masks)


def _rad_fns():
    """name → (wrapper module, kernel wrapper, plain version)."""
    from multimodal_isic_tpu_torch.ops import connected_components as C
    from multimodal_isic_tpu_torch.ops import glcm as G
    from multimodal_isic_tpu_torch.ops import glrlm_runs as R
    from multimodal_isic_tpu_torch.ops import histogram as Hm
    return {"glcm_matrices": (G.glcm_matrices, G.glcm_matrices_reference),
            "glrlm_runs": (R.glrlm_runs, R.glrlm_runs_reference),
            "joint_histogram": (Hm.joint_histogram,
                                Hm.joint_histogram_reference),
            "connected_components": (C.connected_components,
                                     C.connected_components_reference)}


def _run_codes(packed, max_len=MAX_LEN):
    """Packed runs [M, 4, H, W] → the GLRLM histogram's (gray, length) code
    rows [M·4, H·W], as ``texture.glrlm_matrices`` builds them."""
    from multimodal_isic_tpu_torch.ops.glrlm_runs import unpack_runs
    start, gray, length = unpack_runs(packed)
    m, _, h, w = packed.shape
    g = torch.where(start, gray, 0).reshape(m * 4, h * w)
    ln = torch.where(start, length.clamp(1, max_len), 0).reshape(m * 4, h * w)
    return g, ln


def _rad_chunk_levels(device, rgb, masks, types=RAD_CHECK_TYPES):
    """The chunk's [M, H, W] levels and masks for the derived images
    ``types``, as the extractor computes them."""
    from multimodal_isic_tpu_torch.analysis.radiomics import RadiomicsExtractor
    from multimodal_isic_tpu_torch.ops import filters as FB
    from multimodal_isic_tpu_torch.ops import texture as T
    ex = RadiomicsExtractor(device=device)
    chans, m4, _ = ex._prep(torch.from_numpy(rgb).to(device),
                            torch.from_numpy(masks).to(device))
    bank = FB.filter_bank(chans)
    return {t: (T.discretize(bank[t], m4, 10.0)[0], m4) for t in types}


def _rad_edge_cases(device, h=SRC_HW[0], w=SRC_HW[1]):
    """Full-frame edge maps: an empty mask, a full frame of random levels,
    one gray level over the whole frame (600-px runs), the serpentine."""
    g = torch.Generator(device=device).manual_seed(SEED + 8)
    rand = torch.randint(1, 7, (h, w), generator=g, device=device,
                         dtype=torch.int32)
    snake = torch.zeros((h, w), dtype=torch.bool, device=device)
    snake[0::2] = True
    for r in range(1, h, 2):
        snake[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    levels = torch.stack([torch.zeros_like(rand), rand, torch.ones_like(rand),
                          torch.where(snake, 7, 2).to(torch.int32)])
    mask = torch.full((4, h, w), 255, dtype=torch.uint8, device=device)
    mask[0] = 0
    return levels, mask


def check_radiomics_kernels(device, rgb, masks):
    """Each radiomics kernel against its plain version, bit for bit: on a
    real chunk's derived images (M = 64 maps of 450×600: original, LoG σ 3,
    wavelet-HH) and on the full-frame edge cases (empty mask, full frame,
    single level, a run longer than the histogram's length range, the
    serpentine) → worst |kernel − plain| per kernel (must be 0)."""
    fns = _rad_fns()
    cases = dict(_rad_chunk_levels(device, rgb, masks))
    cases["edge cases"] = _rad_edge_cases(device)
    worst = {k: 0.0 for k in RAD_KERNELS}
    failures = []
    for label, (levels, m) in cases.items():
        inside = m > 0
        outs = {}
        for name, args in (("glcm_matrices", (levels, m)),
                           ("glrlm_runs", (levels, inside)),
                           ("connected_components", (levels, inside))):
            outs[name] = [fn(*args) for fn in fns[name]]
        hist_cases = [(*_run_codes(outs["glrlm_runs"][0]), NG, MAX_LEN)]
        if label == "edge cases":  # 600-px runs beyond a 512-bin range
            hist_cases.append((*_run_codes(outs["glrlm_runs"][0], 512), NG,
                               512))
        for codes in hist_cases:
            outs.setdefault("joint_histogram", []).extend(
                fn(*codes) for fn in fns["joint_histogram"])
        torch.cuda.synchronize()
        for name, vals in outs.items():
            for got, want in zip(vals[0::2], vals[1::2]):
                err = float((got.double() - want.double()).abs().max())
                worst[name] = max(worst[name], err)
                if not torch.equal(got, want):
                    failures.append(f"{name} on {label}")
        print(f"check radiomics kernels, {label} {tuple(levels.shape)}: "
              + ", ".join(f"{k} {worst[k]:.0f}" for k in RAD_KERNELS))
    levels, _ = cases["edge cases"]
    snake = outs["connected_components"][0][3][levels[3] == 7]
    if snake.unique().numel() != 1:
        failures.append("the serpentine is not one zone")
    if failures:
        raise AssertionError(f"radiomics kernel != plain: {failures}")
    return worst


def _feature_err(got, want):
    """|got − want|, 0 where both are the same infinity (an empty ROI's
    Range is −inf on every path, as in the JAX package)."""
    with np.errstate(invalid="ignore"):
        return np.where(got == want, 0.0, np.abs(got - want))


def _frame_checks(cols, vals, results):
    if len(cols) != 4872 or vals.shape[1] != 4872:
        raise AssertionError(f"{len(cols)} columns, {vals.shape}")
    for res in results:
        for k, v in res["grayscale"].items():
            if "_shape2D_" in k and any(res[ch][k] != v for ch in res):
                raise AssertionError(f"shape2D {k} differs across channels")


def radiomics_path(device, rgb, masks):
    """The extraction path: RAD_N samples in chunks of RAD_CHUNK on the
    kernel path, with the launch counts; the plain path on the same images
    (NaNs at the same places, every feature within RAD_TOL); and a small
    input on the card against the plain path on the CPU."""
    from multimodal_isic_tpu_torch.analysis.radiomics import (
        RadiomicsExtractor, features_to_frame)
    fns = _rad_fns()
    ex = RadiomicsExtractor(batch=RAD_CHUNK, device=device)
    ex.extract_batches(rgb[:2], masks[:2])  # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    for name in RAD_KERNELS:
        fns[name][0].launches = 0
    t0 = time.perf_counter()
    results = ex.extract_batches(rgb, masks)
    wall = time.perf_counter() - t0
    launches = {name: fns[name][0].launches for name in RAD_KERNELS}
    n_chunks = -(-len(rgb) // RAD_CHUNK)
    cols, vals = features_to_frame(results)
    print(f"radiomics: {len(rgb)} rendered {SRC_HW[0]}x{SRC_HW[1]} images in "
          f"{n_chunks} chunks of {RAD_CHUNK} (kernel path): {len(cols)} "
          f"columns in {wall:.1f} s; kernel launches {launches} (13 derived "
          f"images x {n_chunks} chunks); NaN features "
          f"{int(np.isnan(vals).sum())} of {vals.size}")
    _frame_checks(cols, vals, results)
    if any(v != 13 * n_chunks for v in launches.values()):
        raise AssertionError(f"launches {launches} != 13 x {n_chunks}")

    plain = RadiomicsExtractor(batch=RAD_CHUNK, use_kernels=False,
                               device=device)
    p_cols, p_vals = features_to_frame(plain.extract_batches(rgb, masks))
    if p_cols != cols:
        raise AssertionError("plain path columns differ")
    nan_k, nan_p = np.isnan(vals), np.isnan(p_vals)
    if not np.array_equal(nan_k, nan_p):
        raise AssertionError("kernel and plain paths put NaNs in other places")
    ok = ~nan_p
    err = _feature_err(vals[ok], p_vals[ok])
    lim = RAD_TOL["atol"] + RAD_TOL["rtol"] * np.abs(p_vals[ok])
    n_bad = int((err > lim).sum())
    print(f"radiomics kernel path vs plain path: max_abs_err {err.max():.3e}, "
          f"{int((err > 0).sum())} of {err.size} values differ at all, "
          f"{n_bad} outside {RAD_TOL}")
    if n_bad:
        worst = np.argsort(-(err - lim))[:5]
        flat = np.flatnonzero(ok)
        raise AssertionError("kernel vs plain features: " + str(
            [(cols[flat[i] % 4872], vals[ok][i], p_vals[ok][i]) for i in worst]))

    cy, cx = rgb.shape[1] // 2, rgb.shape[2] // 2  # lesions centre mid-frame
    crop = (slice(0, 2), slice(cy - 32, cy + 32), slice(cx - 40, cx + 40))
    small = (rgb[crop].copy(), masks[crop].copy())
    small[1][1] = 0  # an empty mask: NaN percentiles, degenerate classes
    cuda_v = features_to_frame(RadiomicsExtractor(device=device)
                               .extract_channels_batch(*small))[1]
    cpu_v = features_to_frame(RadiomicsExtractor(use_kernels=False,
                                                 device="cpu")
                              .extract_channels_batch(*small))[1]
    same_nan = np.array_equal(np.isnan(cuda_v), np.isnan(cpu_v))
    ok = ~np.isnan(cpu_v)
    err = _feature_err(cuda_v[ok], cpu_v[ok])
    n_bad = int((err > RAD_CPU_TOL["atol"]
                 + RAD_CPU_TOL["rtol"] * np.abs(cpu_v[ok])).sum())
    print(f"radiomics 2 x 64x80 crops, card kernel path vs CPU plain path: "
          f"max_abs_err {err.max():.3e}, {n_bad} values outside "
          f"{RAD_CPU_TOL}, NaNs at the same places: {same_nan}")
    if n_bad or not same_nan:
        raise AssertionError("card vs CPU radiomics features differ")
    return launches


def rad_bound_ms(name, m, h, w):
    """(bytes ms, operations ms) of one call at M maps of H×W: inputs read
    once, outputs written once (int32 levels, 1-byte masks, int32 codes and
    labels, float32 histograms); about 10 32-bit integer operations per
    element, counted at the float32 CUDA-core rate."""
    px = m * h * w
    nbytes = {"glcm_matrices": px * 5 + m * 4 * NG * NG * 4,
              "glrlm_runs": px * 5 + px * 4 * 4,
              "joint_histogram": 4 * px * 8 + 4 * m * NG * MAX_LEN * 4,
              "connected_components": px * 5 + px * 4}[name]
    elems = 4 * px if name in ("glrlm_runs", "joint_histogram") else px
    return nbytes / HBM_BPS * 1e3, 10 * elems / F32_FLOPS * 1e3


def time_radiomics(device, rgb, masks):
    """Each radiomics kernel at the path's shapes (one chunk's original
    image: M = 64 maps of 450×600) against its plain version and, where one
    PyTorch call computes the same function, that call (torch.bincount over
    the packed keys of the counted pairs, the keys built inside the timed
    call); then extraction
    img/s on the kernel and plain paths, peak device memory, and a profile
    of one chunk by kernel family."""
    from multimodal_isic_tpu_torch.analysis.radiomics import RadiomicsExtractor
    from multimodal_isic_tpu_torch.ops import histogram as Hm
    from multimodal_isic_tpu_torch.ops.texture import ANGLES_2D, shift2d
    from multimodal_isic_tpu_torch.utils.profiling import timeit_closed
    fns = _rad_fns()
    levels, m4 = _rad_chunk_levels(device, rgb[:RAD_CHUNK],
                                   masks[:RAD_CHUNK], ("original",))["original"]
    inside = m4 > 0
    m, h, w = levels.shape
    codes = _run_codes(fns["glrlm_runs"][0](levels, inside))

    def glcm_bincount():
        lv = torch.where(inside, levels, 0)
        base = (torch.arange(m, device=device) * 4 * NG * NG).view(m, 1, 1)
        keys = []
        for a, (dy, dx) in enumerate(ANGLES_2D):
            nbr = shift2d(lv, -dy, -dx, 0)
            ok = (lv > 0) & (nbr > 0)
            keys.append((base + (a * NG + lv - 1) * NG + nbr - 1)[ok])
        p = torch.bincount(torch.cat(keys), minlength=m * 4 * NG * NG)
        p = p.view(m, 4, NG, NG)
        return (p + p.transpose(-1, -2)).float()

    args = {"glcm_matrices": (levels, m4), "glrlm_runs": (levels, inside),
            "joint_histogram": (*codes, NG, MAX_LEN),
            "connected_components": (levels, inside)}
    library = {"glcm_matrices": glcm_bincount,
               "joint_histogram": lambda: Hm.library_joint_histogram(
                   *codes, NG, MAX_LEN)}
    out = {}
    for name in RAD_KERNELS:
        kern, ref = fns[name]
        runs = {"kernel": [], "plain": [], "library": []}
        order = ["plain", "kernel", "kernel", "plain"]
        if name in library:
            order += ["library", "library"]
        for which in order:
            fn = {"kernel": lambda: kern(*args[name]),
                  "plain": lambda: ref(*args[name]),
                  "library": library.get(name)}[which]
            iters = 20 if which == "kernel" else 3
            runs[which].append(timeit_closed(fn, iters=iters, repeats=3))
        med = {k: min(r["median"] for r in v) * 1e3 for k, v in runs.items() if v}
        b_bytes, b_ops = rad_bound_ms(name, m, h, w)
        bound = max(b_bytes, b_ops)
        out[name] = (med["kernel"], med["plain"], bound, b_bytes, b_ops,
                     med.get("library"))
        lib = (f", library {med['library']:.4f} ms" if "library" in med
               else ", library none")
        print(f"time {name} M{m} {h}x{w}: kernel {med['kernel']:.4f} ms, "
              f"plain {med['plain']:.4f} ms ({med['plain'] / med['kernel']:.1f}x)"
              f"{lib}; bound {bound:.4f} ms (bytes {b_bytes:.4f}, operations "
              f"{b_ops:.4f}): {bound / med['kernel']:.1%} of it")

    chunk = (rgb[:RAD_CHUNK], masks[:RAD_CHUNK])
    exs = {"kernel": RadiomicsExtractor(device=device),
           "plain": RadiomicsExtractor(use_kernels=False, device=device)}
    t = {"kernel": [], "plain": []}
    peak = {}
    for which in ("plain", "kernel", "kernel", "plain"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t[which].append(timeit_closed(lambda: exs[which]._extract(*chunk),
                                      iters=1, repeats=3))
        peak[which] = torch.cuda.max_memory_allocated() / 2**30
    for which, runs in t.items():
        secs = [s for r in runs for s in r["all"]]
        print(f"radiomics extraction, {which} path, chunks of {RAD_CHUNK} "
              f"images {SRC_HW[0]}x{SRC_HW[1]}: "
              f"{RAD_CHUNK / float(np.median(secs)):.2f} img/s (median of "
              f"{len(secs)} chunks, best {RAD_CHUNK / min(secs):.2f}); "
              f"{float(np.median(secs)):.3f} s per chunk; peak device memory "
              f"{peak[which]:.2f} GiB")
    for which in ("kernel", "plain"):
        profile_steps(lambda: exs[which]._extract(*chunk),
                      f"radiomics chunk of {RAD_CHUNK}, {which} path", steps=1)
    return out


# ------------------------------------------------------------------- ConvMAE

def mae_samples(n: int = LAT_N, seed: int = SEED + 20):
    """n rendered 450×600 lesions, centroid-cropped to 450² (uint8 RGB) with
    their masks."""
    from multimodal_isic_tpu_torch.data.crop import centroid_crop
    from multimodal_isic_tpu_torch.data.synthetic import (DX_CLASSES,
                                                          _render_sample)
    rng = np.random.RandomState(seed)
    crops, masks = [], []
    for i in range(n):
        crop, mask = centroid_crop(*_render_sample(rng, *SRC_HW,
                                                   i % len(DX_CLASSES)))
        crops.append(crop)
        masks.append(mask)
    return np.stack(crops), np.stack(masks), np.arange(n) % len(DX_CLASSES)


def _mae_ops():
    from multimodal_isic_tpu_torch.ops import attention as A
    from multimodal_isic_tpu_torch.ops import fused_convblock as FC
    from multimodal_isic_tpu_torch.ops import fused_mlp as FM
    return {"fused_ln_mlp": FM, "flash_attention": A, "fused_front": FC}


def _mae_fns():
    """name → (kernel wrapper, plain version)."""
    return {name: (getattr(mod, name), getattr(mod, f"{name}_reference"))
            for name, mod in _mae_ops().items()}


def _mae_tol():
    """name → dtype → (atol, rtol) of kernel vs plain: the ops modules'
    ``TOL`` tables, which the card tests use too."""
    return {name: mod.TOL for name, mod in _mae_ops().items()}


def _mae_launches():
    return {name: fn.launches for name, (fn, _) in _mae_fns().items()}


def _reset_mae_launches():
    for fn, _ in _mae_fns().values():
        fn.launches = 0


def _mae_inputs(name, geo, dtype, device, g):
    """Arguments as the ConvMAE blocks pass them, at one geometry:
    fused_ln_mlp (B, H, C), flash_attention (B, heads, N, D),
    fused_front (B, H, C, with_keep)."""
    rn = lambda *s: torch.randn(*s, generator=g, device=device)
    if name == "flash_attention":
        b, h, n, d = geo
        qkv = (rn(b, n, 3, h, d) * 1.5).to(dtype)  # views of the projection
        return tuple(t.transpose(1, 2) for t in qkv.unbind(2))
    b, hw, c = geo[:3]
    f = 4 * c if name == "fused_ln_mlp" else c
    x = (rn(b, hw, hw, c) * 2 + 0.5).to(dtype)
    ls, lb = 1 + 0.1 * rn(c), 0.1 * rn(c)
    w1, b1 = (rn(c, f) / math.sqrt(c)).to(dtype), (0.1 * rn(f)).to(dtype)
    w2, b2 = (rn(f, c) / math.sqrt(f)).to(dtype), (0.1 * rn(c)).to(dtype)
    if name == "fused_ln_mlp":
        return (x.reshape(-1, c), ls, lb, w1, b1, w2, b2)
    wd, bd = (rn(5, 5, c) / 5).to(dtype), (0.1 * rn(c)).to(dtype)
    keep = None
    if geo[3]:  # the 0.75 mask at the 14² grid, upsampled to the stage grid
        keep = (torch.rand(b, 14, 14, 1, generator=g, device=device) > 0.75)
        keep = keep.repeat_interleave(hw // 14, 1).repeat_interleave(
            hw // 14, 2).to(dtype)
    return (x, ls.to(dtype), lb.to(dtype), w1, b1, wd, bd, w2, b2, keep)


def mae_geometries():
    """(kernel, dtype, geometry) of every call the two ConvMAE paths make:
    latent extraction at bs 128 bf16 (encoder N 196), the validation
    forward at bs 16 float32 (encoder N 49 at mask 0.75, decoder D 32, the
    conv stages with ``keep``)."""
    bf, f32 = torch.bfloat16, torch.float32
    lb, vb = LAT_BATCH, VAL_BATCH
    return [("fused_ln_mlp", bf, (lb, 56, 256)), ("fused_ln_mlp", bf, (lb, 28, 384)),
            ("fused_ln_mlp", f32, (vb, 56, 256)), ("fused_ln_mlp", f32, (vb, 28, 384)),
            ("flash_attention", bf, (lb, 12, 196, 64)),
            ("flash_attention", f32, (vb, 12, 49, 64)),
            ("flash_attention", f32, (vb, 16, 196, 32)),
            ("fused_front", bf, (lb, 56, 256, False)),
            ("fused_front", bf, (lb, 28, 384, False)),
            ("fused_front", f32, (vb, 56, 256, True)),
            ("fused_front", f32, (vb, 28, 384, True)),
            ("fused_front", f32, (vb, 56, 256, False))]


def check_mae_kernels(device):
    """Each ConvMAE kernel against its plain version at every geometry of
    the slice → worst max |kernel − plain| per kernel."""
    fns, tol = _mae_fns(), _mae_tol()
    g = torch.Generator(device=device).manual_seed(SEED + 21)
    print("ConvMAE kernel vs plain tolerance, |err| <= atol + rtol*|plain|, "
          "(atol, rtol): " + "; ".join(
              f"{k} {str(dt)[6:]} {t}" for k, v in tol.items()
              for dt, t in v.items()))
    worst = {name: 0.0 for name in MAE_KERNELS}
    failures = []
    for name, dtype, geo in mae_geometries():
        args = _mae_inputs(name, geo, dtype, device, g)
        fn, ref = fns[name]
        got = fn(*args)
        want = ref(*args)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == dtype
        err, ok = _allclose_err(got, want, *tol[name][dtype])
        worst[name] = max(worst[name], err)
        label = f"{name} {geo} {str(dtype)[6:]}"
        print(f"check {label}: max_abs_err {err:.3e} ({'ok' if ok else 'FAIL'})")
        if not ok:
            failures.append(label)
        del args, got, want
    if failures:
        raise AssertionError(f"ConvMAE kernels vs plain: {failures}")
    return worst


def mae_models(device, seed, **cfg):
    """ConvMAE models with one set of seeded random weights, one per flag
    set in ``cfg['variants']`` (name → flags)."""
    from multimodal_isic_tpu_torch.core.rng import generator
    from multimodal_isic_tpu_torch.models.convmae import ConvMAE, build_convmae
    variants = cfg.pop("variants")
    first = None
    out = {}
    for name, flags in variants.items():
        if first is None:
            out[name] = first = build_convmae(generator(seed, device),
                                              **cfg, **flags)
            continue
        with torch.device("meta"):
            model = ConvMAE(**cfg, **flags)
        model.to_empty(device=device).load_state_dict(first.state_dict())
        out[name] = model
    return {k: m.eval() for k, m in out.items()}


LAT_VARIANTS = {"kernel": dict(use_fused_mlp=True),
                "plain": dict(use_fused_mlp=False),
                "flash+front": dict(use_fused_mlp=True,
                                    use_flash_attention=True,
                                    use_fused_front=True)}
ALL_FLAGS = dict(use_fused_mlp=True, use_flash_attention=True,
                 use_fused_front=True)


def _latent_err(got, want):
    """(max |err|, relative RMS error) of two latent tensors."""
    e = (got.float() - want.float())
    return (float(e.abs().max()),
            float(e.pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt()))


def latent_path(device, crops, masks, targets):
    """Latent extraction at ConvViT-Base width, bs 128 bf16: uint8 crops →
    ``mae_eval_batch`` → encoder → bundles → patch tables → patch moments →
    PCA(0.90), on the usual kernel path (fused LN-MLP), then the plain path
    and the flash + front configuration on the same weights and images."""
    from multimodal_isic_tpu_torch.analysis.latent_pipeline import (
        extract_latent_bundle, extract_latents)
    from multimodal_isic_tpu_torch.analysis.latents import concat_patch_moments
    from multimodal_isic_tpu_torch.data.augment import mae_eval_batch
    models = mae_models(device, SEED + 22, with_decoder=False,
                        dtype=torch.bfloat16, variants=LAT_VARIANTS)
    imgs = torch.from_numpy(crops).to(device)
    msks = torch.from_numpy(masks).to(device)
    tgts = torch.from_numpy(targets).to(device)
    half = len(crops) // 2

    def loader(lo, hi):
        for s in range(lo, hi, LAT_BATCH):
            img, msk = mae_eval_batch(imgs[s:s + LAT_BATCH],
                                      msks[s:s + LAT_BATCH])
            yield {"image": img, "mask": msk, "target": tgts[s:s + LAT_BATCH]}

    n_fw = -(-half // LAT_BATCH) + -(-(len(crops) - half) // LAT_BATCH)
    extract_latent_bundle(models["kernel"], loader(0, LAT_BATCH))  # warm-up
    torch.cuda.synchronize()
    _reset_mae_launches()
    t0 = time.perf_counter()
    tr, te, b_tr, b_te, pca = extract_latents(
        models["kernel"], loader(0, half), loader(half, len(crops)),
        pca_enabled=True)
    moments = concat_patch_moments(torch.cat([b_tr.latents, b_te.latents]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _mae_launches()
    print(f"latents: {len(crops)} rendered {SRC_HW[0]}x{SRC_HW[1]} lesions "
          f"(450² crops) in batches of {LAT_BATCH}, bf16 kernel path: train "
          f"{tuple(b_tr.latents.shape)}, test {tuple(b_te.latents.shape)}, "
          f"{int(tr['patch_in_mask'].sum())} + {int(te['patch_in_mask'].sum())}"
          f" lesion patches, moments {tuple(moments.shape)}, PCA(0.90) keeps "
          f"{pca.components.shape[0]} of 768 components; {wall:.2f} s; "
          f"launches {launches} over {n_fw} forwards")
    want = {"fused_ln_mlp": 4 * n_fw, "flash_attention": 0, "fused_front": 0}
    if launches != want:
        raise AssertionError(f"latent launches {launches} != {want}")
    lat = torch.cat([b_tr.latents, b_te.latents])
    if lat.shape != (len(crops), 196, 768) or tr["patch_latent_pca"].shape[1] \
            != pca.components.shape[0]:
        raise AssertionError(f"latent shapes {tuple(lat.shape)}")
    for name, t in (("latents", lat), ("moments", moments),
                    ("pca", tr["patch_latent_pca"])):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite {name}")

    def run(model):
        return torch.cat([extract_latent_bundle(model, loader(0, half)).latents,
                          extract_latent_bundle(
                              model, loader(half, len(crops))).latents])

    plain = run(models["plain"])
    _reset_mae_launches()
    flash_front = run(models["flash+front"])
    launches_ff = _mae_launches()
    want_ff = {"fused_ln_mlp": 4 * n_fw, "flash_attention": 11 * n_fw,
               "fused_front": 4 * n_fw}
    print(f"latents, flash + front configuration: launches {launches_ff} over "
          f"{n_fw} forwards")
    if launches_ff != want_ff:
        raise AssertionError(f"flash+front launches {launches_ff} != {want_ff}")
    for label, got, ref in (("kernel path vs plain path", lat, plain),
                            ("flash + front vs kernel path", flash_front, lat)):
        mx, rel = _latent_err(got, ref)
        ok = mx <= LATENT_TOL["max_abs"] and rel <= LATENT_TOL["rel_rms"]
        print(f"latents {label}: max_abs_err {mx:.4f}, relative RMS "
              f"{rel:.5f} (|latent| max {float(ref.abs().max()):.3f}; "
              f"tolerance {LATENT_TOL}) ({'ok' if ok else 'FAIL'})")
        if not ok:
            raise AssertionError(f"latents {label} out of tolerance")
    del models
    return launches_ff


def mae_validation(device, crops, masks):
    """The masked validation forward: the full model with its decoder in
    float32 at bs 16, mask 0.75, norm-pix loss, all three kernels on and
    all off, on one set of masking draws."""
    from multimodal_isic_tpu_torch.core.rng import generator
    from multimodal_isic_tpu_torch.data.augment import mae_eval_batch
    from multimodal_isic_tpu_torch.train.mae import (
        make_mae_eval_persample_step, make_mae_eval_step)
    models = mae_models(device, SEED + 23, norm_pix_loss=True,
                        variants={"kernel": ALL_FLAGS, "plain": {}})
    imgs, _ = mae_eval_batch(torch.from_numpy(crops[:VAL_BATCH]).to(device),
                             torch.from_numpy(masks[:VAL_BATCH]).to(device))
    draws = models["kernel"].masking(VAL_BATCH, MASK_RATIO,
                                     generator(SEED + 24, device))
    out = {}
    for name, model in models.items():
        _reset_mae_launches()
        loss = make_mae_eval_step(model, MASK_RATIO)(imgs, masking=draws)
        per = make_mae_eval_persample_step(model, MASK_RATIO)(imgs,
                                                              masking=draws)
        out[name] = (float(loss), per.cpu(), _mae_launches())
    loss, per, launches = out["kernel"]
    print(f"MAE validation forward, bs {VAL_BATCH} f32, mask {MASK_RATIO}, "
          f"norm-pix: kernel path loss {loss:.6f}, plain path "
          f"{out['plain'][0]:.6f}; per-sample mean {float(per.mean()):.6f}; "
          f"kernel launches {launches} over 2 forwards (scalar and "
          f"per-sample steps)")
    want = {"fused_ln_mlp": 8, "flash_attention": 2 * (11 + 8),
            "fused_front": 8}
    if launches != want:
        raise AssertionError(f"validation launches {launches} != {want}")
    if not (math.isfinite(loss) and bool(torch.isfinite(per).all())):
        raise AssertionError("non-finite validation loss")
    if abs(float(per.mean()) - loss) > 1e-5 * abs(loss):
        raise AssertionError("scalar loss != mean of per-sample losses")
    err = float((per - out["plain"][1]).abs().max())
    print(f"validation kernel vs plain: |loss diff| "
          f"{abs(loss - out['plain'][0]):.3e}, per-sample max_abs_err "
          f"{err:.3e} (tolerance {VAL_TOL})")
    torch.testing.assert_close(per, out["plain"][1], **VAL_TOL)
    torch.testing.assert_close(torch.tensor(loss),
                               torch.tensor(out["plain"][0]), **VAL_TOL)
    return imgs, draws


def mae_bound_ms(name, dtype, geo):
    """(bytes ms, operations ms) of one call: inputs read once, outputs
    written once; each product at the card's rate for its operands' type
    (:func:`ops_ms`): products of bf16 operands on the tensor cores, float32
    products (TF32 off), the depthwise taps and attention's p·v (p is
    float32) on the CUDA cores."""
    bf = dtype == torch.bfloat16
    esz = 2 if bf else 4
    if name == "flash_attention":
        b, h, n, d = geo
        qk = pv = 2 * b * h * n * n * d
        return (4 * b * h * n * d * esz / HBM_BPS * 1e3,
                ops_ms(bf16=qk, f32=pv) if bf else ops_ms(f32=qk + pv))
    b, hw, c = geo[:3]
    m = b * hw * hw
    if name == "fused_ln_mlp":
        f = 4 * c
        nbytes = 2 * m * c * esz + 2 * c * f * esz + (3 * c + f) * 4
        mm = 4 * m * c * f
        return (nbytes / HBM_BPS * 1e3,
                ops_ms(bf16=mm) if bf else ops_ms(f32=mm))
    nbytes = (2 * m * c * esz + 2 * c * c * esz + 30 * c * 4
              + (m * 4 if geo[3] else 0))
    mm, taps = 4 * m * c * c, 2 * 25 * m * c
    return (nbytes / HBM_BPS * 1e3,
            ops_ms(bf16=mm, f32=taps) if bf else ops_ms(f32=mm + taps))


def time_mae(device, crops, masks, val_imgs, val_draws):
    """Each ConvMAE kernel against its plain version (and attention against
    ``F.scaled_dot_product_attention``) at the bs 128 bf16 extraction
    shapes; encoder img/s at bs 128 bf16 on the kernel, plain and
    flash + front paths; the validation forward at bs 16 float32; peak
    memory and profiles.  → per kernel (ms, plain ms, bound ms, bytes ms,
    operations ms, library ms) per forward."""
    import torch.nn.functional as F
    from multimodal_isic_tpu_torch.data.augment import mae_eval_batch
    from multimodal_isic_tpu_torch.train.mae import (make_encoder_step,
                                                     make_mae_eval_step)
    from multimodal_isic_tpu_torch.utils.profiling import timeit_closed
    fns = _mae_fns()
    g = torch.Generator(device=device).manual_seed(SEED + 25)
    per_fw = {"fused_ln_mlp": [((LAT_BATCH, 56, 256), 2), ((LAT_BATCH, 28, 384), 2)],
              "flash_attention": [((LAT_BATCH, 12, 196, 64), 11)],
              "fused_front": [((LAT_BATCH, 56, 256, False), 2),
                              ((LAT_BATCH, 28, 384, False), 2)]}
    out = {}
    for name, geos in per_fw.items():
        kern, ref = fns[name]
        tot = [0.0] * 5 + [None]
        for geo, calls in geos:
            args = _mae_inputs(name, geo, torch.bfloat16, device, g)
            runs = {"kernel": [], "plain": [], "library": []}
            order = ["plain", "kernel", "kernel", "plain"]
            lib_fn = None
            if name == "flash_attention":
                qf, kf, vf = (t.float().contiguous() for t in args)
                lib_fn = lambda: F.scaled_dot_product_attention(qf, kf, vf)
                order += ["library", "library"]
            for which in order:
                fn = {"kernel": lambda: kern(*args),
                      "plain": lambda: ref(*args), "library": lib_fn}[which]
                iters = 10 if which == "kernel" else 3
                runs[which].append(timeit_closed(fn, iters=iters, repeats=3))
            med = {k: min(r["median"] for r in v) * 1e3
                   for k, v in runs.items() if v}
            b_bytes, b_ops = mae_bound_ms(name, torch.bfloat16, geo)
            bound = max(b_bytes, b_ops)
            lib = (f", SDPA on f32 copies {med['library']:.4f} ms"
                   if "library" in med else "")
            print(f"time {name} {geo} bf16: kernel {med['kernel']:.4f} ms, "
                  f"plain {med['plain']:.4f} ms ({med['plain'] / med['kernel']:.2f}x)"
                  f"{lib}; bound {bound:.4f} ms (bytes {b_bytes:.4f}, "
                  f"operations {b_ops:.4f}): {bound / med['kernel']:.1%} of it;"
                  f" {calls} calls a forward")
            for i, v in enumerate((med["kernel"], med["plain"], bound,
                                   b_bytes, b_ops)):
                tot[i] += calls * v
            if "library" in med:
                tot[5] = (tot[5] or 0.0) + calls * med["library"]
            del args
        out[name] = tot

    # encoder img/s, bs 128 bf16, the three configurations
    models = mae_models(device, SEED + 22, with_decoder=False,
                        dtype=torch.bfloat16, variants=LAT_VARIANTS)
    img, _ = mae_eval_batch(torch.from_numpy(crops[:LAT_BATCH]).to(device),
                            torch.from_numpy(masks[:LAT_BATCH]).to(device))
    steps = {k: make_encoder_step(m) for k, m in models.items()}
    runs = {k: [] for k in steps}
    peak = {}
    for name in ("plain", "kernel", "flash+front", "flash+front", "kernel",
                 "plain"):
        torch.cuda.reset_peak_memory_stats()
        runs[name].append(timeit_closed(lambda: steps[name](img), iters=5,
                                        repeats=3))
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
    for name, r in runs.items():
        med = float(np.median([x["median"] for x in r]))
        best = min(x["best"] for x in r)
        print(f"encoder bs{LAT_BATCH} bf16 ({name} path): "
              f"{LAT_BATCH / med:.1f} img/s (median, best "
              f"{LAT_BATCH / best:.1f}); {med * 1e3:.2f} ms a forward; peak "
              f"device memory {peak[name]:.2f} GiB")
    profile_steps(lambda: steps["kernel"](img), f"encoder bs{LAT_BATCH} bf16 "
                  "kernel path")
    profile_steps(lambda: steps["flash+front"](img), f"encoder bs{LAT_BATCH} "
                  "bf16 flash+front path")
    del models, steps

    # the validation forward, bs 16 float32
    models = mae_models(device, SEED + 23, norm_pix_loss=True,
                        variants={"kernel": ALL_FLAGS, "plain": {}})
    steps = {k: make_mae_eval_step(m, MASK_RATIO) for k, m in models.items()}
    runs = {k: [] for k in steps}
    for name in ("plain", "kernel", "kernel", "plain"):
        torch.cuda.reset_peak_memory_stats()
        runs[name].append(timeit_closed(
            lambda: steps[name](val_imgs, masking=val_draws), iters=5,
            repeats=3))
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
    for name, r in runs.items():
        med = float(np.median([x["median"] for x in r]))
        print(f"MAE validation forward bs{VAL_BATCH} f32 ({name} path): "
              f"{med * 1e3:.2f} ms a batch, {VAL_BATCH / med:.1f} img/s; peak "
              f"device memory {peak[name]:.2f} GiB")
    profile_steps(lambda: steps["kernel"](val_imgs, masking=val_draws),
                  f"MAE validation bs{VAL_BATCH} f32 kernel path")
    del models, steps
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ MAE training

def b10_geometries():
    """(dtype, M, C) of the backward kernel's calls: stages 1 and 2 of the
    train step at bs 16 float32 and bs 64 bf16, and M that is not a multiple
    of either row block."""
    f32, bf = torch.float32, torch.bfloat16
    vb, lb = VAL_BATCH, MAE_LARGE_BATCH
    return [(f32, vb * 56 * 56, 256), (f32, vb * 28 * 28, 384),
            (bf, lb * 56 * 56, 256), (bf, lb * 28 * 28, 384),
            (f32, 1000, 256), (bf, 1000, 384)]


def _b10_inputs(dtype, m, c, device, g):
    """x, the output cotangent and a ConvBlock's MLP parameters, as
    :func:`_mae_inputs` makes the forward's."""
    x = _mae_inputs("fused_ln_mlp", (1, 1, c), dtype, device, g)
    rn = lambda *s: torch.randn(*s, generator=g, device=device)
    return ((rn(m, c) * 2 + 0.5).to(dtype), rn(m, c).to(dtype), *x[1:])


def check_b10(device):
    """The backward kernel against its plain version at every geometry of
    the path → worst max |dx kernel − dx plain|."""
    from multimodal_isic_tpu_torch.ops import fused_mlp as FM
    g = torch.Generator(device=device).manual_seed(SEED + 30)
    print("fused_ln_mlp_backward vs plain tolerance: dx |err| <= atol + "
          "rtol*|plain| (atol, rtol), the parameter gradients by relative "
          "Frobenius error: " + "; ".join(
              f"{str(dt)[6:]} dx {t['dx']} rel_fro {t['rel_fro']}"
              for dt, t in FM.BWD_TOL.items()))
    worst, failures = 0.0, []
    for dtype, m, c in b10_geometries():
        args = _b10_inputs(dtype, m, c, device, g)
        got = FM.fused_ln_mlp_backward(*args)
        want = FM.fused_ln_mlp_backward_reference(*args)
        again = FM.fused_ln_mlp_backward(*args)
        torch.cuda.synchronize()
        tol = FM.BWD_TOL[dtype]
        err, ok = _allclose_err(got[0], want[0], *tol["dx"])
        rels = [float((a.float() - b.float()).norm() / b.float().norm())
                for a, b in zip(got[1:], want[1:])]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = ok and max(rels) <= tol["rel_fro"] and same
        worst = max(worst, err)
        label = f"fused_ln_mlp_backward M {m} C {c} {str(dtype)[6:]}"
        print(f"check {label}: dx max_abs_err {err:.3e}; rel_fro dls dlb dw1 "
              f"db1 dw2 db2 " + " ".join(f"{r:.2e}" for r in rels)
              + f"; same bits on a rerun {same} ({'ok' if ok else 'FAIL'})")
        if not ok:
            failures.append(label)
        del args, got, want, again
    if failures:
        raise AssertionError(f"fused_ln_mlp_backward vs plain: {failures}")
    return worst


def _grad_errors(kernel, plain):
    """Per parameter group (top-level module) the relative Frobenius error
    of one step's gradients, kernel path vs plain path; raises on a missing
    or non-finite gradient."""
    bad = [k for k, p in kernel.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if bad:
        raise AssertionError(f"missing or non-finite gradients: {bad[:8]}")
    num, den = {}, {}
    want = dict(plain.named_parameters())
    for k, p in kernel.named_parameters():
        grp = k.split(".")[0]
        num[grp] = num.get(grp, 0.0) + float((p.grad - want[k].grad).pow(2).sum())
        den[grp] = den.get(grp, 0.0) + float(want[k].grad.pow(2).sum())
    return {grp: math.sqrt(num[grp] / max(den[grp], 1e-300)) for grp in num}


def _step_grads(models, imgs, draws):
    for m in models.values():
        m.zero_grad(set_to_none=True)
        loss, _, _ = m(imgs, MASK_RATIO, masking=draws)
        loss.backward()


def _check_grads(label, models, launches):
    errs = _grad_errors(models["kernel"], models["plain"])
    print(f"{label}: kernel launches {launches}; worst relative gradient "
          f"error per parameter group vs the plain path (tolerance "
          f"{MAE_GRAD_TOL}): " + ", ".join(f"{k} {v:.2e}"
                                            for k, v in errs.items()))
    if max(errs.values()) > MAE_GRAD_TOL:
        raise AssertionError(f"{label}: gradients out of tolerance")


def _all_launches():
    from multimodal_isic_tpu_torch.ops import fused_mlp as FM
    out = _mae_launches()
    out["fused_ln_mlp_backward"] = FM.fused_ln_mlp_backward.launches
    return out


def _reset_all_launches():
    from multimodal_isic_tpu_torch.ops import fused_mlp as FM
    _reset_mae_launches()
    FM.fused_ln_mlp_backward.launches = 0


def mae_train_slice(device, crops, masks, targets):
    """ConvMAE training at ConvViT-Base width and depth, bs 16 float32 →
    (backward kernel launches in training, the staged training split)."""
    from multimodal_isic_tpu_torch.core.checkpoint import restore_train_state
    from multimodal_isic_tpu_torch.core.rng import RngPool, generator
    from multimodal_isic_tpu_torch.core.splits import weighted_sample_indices
    from multimodal_isic_tpu_torch.data.augment import POLICIES
    from multimodal_isic_tpu_torch.data.pipeline import DeviceDataset
    from multimodal_isic_tpu_torch.models.convmae import ConvMAE
    from multimodal_isic_tpu_torch.train import mae as M
    t0 = time.perf_counter()
    n, b = MAE_TRAIN_N, VAL_BATCH
    val_idx = np.arange(0, n, 10)  # 10% held out
    train_idx = np.setdiff1d(np.arange(n), val_idx)
    stage = lambda idx: DeviceDataset(crops[idx], {"target": targets[idx]},
                                      masks[idx], device=device)
    train_ds, val_ds = stage(train_idx), stage(val_idx)
    print(f"MAE train: {n} rendered lesions (450² crops; a depth cut of "
          f"HAM10000's 10,015), {len(train_ds)} train + {len(val_ds)} val "
          f"staged with masks in {time.perf_counter() - t0:.1f} s")

    # one train step's gradients, kernel path vs plain path
    models = mae_models(device, SEED + 31, norm_pix_loss=True,
                        variants={"kernel": dict(use_fused_mlp=True),
                                  "plain": dict(use_fused_mlp=False)})
    imgs, _ = POLICIES["mae_train"](train_ds.images[:b], train_ds.masks[:b],
                                    generator(SEED + 32, device))
    draws = models["kernel"].masking(b, MASK_RATIO,
                                     generator(SEED + 33, device))
    _reset_all_launches()
    _step_grads(models, imgs, draws)
    _check_grads(f"train step gradients bs {b} f32 (fused LN-MLP)", models,
                 _all_launches())

    # two epochs through train_mae, the best checkpoint restored
    model = models.pop("kernel").train()
    del models
    opt = M.mae_optimizer(model)
    train_epoch = M.make_mae_train_epoch(model, opt, MASK_RATIO, False,
                                         POLICIES["mae_train"])
    val_epoch = M.make_mae_eval_epoch(model, MASK_RATIO, POLICIES["mae_eval"])
    val_order = val_ds.epoch_order(b)
    labels = targets[train_idx]
    orders = [train_ds.epoch_order(b, weighted_sample_indices(
        labels, None, np.random.RandomState(SEED + e)))
        for e in range(MAE_EPOCHS)]
    val_gen = lambda: generator(SEED + 34, device)  # fixed draws
    ckpt_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_mae_ckpt"

    class Log:
        def log(self, *a, **k):
            pass

        def print(self, msg):
            print(msg)

    _reset_all_launches()
    t0 = time.perf_counter()
    out = M.train_mae(
        model, opt,
        lambda e, aug, msk: train_epoch(train_ds.images, train_ds.masks,
                                        orders[e], aug, msk),
        lambda _: val_epoch(val_ds.images, val_ds.masks, val_order,
                            val_gen()),
        MAE_EPOCHS, RngPool(SEED, device), logger=Log(),
        checkpoint_dir=str(ckpt_dir))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _all_launches()
    n_steps = sum(len(o) for o in orders)
    n_val = MAE_EPOCHS * len(val_order)
    print(f"MAE train: {MAE_EPOCHS} epochs of {len(orders[0])} steps of {b} "
          f"(weighted resampling, mae_train), validation {len(val_order)} "
          f"step an epoch on fixed draws: {wall:.1f} s; launches {launches} "
          f"over {n_steps} train steps and {n_val} validation forwards")
    want = {"fused_ln_mlp": 4 * (n_steps + n_val), "flash_attention": 0,
            "fused_front": 0, "fused_ln_mlp_backward": 4 * n_steps}
    if launches != want:
        raise AssertionError(f"MAE train launches {launches} != {want}")
    losses = [v for h in out["history"] for v in (h["train_loss"],
                                                  h["val_loss"])]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite MAE loss")
    with torch.device("meta"):
        fresh = ConvMAE(norm_pix_loss=True, use_fused_mlp=True)
    fresh.to_empty(device=device)
    fresh_opt = M.mae_optimizer(fresh)
    meta = restore_train_state(out["checkpoint"], fresh, fresh_opt)
    same_w = all(torch.equal(v, out["best_state"][k])
                 for k, v in fresh.state_dict().items())
    vloss = M.make_mae_eval_epoch(fresh, MASK_RATIO, POLICIES["mae_eval"])(
        val_ds.images, val_ds.masks, val_order, val_gen())
    print(f"checkpoint {Path(out['checkpoint']).name} (epoch {meta['epoch']},"
          f" step {meta['step']}): restored weights equal the best copy "
          f"{same_w}; restored validation loss {vloss!r} vs saved "
          f"{out['best_val_loss']!r} (must be equal)")
    if not same_w or vloss != out["best_val_loss"] or \
            M.optimizer_step_count(fresh_opt) != meta["step"]:
        raise AssertionError("restored MAE checkpoint differs")
    del model, opt, fresh, fresh_opt, out
    torch.cuda.empty_cache()

    # one step with all three kernels and lesion-guided masking
    models = mae_models(device, SEED + 35, norm_pix_loss=True,
                        variants={"kernel": ALL_FLAGS,
                                  "plain": dict(use_fused_mlp=False)})
    imgs, msk = POLICIES["mae_train"](train_ds.images[b:2 * b],
                                      train_ds.masks[b:2 * b],
                                      generator(SEED + 36, device))
    draws = models["kernel"].masking(b, MASK_RATIO,
                                     generator(SEED + 37, device),
                                     lesion_mask=msk)
    _reset_all_launches()
    _step_grads(models, imgs, draws)
    launches_all = _all_launches()
    _check_grads(f"train step gradients bs {b} f32, all kernels, "
                 f"lesion-guided masking", models, launches_all)
    want = {"fused_ln_mlp": 4, "flash_attention": 11 + 8, "fused_front": 4,
            "fused_ln_mlp_backward": 4}
    if launches_all != want:
        raise AssertionError(f"all-kernel step launches {launches_all} != "
                             f"{want}")
    del models
    torch.cuda.empty_cache()
    return launches["fused_ln_mlp_backward"], train_ds


def mae_learning_evidence(device, train_ds):
    """20 AdamW steps on one fixed batch of 16 with fixed masking draws, on
    the kernel path: the loss must fall."""
    from multimodal_isic_tpu_torch.core.rng import generator
    from multimodal_isic_tpu_torch.data.augment import mae_eval_batch
    from multimodal_isic_tpu_torch.train import mae as M
    model = mae_models(device, SEED + 38, norm_pix_loss=True,
                       variants={"kernel": dict(use_fused_mlp=True)})["kernel"]
    b = VAL_BATCH
    imgs, _ = mae_eval_batch(train_ds.images[:b], train_ds.masks[:b])
    draws = model.masking(b, MASK_RATIO, generator(SEED + 39, device))
    step = M.make_mae_train_step(model, M.mae_optimizer(model), MASK_RATIO)
    losses = [float(step(imgs, masking=draws)) for _ in range(MAE_LEARN_STEPS)]
    print(f"MAE fixed batch of {b}, {MAE_LEARN_STEPS} steps, loss per step: "
          + " ".join(f"{v:.4f}" for v in losses))
    if not losses[-1] < losses[0]:
        raise AssertionError("the MAE loss did not fall on a fixed batch")


def b10_bound_ms(dtype, m, c):
    """(bytes ms, operations ms) of one backward call: x, g read and dx
    written once, both weights read and their gradients (float32) written
    once, the vectors; the operations the function needs, 10·M·C·F (the h
    recompute, g·w2ᵀ, aᵀg, yᵀdh, dh·w1ᵀ), at the rate of their operands'
    type.  The kernel's two passes both recompute h and g·w2ᵀ, 14·M·C·F:
    that overhead is its own and is not in the bound."""
    esz = 2 if dtype == torch.bfloat16 else 4
    f = 4 * c
    nbytes = 3 * m * c * esz + 2 * c * f * esz + 2 * c * f * 4 + (6 * c + 2 * f) * 4
    ops = 10 * m * c * f
    return (nbytes / HBM_BPS * 1e3,
            ops_ms(bf16=ops) if dtype == torch.bfloat16 else ops_ms(f32=ops))


def time_mae_train(device, train_ds):
    """The backward kernel against its plain version and bound at the train
    step's shapes (bs 16 float32), and the train step in img/s at bs 16
    float32 and bs 64 bf16 on the kernel and plain paths, peak memory and
    profiles → per step (ms, plain ms, bound ms, bytes ms, operations ms,
    library ms)."""
    from multimodal_isic_tpu_torch.core.rng import generator
    from multimodal_isic_tpu_torch.data.augment import mae_eval_batch
    from multimodal_isic_tpu_torch.ops import fused_mlp as FM
    from multimodal_isic_tpu_torch.train import mae as M
    from multimodal_isic_tpu_torch.utils.profiling import timeit_closed
    g = torch.Generator(device=device).manual_seed(SEED + 40)
    tot = [0.0] * 5
    for dtype, m, c in b10_geometries()[:4]:
        args = _b10_inputs(dtype, m, c, device, g)
        runs = {"kernel": [], "plain": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = (FM.fused_ln_mlp_backward if which == "kernel"
                  else FM.fused_ln_mlp_backward_reference)
            runs[which].append(timeit_closed(lambda: fn(*args),
                                             iters=5 if which == "kernel" else 2,
                                             repeats=3))
        med = {k: min(r["median"] for r in v) * 1e3 for k, v in runs.items()}
        b_bytes, b_ops = b10_bound_ms(dtype, m, c)
        bound = max(b_bytes, b_ops)
        print(f"time fused_ln_mlp_backward M {m} C {c} {str(dtype)[6:]}: "
              f"kernel {med['kernel']:.4f} ms, plain {med['plain']:.4f} ms "
              f"({med['plain'] / med['kernel']:.2f}x); bound {bound:.4f} ms "
              f"(bytes {b_bytes:.4f}, operations {b_ops:.4f}): "
              f"{bound / med['kernel']:.1%} of it (the kernel's own two-pass "
              f"recompute does 1.4x the bound's operations); library: none "
              f"(no one PyTorch call computes this function); 2 calls a step")
        if dtype == torch.float32:  # the slice's step: bs 16 float32
            for i, v in enumerate((med["kernel"], med["plain"], bound,
                                   b_bytes, b_ops)):
                tot[i] += 2 * v
        del args

    pol_gen = generator(SEED + 41, device)
    for bsz, dtype in ((VAL_BATCH, torch.float32),
                       (MAE_LARGE_BATCH, torch.bfloat16)):
        idx = torch.arange(bsz, device=device) % len(train_ds)
        imgs, _ = mae_eval_batch(train_ds.images[idx], train_ds.masks[idx])
        models = mae_models(device, SEED + 42, norm_pix_loss=True,
                            dtype=dtype,
                            variants={"kernel": dict(use_fused_mlp=True),
                                      "plain": dict(use_fused_mlp=False)})
        steps = {k: M.make_mae_train_step(m.train(), M.mae_optimizer(m),
                                          MASK_RATIO)
                 for k, m in models.items()}
        runs = {k: [] for k in steps}
        peak = {}
        for name in ("plain", "kernel", "kernel", "plain"):
            torch.cuda.reset_peak_memory_stats()
            runs[name].append(timeit_closed(
                lambda: steps[name](imgs, generator=pol_gen), iters=3,
                repeats=3))
            peak[name] = torch.cuda.max_memory_allocated() / 2**30
        for name, r in runs.items():
            med = float(np.median([x["median"] for x in r]))
            best = min(x["best"] for x in r)
            print(f"MAE train step bs{bsz} {str(dtype)[6:]} ({name} path: "
                  f"forward + backward + AdamW on one policy-made batch, "
                  f"augmentation not timed): {bsz / med:.1f} img/s "
                  f"(median, best {bsz / best:.1f}); {med * 1e3:.2f} ms a "
                  f"step; peak device memory {peak[name]:.2f} GiB")
        for name in ("kernel", "plain"):
            profile_steps(lambda: steps[name](imgs, generator=pol_gen),
                          f"MAE train step bs{bsz} {str(dtype)[6:]} {name} "
                          f"path", steps=2)
        del models, steps
        torch.cuda.empty_cache()
    return tot + [None]


def to_device_batch(reqs, device, sl=slice(None)):
    return {k: torch.from_numpy(np.ascontiguousarray(v[sl])).to(device)
            for k, v in reqs.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from multimodal_isic_tpu_torch.data.augment import preprocess_eval_batch
    from multimodal_isic_tpu_torch.ops import _build
    from multimodal_isic_tpu_torch.ops import affine_warp as aw
    from multimodal_isic_tpu_torch.ops import attention
    from multimodal_isic_tpu_torch.ops import connected_components as cc
    from multimodal_isic_tpu_torch.ops import fused_convblock, fused_mlp
    from multimodal_isic_tpu_torch.ops import fused_dwconv as fd
    from multimodal_isic_tpu_torch.ops import glcm, glrlm_runs, histogram
    from multimodal_isic_tpu_torch.train.fusion import (evaluate_test,
                                                        make_fusion_eval_step)
    from multimodal_isic_tpu_torch.utils.profiling import timeit_closed

    # float32 in full float32 (no TF32), for the plain versions, the
    # comparisons and the float32 training
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; TF32 off")

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = {"fused_dwconv": fd._lib, "affine_warp": aw._lib,
            "glcm": glcm._lib, "glrlm_runs": glrlm_runs._lib,
            "histogram": histogram._lib, "connected_components": cc._lib,
            "fused_ln_mlp": fused_mlp._lib, "flash_attention": attention._lib,
            "fused_front": fused_convblock._lib,
            "fused_ln_mlp_bwd": fused_mlp._bwd_lib}
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda load: load(), libs.values()))
    print(f"build: {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in libs:
        lib = _build.library_path(name)
        print(f"  {lib.relative_to(lib.parents[2])}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "bytes stack" in line or "Compiling" in line:
                print("  ptxas:", line.strip())

    # 3. fused kernels vs plain at every serving geometry
    worst_err = check_kernels(device)

    # 4. the serving slice end to end
    reqs = make_requests(N_REQUESTS)
    dev_reqs = to_device_batch(reqs, device)
    kernel_m, plain_m, standard_m = build_models(device)
    n_batches = N_REQUESTS // BATCH

    def loader():
        for s in range(0, N_REQUESTS, BATCH):
            batch = {k: v[s:s + BATCH] for k, v in dev_reqs.items()}
            batch["image"] = preprocess_eval_batch(batch["image"], (IMG, IMG),
                                                   dtype=torch.bfloat16)
            yield batch

    class Logger:
        def __init__(self):
            self.values = {}

        def assign(self, key, value):
            self.values[key] = value

        def print(self, msg):
            print(msg)

    logger = Logger()
    step = make_fusion_eval_step(kernel_m)
    fd.dw_silu_pool.launches = 0
    fd.expand_dw_silu_pool.launches = 0
    acc, report = evaluate_test(step, loader(), logger=logger)
    launches = {"dw_silu_pool": fd.dw_silu_pool.launches,
                "expand_dw_silu_pool": fd.expand_dw_silu_pool.launches}
    print(f"serving: {N_REQUESTS} requests in batches of {BATCH}: accuracy "
          f"{acc:.5f}, balanced accuracy "
          f"{logger.values['test/balanced_accuracy']:.5f}")
    print(f"kernel launches in the serving run: {launches} "
          f"({n_batches} forwards)")
    want = {"dw_silu_pool": 2 * n_batches, "expand_dw_silu_pool": 20 * n_batches}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")

    logits = {name: [] for name in ("kernel", "plain", "standard")}
    with torch.inference_mode():
        for batch in loader():
            for name, m in (("kernel", kernel_m), ("plain", plain_m),
                            ("standard", standard_m)):
                logits[name].append(make_fusion_eval_step(m)(batch)[1])
    logits = {k: torch.cat(v).float().cpu() for k, v in logits.items()}
    if logits["kernel"].shape != (N_REQUESTS, 7):
        raise AssertionError(f"logits shape {tuple(logits['kernel'].shape)}")
    if not bool(torch.isfinite(logits["kernel"]).all()):
        raise AssertionError("non-finite logits on the kernel path")
    for other, tol in (("plain", LOGIT_TOL_PLAIN),
                       ("standard", LOGIT_TOL_UNFOLDED)):
        err = float((logits["kernel"] - logits[other]).abs().max())
        print(f"logits kernel vs {other}: max_abs_err {err:.4e} "
              f"(|logits| max {float(logits[other].abs().max()):.3f}, "
              f"tolerance {tol})")
        torch.testing.assert_close(logits["kernel"], logits[other],
                                   **tol)
    agree = float((logits["kernel"].argmax(1)
                   == logits["plain"].argmax(1)).float().mean())
    print(f"argmax agreement kernel vs plain: {agree:.4f}")
    with torch.inference_mode():  # the backbone's features, before the MLPs
        img = next(loader())["image"]
        feats = {name: m.image_model(img).float().cpu() for name, m in
                 (("kernel", kernel_m), ("plain", plain_m),
                  ("standard", standard_m))}
    for other, tol in (("plain", LOGIT_TOL_PLAIN),
                       ("standard", LOGIT_TOL_UNFOLDED)):
        err = float((feats["kernel"] - feats[other]).abs().max())
        print(f"B3 features kernel vs {other}: max_abs_err {err:.4e} "
              f"(|features| max {float(feats[other].abs().max()):.3f})")
        torch.testing.assert_close(feats["kernel"], feats[other], **tol)

    # 5. the warp kernel
    worst_err["affine_warp_batch"] = check_warp(device)

    # 6. the training slice end to end
    warp_launches, train_ds = train_slice(device, reqs)
    launches["affine_warp_batch"] = warp_launches

    # 7. learning evidence on a fixed batch
    learning_evidence(device, train_ds)

    # 8. times
    warp_times = time_training(device, train_ds)
    totals = time_kernels(device)
    for bsz in (BATCH, LARGE_BATCH):
        reps = -(-bsz // N_REQUESTS)
        batch = {k: torch.cat([v] * reps)[:bsz] for k, v in dev_reqs.items()}
        inputs = {k: batch[k] for k in ("radiomics", "age", "sex", "loc",
                                        "artifacts")}

        def serve(model):
            with torch.inference_mode():
                img = preprocess_eval_batch(batch["image"], (IMG, IMG),
                                            dtype=torch.bfloat16)
                return model(image=img, **inputs)

        def pre():
            with torch.inference_mode():
                return preprocess_eval_batch(batch["image"], (IMG, IMG),
                                             dtype=torch.bfloat16)

        runs = {"plain": [], "kernel": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            m = kernel_m if name == "kernel" else plain_m
            runs[name].append(timeit_closed(lambda: serve(m), iters=10,
                                            repeats=5))
        t_pre = timeit_closed(pre, iters=10, repeats=5)
        med = {k: float(np.median([r["median"] for r in v]))
               for k, v in runs.items()}
        best = {k: min(r["best"] for r in v) for k, v in runs.items()}
        print(f"serve bs{bsz} bf16 preprocess+folded forward: kernel path "
              f"{bsz / med['kernel']:.1f} img/s (median, best "
              f"{bsz / best['kernel']:.1f}), plain path "
              f"{bsz / med['plain']:.1f} img/s (median, best "
              f"{bsz / best['plain']:.1f}); preprocess alone "
              f"{t_pre['median'] * 1e3:.3f} ms")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; wall {time.perf_counter() - t_start:.1f} s")

    # 9. radiomics extraction: kernels vs plain, the path, times
    del kernel_m, plain_m, standard_m, train_ds
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rgb, masks = radiomics_samples()
    print(f"radiomics: rendered {len(rgb)} samples in "
          f"{time.perf_counter() - t0:.1f} s (depth cut: {len(rgb)} images of "
          f"HAM10000's 10,015)")
    worst_err.update(check_radiomics_kernels(device, rgb[:RAD_CHUNK],
                                             masks[:RAD_CHUNK]))
    launches.update(radiomics_path(device, rgb, masks))
    rad_times = time_radiomics(device, rgb, masks)
    print(f"wall {time.perf_counter() - t_start:.1f} s")

    # 10. ConvMAE: kernels vs plain, latent extraction, the validation
    # forward, times
    del rgb, masks
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    crops, mmasks, targets = mae_samples()
    print(f"ConvMAE: rendered {len(crops)} samples in "
          f"{time.perf_counter() - t0:.1f} s (depth cut: {len(crops)} images "
          f"of HAM10000's 10,015)")
    worst_err.update(check_mae_kernels(device))
    launches.update(latent_path(device, crops, mmasks, targets))
    val_imgs, val_draws = mae_validation(device, crops, mmasks)
    mae_times = time_mae(device, crops, mmasks, val_imgs, val_draws)
    print(f"wall {time.perf_counter() - t_start:.1f} s")

    # 11. ConvMAE training: the backward kernel vs plain, a step's gradients,
    # the epochs and the checkpoint, all kernels with lesion guidance,
    # learning evidence, times
    t11 = time.perf_counter()
    worst_err["fused_ln_mlp_backward"] = check_b10(device)
    launches["fused_ln_mlp_backward"], mae_ds = mae_train_slice(
        device, crops[:MAE_TRAIN_N], mmasks[:MAE_TRAIN_N],
        targets[:MAE_TRAIN_N])
    mae_learning_evidence(device, mae_ds)
    mae_times["fused_ln_mlp_backward"] = time_mae_train(device, mae_ds)
    print(f"phase 11 (ConvMAE training) {time.perf_counter() - t11:.1f} s; "
          f"wall {time.perf_counter() - t_start:.1f} s")

    med, bound, b_bytes, b_ops = warp_times[BATCH]
    totals["affine_warp_batch"] = [med["kernel"], med["plain"], bound, b_bytes,
                                   b_ops]
    library = {"affine_warp_batch": med["grid_sample"]}
    for name, (ker, pln, bnd, bb, bo, lib) in (*rad_times.items(),
                                               *mae_times.items()):
        totals[name] = [ker, pln, bnd, bb, bo]
        library[name] = lib
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": worst_err[name], "ms": totals[name][0],
         "plain_ms": totals[name][1], "bound_ms": totals[name][2],
         "bound_by": ("bytes" if totals[name][3] >= totals[name][4]
                      else "operations"),
         "library_ms": library.get(name)}
        for name in ("expand_dw_silu_pool", "dw_silu_pool",
                     "affine_warp_batch") + RAD_KERNELS + MAE_KERNELS
        + ("fused_ln_mlp_backward",)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
