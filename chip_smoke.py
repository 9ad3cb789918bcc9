#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving, training, radiomics and ConvMAE
slices, of the first-order and bare-MLP entry points and of the CLIs (MIL
cross-validation and the MIL search included), on one CUDA card.

    python3 chip_smoke.py

Drives ``multimodal_isic_tpu_torch`` end to end at the full EfficientNet-B3
width with random weights from a seed:

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels (every ``csrc/*.cu``: 13 libraries, with
   ``csrc/convmae_common.cuh`` 14 sources), one nvcc per source, started
   together;
3. holds each fused MBConv kernel against its plain PyTorch version at every
   geometry the B3@380 serving forward gives it, at bs 16 and bs 128 in bf16
   and float32, checks that a rerun gives the same bits of y and pool and
   that a bf16 call makes one device launch and no memset;
4. serves 64 in-memory requests (rendered 450×600 samples, centroid-cropped
   to 450²) in batches of 16 through preprocess → BN-folded fusion net on the
   fused-kernel path → ``make_fusion_eval_step`` → ``evaluate_test``; checks
   the kernel launch counts, that the logits are finite and that they agree
   with the plain folded path and with the unfolded standard-BN model;
5. holds the warp kernel against its plain version and ``F.grid_sample`` at
   bs 16, 380², on the policy's draws, its domain corners, the identity, an
   overhang beyond 128 px, and at an odd non-square size; holds the colour
   jitter kernel against its plain version at bs 16 and bs 128, 380², on
   the policy's draws (images not drawn and a rerun bit for bit);
6. trains: 160 rendered requests, ``StratifiedKFold(10)`` fold 0 staged in
   ``DeviceDataset``, the full B3 fusion net in float32 with the CLI's
   defaults, 2 device-resident epochs of the fast policy, validation epochs,
   early stopping, a checkpoint saved and restored into a fresh model, BN
   folded, and the kernel-path test pass; checks finite losses, moved
   weights and statistics, one warp and one jitter launch per step, 2 + 20
   fused launches
   per test forward, and that the restored model gives the saved one's
   logits;
7. trains 20 steps on one fixed batch (no augmentation, the same dropout
   masks every step) and checks that the loss falls;
8. times the kernels against their plain versions (and the warp against
   ``grid_sample``; the fused MBConv kernels, the warp and the colour jitter
   at bs 16 and bs 128), the fast
   policy, the train step in img/s at bs 16 f32 and bs 128 with a bf16
   backbone, and preprocess + folded forward on the kernel path against the
   plain path, with CUDA events, and profiles that forward at bs 16 and 128
   on both paths;
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
   (attention) ``F.scaled_dot_product_attention``, attention also at the
   validation forward's float32 shapes and as device time (CUDA-graph
   replays, beside the eager calls), the encoder's img/s on the three
   configurations, the validation forward, peak memory and profiles;
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
   fixed batch (the loss must fall); times the backward kernels against
   their plain version and bound, with each kernel's device time and the
   workspace size, the train step in img/s at bs 16 float32 and bs 64 bf16
   on the kernel and plain paths, peak memory and a profile;
12. first-order accumulation and the bare fused MLP, each through its own
   entry point (neither has a caller in the JAX package): the 13
   first-order calls of one radiomics chunk (64 maps of 450×600, one per
   derived image: the cluster path, one launch a call) and the bare MLP at
   ConvViT-Base's conv stages (bs 16 float32, bs 128 bf16: wgmma + TMA)
   and at C2 ≠ C, with the launch counts at 0; holds each result against
   its plain version (first order: n, min, max and the histogram equal,
   the sums within ``SUM_TOL`` of their magnitude, and the edge maps: an
   empty ROI, one pixel, codes above NG and 128, the scalar head and tail,
   and 1000×1000 maps on the two-pass path; the MLP within
   ``fused_mlp.TOL``), the same bits on a rerun, each plan's path and
   device launches a call, the first-order stats against
   ``texture.firstorder_features`` and the MLP's gradients on the card;
   times both against their plain versions, bounds, the MLP's two products
   alone as ``torch.matmul`` and, where ``build/parent`` holds a checkout
   of the parent commit, the parent's kernels in the same run;
13. the fusion CLI from files on disk: writes 192 rendered 450×600 lesions
   (160 train, 32 test) with ``make_synthetic_isic``, runs
   ``cli.prepare_df`` and ``cli.main`` (B3@380 full width, float32,
   ``augment_fast``, ``device_cache`` and ``fold_bn_eval``, 2 epochs, fold
   1) with the launch counts at 0: one warp launch a train step, 2 + 20
   fused MBConv launches a test forward, finite losses, the metrics events,
   and a model restored from the saved checkpoint gives the CLI's test
   logits bit for bit; times the host decode (and holds the native decoder
   against cv2 where it loads), the device-resident epoch and the test
   pass; runs the CLI again for one streaming epoch (``device_cache``
   off), checks that the streaming loader's batches on the card equal the
   records and times a streaming epoch; checks one bs 16 train step with
   ``backbone_remat`` 'conv' and 'block' against 'none' (loss, gradient
   norms) with each one's peak memory; runs ``entry()``'s forward;
14. the radiomics and MAE chains from phase 13's files on disk through
   their CLIs, the launch counts at 0 before each: ``cli.extract_radiomics``
   (450×600, 4,872 features, chunks of 16: 13 launches of each radiomics
   kernel a chunk; finite frames with the four channel suffixes; 16 rows
   within ``RAD_TOL`` of the plain path on the same decoded images; the
   decoder and extraction img/s) → ``cli.reduce_dim`` (FISTA on the card;
   the stage counts and frames equal ``reduce_features`` on the CPU, a
   selection tie at the threshold said so; the FISTA grid's device time) →
   ``cli.main`` for one epoch (the radiomics MLP at the reduced width, the
   restored checkpoint's logits bit for bit); ``cli.train_ae``
   (ConvViT-Base, decoder 512 × 8, bs 16 f32, mask 0.75, norm-pix, flash
   attention, 2 epochs) on the loader path and with ``device_cache`` (4
   fused LN-MLP launches a forward, 4 backward a step, 19 attention
   launches a full forward and 11 an encoder forward; finite losses; the
   uuid checkpoint and ``mae_ckpt/``; the hook's moments and PNGs, or each
   plotting call's ``ImportError`` where matplotlib is missing; the
   restored ``mae_ckpt/`` gives the saved validation loss bit for bit), one
   step on the CLI's weights against the plain path, then
   ``cli.save_latent`` on its checkpoint (bf16, bs 128, PCA: the six frames
   with JAX's columns, 4 fused launches a forward, latents within
   ``LATENT_TOL`` of the encoder with every flag off, img/s).
15. MIL cross-validation on phase 14's latents through
   ``cli.use_latent``, every launch count at 0 before each run, at
   ``configs/config.yml``'s ``best_params`` widths (AttentionMIL 368 / 772,
   adamw; GraphMIL GAT 384 × 3 layers, 1 head, grid graph, pooling 128 × 4,
   light classifier 64) on 160 patient bags of 196 patches: single-frame
   mode, ``mil`` then ``graph-mil``, 5 folds of 2 epochs at patience 2 (a
   depth cut of the CLI's 200 epochs at patience 16; finite rows, the
   summary keys, fold membership equal to ``StratifiedKFold`` on the CPU,
   no kernel launch); sweep mode on a checkpoint whose tree matches
   nothing and on phase 14's ``mae_ckpt/`` best step (NaN rows, finite
   rows, the snapshot's hash header, 4 fused LN-MLP launches an encoder
   forward of the re-extraction, its latents within ``LATENT_TOL`` of
   phase 14's frames); every gnn type on every graph type at 196 × 768 on
   seeded weights, the card against the CPU (eval forward within
   ``MIL_FWD_TOL``, one step's gradients within ``MIL_GRAD_TOL``, the kNN
   graph bit for bit with TF32 on); times the per-bag step (ms, launches,
   busy share), a training epoch's and an evaluation's bags/s;
16. the MIL search on phase 14's latents, every launch count at 0 before
   each run and still 0 after it (the search launches no kernel):
   ``cli.tune_mil`` at ``mil`` and ``graph-mil``, ``--packed auto`` and
   ``never``, 8 samples of 2 epochs at ASHA grace 1, rf 2 (depth cuts of
   the CLI's 1000 samples × 200 epochs at grace 10: the artifacts, finite
   val_bacc, no trial error, ``best_config`` in the space); a cohort member
   against the sequential trial at dropout 0, ``best_params*`` widths, 40
   bags of 196 × 768, 2 epochs (each epoch's val_bacc equal, val_loss
   within ``MEMBER_LOSS_RTOL``); the graph space's large end (GAT 512 × 8
   heads concat × 8 layers) at 196 × 768: parameter MB a trial, the
   sub-cohort the card's budget gives, one epoch over 16 bags (a depth cut)
   with finite losses, the peak memory under the budget; the per-bag
   cohort step at P 1, 2, 4, 8 for both models (ms, launches, busy share,
   trial-bags/s); on 96 de-saturated 196 × 768 bags (30% of the labels
   moved; 16 / 8 samples in cohorts of 8, 6 / 4 epochs: depth cuts), the
   packed search with ASHA against it without a scheduler, and against the
   sequential runner given the packed run's wall time; 16c runs under the
   card's default budget and under ``ISIC_HPO_MEM_GB=30``, each with its
   counted bytes and its peak under the budget;
17. latent clustering on phase 14's latents, every launch count at 0
   before each run and still 0 after it (clustering launches no kernel):
   ``cli.cluster_latents`` at full latent width with the default backbone
   (PCA + k-means, k 20), ``--embed neighbor --clusterer density
   --viz_out`` and ``--knn_method approx --clusterer density`` (each
   writes ``df_filtered.pkl`` with the JAX CLI's columns; the rows and
   width, each stage's time, trustworthiness, clusters and noise), then
   ``cli.fetch_experiments`` over the run directories of phases 13–16 (a
   LaTeX row); the exact kNN graph, Lloyd from one set of centers and
   HDBSCAN given one graph on the card against the CPU (``CARD_CPU_*``);
   at the reference's scale, a seeded 2,097,152 × 64 Gaussian-mixture
   table: the approximate kNN graph (k 15, default nprobe) with recall@15
   on 4,096 sampled queries ≥ ``REF_RECALL``, HDBSCAN and the neighbour
   embedding on that graph, k-means (k 20), each stage's time and peak
   memory;
18. the parallel layer in 2 processes sharing the card over gloo (each
   group of ranks started by ``run_group``: a ``FileStore`` under
   ``build/``, a wall timeout, every rank's output kept; a failed or late
   rank fails the phase), after a world-1 group through the backend rule
   (nccl): 18a the fusion data-parallel step (B3@380 f32, global bs 16 = 2
   × 8, the fast policy, global-batch BatchNorm, dropout on, 4 steps) and
   18c's MAE data-parallel step (ConvViT-Base f32, bs 16, mask 0.75,
   B9/B10, SGD) against one process on rank 0 (``PAR_TOL``), one warp
   launch a step a rank, 4 + 4 B9/B10 launches a step; 18d the MAE
   tensor-parallel step (the transformer blocks split over the 2 ranks, B11
   on 6 of 12 and 8 of 16 heads: 19 launches a step a rank) against the
   replicated model; then ``cli.main`` (18b: 1 epoch from phase 13's files,
   the streaming loader; one run record, finite losses, the test pass's 32
   true rows, the checkpoint restored in one process within
   ``RANK_LOGIT_TOL``, 2 + 20 MBConv launches a test forward and one warp a
   train step a rank), ``cli.train_ae`` (18c: 1 epoch; its ``val_n_true``
   loss against one process on the saved weights within ``PAR_VAL_RTOL``),
   ``cli.extract_radiomics`` (18e: phase 14's frames within ``RAD_TOL`` in
   the same row order, 13 launches of B4–B7 a chunk a rank) and
   ``cli.tune_mil`` (18f: ``mil``, 8 samples × 2 epochs, one table on both
   ranks, artifacts on rank 0 only, no launch) in the same 2 processes;
   prints both clocks of each, with no claim.

Float32 on the card runs in full float32 here: TF32 is off for cuDNN and
cuBLAS throughout (``torch.backends.cudnn.allow_tf32 = False``).

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA the script exits non-zero
and prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import re
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
# firstorder_accumulate vs texture.firstorder_features on the same maps
# (Mean, Variance, MeanAbsoluteDeviation, Uniformity): float32 sums of
# ~10^5 terms in another order (and, for the features, a float32 mean)
FEATURE_REL_TOL = 1e-4
SOURCE = {"dw_silu_pool": "multimodal_isic_tpu_torch/csrc/fused_dwconv.cu",
          "expand_dw_silu_pool": "multimodal_isic_tpu_torch/csrc/fused_dwconv.cu",
          "affine_warp_batch": "multimodal_isic_tpu_torch/csrc/affine_warp.cu",
          "color_jitter_batch":
              "multimodal_isic_tpu_torch/csrc/color_jitter.cu",
          "glcm_matrices": "multimodal_isic_tpu_torch/csrc/glcm.cu",
          "glrlm_runs": "multimodal_isic_tpu_torch/csrc/glrlm_runs.cu",
          "joint_histogram": "multimodal_isic_tpu_torch/csrc/histogram.cu",
          "connected_components":
              "multimodal_isic_tpu_torch/csrc/connected_components.cu",
          "fused_ln_mlp": "multimodal_isic_tpu_torch/csrc/fused_ln_mlp.cu",
          "flash_attention": "multimodal_isic_tpu_torch/csrc/flash_attention.cu",
          "fused_front": "multimodal_isic_tpu_torch/csrc/fused_front.cu",
          "fused_ln_mlp_backward":
              "multimodal_isic_tpu_torch/csrc/fused_ln_mlp_bwd.cu",
          "firstorder_accumulate":
              "multimodal_isic_tpu_torch/csrc/firstorder.cu",
          "fused_mlp": "multimodal_isic_tpu_torch/csrc/fused_mlp.cu"}
REPLACES = {"dw_silu_pool": "multimodal_isic_tpu/ops/fused_dwconv.py:272",
            "expand_dw_silu_pool": "multimodal_isic_tpu/ops/fused_dwconv.py:326",
            "affine_warp_batch": "multimodal_isic_tpu/ops/pallas_warp.py:190",
            # no pallas_call: the JAX colour jitter is plain jnp
            "color_jitter_batch": "none (multimodal_isic_tpu/data/augment.py:331,"
                                  " plain jnp)",
            "glcm_matrices": "multimodal_isic_tpu/ops/pallas_glcm.py:95",
            "glrlm_runs": "multimodal_isic_tpu/ops/pallas_glrlm.py:105",
            "joint_histogram": "multimodal_isic_tpu/ops/pallas_hist.py:81",
            "connected_components": "multimodal_isic_tpu/ops/pallas_cc.py:148",
            "fused_ln_mlp": "multimodal_isic_tpu/ops/fused_mlp.py:196",
            "flash_attention": "multimodal_isic_tpu/ops/attention.py:93",
            "fused_front": "multimodal_isic_tpu/ops/fused_convblock.py:146",
            "fused_ln_mlp_backward": "multimodal_isic_tpu/ops/fused_mlp.py:312",
            "firstorder_accumulate": "multimodal_isic_tpu/ops/pallas_hist.py:175",
            "fused_mlp": "multimodal_isic_tpu/ops/fused_mlp.py:98"}
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
# Colour jitter kernel vs its plain version, 0..255 scale, as
# tests/test_torch_cuda_kernels.py::JITTER_ATOL: each operation rounds as
# the plain version's does; gray's three products are summed in another
# order and the mean is a float64 sum against a float32 reduction, errors of
# ~6e-5 that four steps carry in at most x2 each.
JITTER_ATOL = 1e-3
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


def _cu(lib, name, *args):
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUresult {rc}")


def device_launches(fn):
    """Names of the device activities (kernels, memsets, copies) of one call
    of ``fn``: the call is captured in a CUDA graph and the graph's nodes
    are read through libcuda (a kernel node by its function's
    mangled name, else "memset" or "memcpy").  Unlike a torch.profiler
    trace, which can lose a call's activity, the capture holds every
    launch.  The capture runs on one side stream, on which ``fn`` is called
    once before, so it holds no first-use setup (a wrapper's state made for
    a new stream, such as MBConv's pool counters)."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    vp, ptr = ctypes.c_void_p, ctypes.byref
    if device_launches.stream is None:
        device_launches.stream = torch.cuda.Stream()
    stream = device_launches.stream
    torch.cuda.synchronize()
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    handle = vp(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    _cu(cu, "cuGraphGetNodes", handle, None, ptr(count))
    nodes = (vp * count.value)()
    _cu(cu, "cuGraphGetNodes", handle, nodes, ptr(count))
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        _cu(cu, "cuGraphNodeGetType", vp(node), ptr(kind))
        if kind.value in (1, 2):  # CU_GRAPH_NODE_TYPE_MEMCPY, _MEMSET
            names.append(("memcpy", "memset")[kind.value - 1])
        elif kind.value == 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            # CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern at byte 56
            params = (ctypes.c_byte * 256)()
            _cu(cu, "cuGraphKernelNodeGetParams_v2", vp(node), params)
            func = vp.from_buffer(params, 0).value
            kern = vp.from_buffer(params, 56).value
            name = ctypes.c_char_p()
            if func:
                _cu(cu, "cuFuncGetName", ptr(name), vp(func))
            else:
                _cu(cu, "cuKernelGetName", ptr(name), vp(kern))
            names.append(name.value.decode())
    del graph
    torch.cuda.synchronize()
    return names


device_launches.stream = None


def check_kernels(device, bsz=BATCH):
    """Every distinct slice geometry, bf16 and f32: kernel vs plain, the same
    bits of y and pool on a rerun, and (bf16) one device launch a call with
    no memset."""
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
            y2, pool2 = fn(*args)
            same = bool(torch.equal(y2, y) and torch.equal(pool2, pool))
            one = True
            if dtype == torch.bfloat16:
                names = device_launches(lambda: fn(*args))
                one = len(names) == 1 and "mbconv" in names[0]
            plan = fd.mbconv_plan(bsz, h, h, cin, cmid, k, dtype,
                                  kind == "expand")
            label = f"{kind:6s} {h}²·{cin}→{cmid} k{k} bs{bsz} {str(dtype)[6:]}"
            print(f"check {label}: max_abs_err y {ey:.3e} pool {ep:.3e}; "
                  f"rerun {'same bits' if same else 'DIFFERENT BITS'}"
                  + ("" if dtype != torch.bfloat16 else
                     f"; launches {names}") + f"; plan {plan} "
                  f"({'ok' if oky and okp and same and one else 'FAIL'})")
            if dtype == torch.bfloat16:
                name = fn.__name__
                worst[name] = max(worst[name], ey)
            if not (oky and okp and same and one):
                failures.append(label)
    if failures:
        raise AssertionError(f"kernel vs plain, rerun or launches: {failures}")
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
    """Per-geometry kernel vs plain time (ms) at batch ``bsz``, with the
    bound and its share, and the per-forward totals over the blocks that use
    each geometry: kernel, plain, bound, and the bound's bytes and
    operations parts."""
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
    for name, (ker, pln, bnd, _, _) in totals.items():
        print(f"time {name} a serving forward bs{bsz} {str(dtype)[6:]}: "
              f"kernel {ker:.4f} ms, plain {pln:.4f} ms, bound {bnd:.4f} ms "
              f"({bnd / ker:.1%} of it)")
    return totals


def _ssr_affines(cases, h, w, device):
    """(dx, dy, scale, angle°) cases → inverse affines [B, 6] on ``device``."""
    from multimodal_isic_tpu_torch.data.augment import ssr_inverse
    dx, dy, sc, an = (torch.tensor([c[i] for c in cases], dtype=torch.float32,
                                   device=device) for i in range(4))
    return ssr_inverse(h, w, dx, dy, sc, an)


def check_warp(device, bsz=BATCH):
    """Warp kernel vs its plain version and vs grid_sample: the policy's
    draws at bs 16 and 128, 380², and its domain corners, the identity,
    overhangs beyond 128 px and an odd non-square size → worst error vs
    plain."""
    from multimodal_isic_tpu_torch.data.augment import ssr_draw, ssr_inverse
    from multimodal_isic_tpu_torch.ops import affine_warp as aw
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    corners = [(sx * 0.05, sy * 0.05, sc, sa * 15.0) for sx in (-1, 1)
               for sy in (-1, 1) for sc in (0.9, 1.1) for sa in (-1, 1)]
    cases = {"policy draws": None, "policy draws bs 128": None,
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
        if label.startswith("policy draws"):
            d = ssr_draw(g, LARGE_BATCH if label.endswith("128") else bsz)
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


def _jitter_call(cj, imgs, d):
    return cj.color_jitter_batch(imgs, d["apply"], d["brightness"],
                                 d["contrast"], d["saturation"], d["hue"],
                                 d["perm"])


def check_jitter(device):
    """Colour jitter kernel vs its plain version at the main path's shapes,
    bs 16 and 128 × 380², on ``color_jitter_draw``'s draws: within
    ``JITTER_ATOL``, images not drawn and a rerun bit for bit, one launch a
    call → worst error."""
    from multimodal_isic_tpu_torch.data.augment import color_jitter_draw
    from multimodal_isic_tpu_torch.ops import color_jitter as cj
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    print(f"colour jitter kernel, 0..255 scale, max_abs_err tolerance vs "
          f"plain {JITTER_ATOL}")
    worst, failures = 0.0, []
    for bsz in (BATCH, LARGE_BATCH):
        d = color_jitter_draw(g, bsz)
        imgs = torch.rand(bsz, IMG, IMG, 3, generator=g, device=device) * 255
        imgs[::2] = imgs[::2].round()  # ties between channels, 0 and 255
        before = cj.color_jitter_batch.launches
        out = _jitter_call(cj, imgs, d)
        again = _jitter_call(cj, imgs, d)
        calls = cj.color_jitter_batch.launches - before
        ref = cj.color_jitter_reference(imgs, d)
        err = float((out - ref).abs().max())
        same = torch.equal(out, again)
        kept = torch.equal(out[~d["apply"]], imgs[~d["apply"]])
        ok = err <= JITTER_ATOL and same and kept and calls == 2
        print(f"check jitter bs{bsz} {IMG}² ({int(d['apply'].sum())} drawn): "
              f"max_abs_err vs plain {err:.3e}; not drawn "
              f"{'same bits' if kept else 'CHANGED'}; rerun "
              f"{'same bits' if same else 'DIFFERENT BITS'}; {calls} launches "
              f"in 2 calls ({'ok' if ok else 'FAIL'})")
        worst = max(worst, err)
        if not ok:
            failures.append(bsz)
    if failures:
        raise AssertionError(f"jitter out of tolerance or unstable at bs "
                             f"{failures}")
    return worst


def jitter_bound_ms(bsz, h, w):
    """(bytes ms, operations ms) of one jitter call: the batch read once
    and written once; the operations are not counted (a few hundred float32
    operations a pixel in the hue step, far under the bytes' time)."""
    return 2 * bsz * h * w * 3 * 4 / HBM_BPS * 1e3, 0.0


def time_jitter(device):
    """Colour jitter kernel vs its plain version at bs 16 and 128 × 380² on
    the policy's draws, in the order plain, kernel, kernel, plain → {bsz:
    (medians ms, bound ms, bytes ms, operations ms)}."""
    from multimodal_isic_tpu_torch.data.augment import color_jitter_draw
    from multimodal_isic_tpu_torch.ops import color_jitter as cj
    from multimodal_isic_tpu_torch.utils.profiling import timeit_closed
    g = torch.Generator(device=device).manual_seed(SEED + 4)
    times = {}
    for bsz in (BATCH, LARGE_BATCH):
        d = color_jitter_draw(g, bsz)
        imgs = torch.rand(bsz, IMG, IMG, 3, generator=g, device=device) * 255
        fns = {"kernel": lambda: _jitter_call(cj, imgs, d),
               "plain": lambda: cj.color_jitter_reference(imgs, d)}
        t = {k: [] for k in fns}
        for name in ("plain", "kernel", "kernel", "plain"):
            t[name].append(timeit_closed(fns[name], iters=20, repeats=5))
        med = {k: min(r["median"] for r in v) * 1e3 for k, v in t.items()}
        b_bytes, b_ops = jitter_bound_ms(bsz, IMG, IMG)
        times[bsz] = (med, max(b_bytes, b_ops), b_bytes, b_ops)
        print(f"time jitter bs{bsz} {IMG}² f32 ({int(d['apply'].sum())} "
              f"drawn): kernel {med['kernel']:.4f} ms, plain "
              f"{med['plain']:.4f} ms; bound {b_bytes:.4f} ms (bytes): "
              f"{b_bytes / med['kernel']:.1%} of it")
    return times


def empty_model(device, **cfg):
    """A fusion net laid out on ``device`` without initialising it (its
    state dict is loaded next)."""
    from multimodal_isic_tpu_torch.models.fusion import MultiModalFusionNet
    with torch.device("meta"):
        model = MultiModalFusionNet(**cfg)
    return model.to_empty(device=device)


def train_slice(device, test_reqs):
    """The training path at full width → ({warp, jitter: launches},
    the train dataset)."""
    from multimodal_isic_tpu_torch.core import checkpoint
    from multimodal_isic_tpu_torch.core.early_stopping import EarlyStopping
    from multimodal_isic_tpu_torch.core.rng import RngPool
    from multimodal_isic_tpu_torch.core.splits import StratifiedKFold
    from multimodal_isic_tpu_torch.data.augment import (POLICIES,
                                                        preprocess_eval_batch)
    from multimodal_isic_tpu_torch.data.pipeline import DeviceDataset
    from multimodal_isic_tpu_torch.models.fusion import fold_fusion_params
    from multimodal_isic_tpu_torch.ops import affine_warp as aw
    from multimodal_isic_tpu_torch.ops import color_jitter as cj
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

    aw.affine_warp_batch.launches = cj.color_jitter_batch.launches = 0
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
    launches = {"affine_warp_batch": aw.affine_warp_batch.launches,
                "color_jitter_batch": cj.color_jitter_batch.launches}
    print(f"warp and jitter launches in training: {launches} over {n_steps} "
          f"train steps")
    if set(launches.values()) != {n_steps}:
        raise AssertionError(f"launches {launches} != {n_steps} steps")

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
    ("GLCM kernel", ("glcm_",)),
    ("GLRLM runs kernel", ("runs_band",)),
    ("joint histogram kernel", ("joint_hist",)),
    ("connected-components kernels", ("cc_tile", "cc_border", "cc_flatten")),
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
    host-clock window) and the kernel time by family, per call → those
    numbers (ms, launches and busy share a call)."""
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
    return {"wall_ms": wall / steps, "busy_ms": busy / steps,
            "launches": len(kernels) / steps, "busy_share": busy / wall}


def kernel_breakdown(fn, label, pattern, calls=3):
    """Device ms a launch of each kernel whose name matches ``pattern``, where
    one call of ``fn`` launches each of them once: torch.profiler traces one
    call at a time (up to 3·``calls`` traces) and the mean is over the first
    ``calls`` traces that recorded every kernel of the call once, so no
    launch the trace lost is averaged over.  Prints how many traces were
    complete."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    traces = []
    for _ in range(3 * calls):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.events():
            hit = re.search(pattern, e.name)
            if e.device_type == DeviceType.CUDA and hit:
                per.setdefault(hit.group(0), []).append(
                    e.time_range.elapsed_us() / 1e3)
        traces.append(per)
        names = set().union(*traces)
        full = [t for t in traces
                if set(t) == names and all(len(v) == 1 for v in t.values())]
        if len(full) >= calls:
            break
    full = full[:calls]
    if not full:
        print(f"kernels of {label}: no trace of {len(traces)} recorded every "
              "launch of a call")
        return
    ms = {k: sum(t[k][0] for t in full) / len(full) for k in names}
    print(f"kernels of {label}, device ms a launch (sum "
          f"{sum(ms.values()):.4f}; mean over {len(full)} complete traces of "
          f"{len(traces)}): " + ", ".join(
              f"{k} {v:.4f}"
              for k, v in sorted(ms.items(), key=lambda kv: -kv[1])))


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
    one gray level over the whole frame (600-px runs), the serpentine (one
    zone that bends every row, so it crosses every border between tile
    rows) and the vertical serpentine (it bends every column, so it crosses
    every border between tile columns)."""
    g = torch.Generator(device=device).manual_seed(SEED + 8)
    rand = torch.randint(1, 7, (h, w), generator=g, device=device,
                         dtype=torch.int32)
    snake = torch.zeros((h, w), dtype=torch.bool, device=device)
    snake[0::2] = True
    for r in range(1, h, 2):
        snake[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    vsnake = torch.zeros((h, w), dtype=torch.bool, device=device)
    vsnake[:, 0::2] = True
    for c in range(1, w, 2):
        vsnake[h - 1 if (c // 2) % 2 == 0 else 0, c] = True
    levels = torch.stack([torch.zeros_like(rand), rand, torch.ones_like(rand),
                          torch.where(snake, 7, 2).to(torch.int32),
                          torch.where(vsnake, 7, 2).to(torch.int32)])
    mask = torch.full((5, h, w), 255, dtype=torch.uint8, device=device)
    mask[0] = 0
    return levels, mask


def check_radiomics_kernels(device, rgb, masks):
    """Each radiomics kernel against its plain version, bit for bit: on a
    real chunk's derived images (M = 64 maps of 450×600: original, LoG σ 3,
    wavelet-HH) and on the full-frame edge cases (empty mask, full frame,
    single level, a run longer than the histogram's length range, both
    serpentines, each one zone) → worst |kernel − plain| per kernel (must
    be 0)."""
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
    for k, which in ((3, "serpentine"), (4, "vertical serpentine")):
        snake = outs["connected_components"][0][k][levels[k] == 7]
        if snake.unique().numel() != 1:
            failures.append(f"the {which} is not one zone")
    if failures:
        raise AssertionError(f"radiomics kernel != plain: {failures}")
    return worst


def check_radiomics_capture(device, levels, mask):
    """B4, B5 and B7 captured in one CUDA graph on a stream that had no
    eager call before (B5's stream state is made inside the capture),
    replayed 3 times on the chunk's original-image maps: every replay bit
    for bit equal to the plain versions."""
    from multimodal_isic_tpu_torch.ops import connected_components as C
    from multimodal_isic_tpu_torch.ops import glcm as G
    from multimodal_isic_tpu_torch.ops import glrlm_runs as R
    inside = mask > 0
    want = (G.glcm_matrices_reference(levels, mask),
            R.glrlm_runs_reference(levels, inside),
            C.connected_components_reference(levels, inside))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        outs = (G.glcm_matrices(levels, mask), R.glrlm_runs(levels, inside),
                C.connected_components(levels, inside))
    same = []
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        same.append([torch.equal(o, w) for o, w in zip(outs, want)])
    print(f"radiomics kernels in a CUDA graph ({tuple(levels.shape)}), 3 "
          f"replays, equal to plain (glcm, runs, cc): {same}")
    if not all(all(r) for r in same):
        raise AssertionError(f"captured radiomics kernels != plain: {same}")


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
    labels, float32 histograms and stats; the first-order image float32);
    about 10 32-bit integer operations per element, counted at the float32
    CUDA-core rate."""
    px = m * h * w
    nbytes = {"glcm_matrices": px * 5 + m * 4 * NG * NG * 4,
              "glrlm_runs": px * 5 + px * 4 * 4,
              "joint_histogram": 4 * px * 8 + 4 * m * NG * MAX_LEN * 4,
              "connected_components": px * 5 + px * 4,
              "firstorder_accumulate": px * 8 + m * (9 + NG) * 4}[name]
    elems = 4 * px if name in ("glrlm_runs", "joint_histogram") else px
    return nbytes / HBM_BPS * 1e3, 10 * elems / F32_FLOPS * 1e3


def rad_chunk_kernels(fn, label):
    """Device ms and launches of each radiomics kernel in one traced call of
    ``fn`` (a chunk's extraction), printed; a trace that recorded no device
    activity at all is taken again, up to 5 times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pats = {"glcm_matrices": ("glcm_",), "glrlm_runs": ("runs_band",),
            "joint_histogram": ("joint_hist",),
            "connected_components": ("cc_tile", "cc_border", "cc_flatten")}
    fn()
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ev:
            break
    out = {}
    for name, keys in pats.items():
        hits = [e for e in ev if any(k in e.name for k in keys)]
        out[name] = (sum(e.time_range.elapsed_us() for e in hits) / 1e3,
                     len(hits))
    print(f"radiomics kernels of {label} (device ms, launches): " + ", ".join(
        f"{k} {ms:.3f} ms in {n}" for k, (ms, n) in out.items()))
    return out


def time_radiomics(device, rgb, masks):
    """Each radiomics kernel at the path's shapes (one chunk's original
    image: M = 64 maps of 450×600) against its plain version and, where one
    PyTorch call computes the same function, that call (torch.bincount over
    the packed keys of the counted pairs, the keys built inside the timed
    call); B4, B7 and B5, whose time depends on the data, also on the
    chunk's LoG σ 3 and wavelet-HH images (the ``kernels`` line keeps the
    original image's); then extraction img/s on the kernel and plain paths, peak
    device memory, a profile of one chunk by kernel family, and each
    radiomics kernel's device time and launches in one chunk."""
    from multimodal_isic_tpu_torch.analysis.radiomics import RadiomicsExtractor
    from multimodal_isic_tpu_torch.ops import histogram as Hm
    from multimodal_isic_tpu_torch.ops.texture import ANGLES_2D, shift2d
    from multimodal_isic_tpu_torch.utils.profiling import timeit_closed
    fns = _rad_fns()
    by_type = _rad_chunk_levels(device, rgb[:RAD_CHUNK], masks[:RAD_CHUNK])
    levels, m4 = by_type["original"]
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
    cases = [(name, "original", args[name]) for name in RAD_KERNELS]
    cases += [(name, t, (lv, mk) if name == "glcm_matrices" else (lv, mk > 0))
              for t, (lv, mk) in by_type.items() if t != "original"
              for name in ("glcm_matrices", "connected_components",
                           "glrlm_runs")]
    for name, label, a in cases:
        kern, ref = fns[name]
        runs = {"kernel": [], "plain": [], "library": []}
        order = ["plain", "kernel", "kernel", "plain"]
        if name in library and label == "original":
            order += ["library", "library"]
        for which in order:
            fn = {"kernel": lambda: kern(*a), "plain": lambda: ref(*a),
                  "library": library.get(name)}[which]
            iters = 20 if which == "kernel" else 3
            runs[which].append(timeit_closed(fn, iters=iters, repeats=3))
        med = {k: min(r["median"] for r in v) * 1e3 for k, v in runs.items() if v}
        b_bytes, b_ops = rad_bound_ms(name, m, h, w)
        bound = max(b_bytes, b_ops)
        if label == "original":
            out[name] = (med["kernel"], med["plain"], bound, b_bytes, b_ops,
                         med.get("library"))
        lib = (f", library {med['library']:.4f} ms" if "library" in med
               else ", library none")
        print(f"time {name} on {label} M{m} {h}x{w}: kernel "
              f"{med['kernel']:.4f} ms, plain {med['plain']:.4f} ms "
              f"({med['plain'] / med['kernel']:.1f}x){lib}; bound "
              f"{bound:.4f} ms (bytes {b_bytes:.4f}, operations "
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
    rad_chunk_kernels(lambda: exs["kernel"]._extract(*chunk),
                      f"a chunk of {RAD_CHUNK}, kernel path")
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
        before = fn.launches
        got = fn(*args)
        want = ref(*args)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == dtype
        err, ok = _allclose_err(got, want, *tol[name][dtype])
        worst[name] = max(worst[name], err)
        label = f"{name} {geo} {str(dtype)[6:]}"
        how = ""
        if name != "flash_attention":  # the conv-stage kernels' plans
            same = torch.equal(fn(*args), got)
            calls = fn.launches - before
            ok = ok and same and calls == 2
            how = (f"; a rerun gives {'the same' if same else 'OTHER'} bits; "
                   f"{calls} launches in 2 calls")
        print(f"check {label}: max_abs_err {err:.3e}{how} "
              f"({'ok' if ok else 'FAIL'})")
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
        extract_latent_bundle, extract_latent_tables)
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
    tr, te, b_tr, b_te, pca = extract_latent_tables(
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
    products (TF32 off) and the depthwise taps on the CUDA cores.
    Attention's p·v in bf16 has float32 p, which the kernel carries as two
    bf16 products (p split into hi + lo, ``attention.split_bf16``): it is
    counted as those two tensor-core products, so the bound is the least
    time of the work as the kernel does it."""
    bf = dtype == torch.bfloat16
    esz = 2 if bf else 4
    if name == "flash_attention":
        b, h, n, d = geo
        qk = pv = 2 * b * h * n * n * d
        return (4 * b * h * n * d * esz / HBM_BPS * 1e3,
                ops_ms(bf16=qk + 2 * pv) if bf else ops_ms(f32=qk + pv))
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


def _graphed(fn, calls):
    """``calls`` calls of ``fn`` captured in one CUDA graph after a warm-up
    call → a function that replays them: the device's time without the
    host's launch overhead, which a small call (attention in the validation
    forward) would otherwise measure."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    return graph.replay


def _time_interleaved(kernel, plain, library=None, kernel_iters=10,
                      plain_iters=3, graph=False):
    """Median ms a call of ``kernel`` and ``plain`` (and ``library``), timed
    in turns plain, kernel, kernel, plain (then library, library) on one
    card, each the best of its turns' medians.  ``graph``: each turn replays
    a CUDA graph of its calls (:func:`_graphed`), so the time is the
    device's alone."""
    from multimodal_isic_tpu_torch.utils.profiling import timeit_closed
    fns = {"kernel": kernel, "plain": plain, "library": library}
    order = ["plain", "kernel", "kernel", "plain"]
    if library is not None:
        order += ["library", "library"]
    runs = {}
    for which in order:
        iters = kernel_iters if which == "kernel" else plain_iters
        if graph:
            t = timeit_closed(_graphed(fns[which], iters), iters=1, repeats=3)
            t = {k: v / iters for k, v in t.items() if k != "all"}
        else:
            t = timeit_closed(fns[which], iters=iters, repeats=3)
        runs.setdefault(which, []).append(t)
    return {k: min(r["median"] for r in v) * 1e3 for k, v in runs.items()}


def _graph_ms(fn, calls=10):
    """Device ms a call of ``fn``: ``calls`` calls in one CUDA graph
    (:func:`_graphed`), the median of 3 replays timed with CUDA events."""
    from multimodal_isic_tpu_torch.utils.profiling import timeit_closed
    t = timeit_closed(_graphed(fn, calls), iters=1, repeats=3)
    return t["median"] * 1e3 / calls


def _two_products(name, dtype, geo, device, g):
    """The conv-stage kernel's two products alone, ``torch.matmul`` in the
    kernel's dtype on random operands of the call's shapes (fused LN-MLP:
    y·w1 [M, C]·[C, 4C] and a·w2; fused front: the two C×C 1×1s): a
    yardstick of how far the fused kernel is from the unfused products it
    must beat, timed here and used nowhere in the port."""
    b, hw, c = geo[:3]
    m, f = b * hw * hw, (4 * c if name == "fused_ln_mlp" else c)
    rn = lambda *s: torch.randn(*s, generator=g, device=device).to(dtype)
    y, w1, a, w2 = rn(m, c), rn(c, f), rn(m, f), rn(f, c)
    return lambda: (torch.matmul(y, w1), torch.matmul(a, w2))


def _sdpa_f32(args):
    """``F.scaled_dot_product_attention`` on float32 copies of q, k, v: the
    one PyTorch call that computes attention's function (a yardstick only;
    the port never calls it)."""
    import torch.nn.functional as F
    qf, kf, vf = (t.float().contiguous() for t in args)
    return lambda: F.scaled_dot_product_attention(qf, kf, vf)


def time_mae(device, crops, masks, val_imgs, val_draws):
    """Each ConvMAE kernel against its plain version (and attention against
    ``F.scaled_dot_product_attention``) at the bs 128 bf16 extraction
    shapes, and all three at the validation forward's float32 shapes, with
    each call's device time from CUDA-graph replays beside (the LN-MLP and
    the front also beside their two products alone as ``torch.matmul``, a
    yardstick);
    encoder img/s at bs 128 bf16 on the kernel, plain and flash + front
    paths; the validation forward at bs 16 float32; peak memory and
    profiles.  → per kernel (ms, plain ms, bound ms, bytes ms, operations
    ms, library ms) per forward."""
    from multimodal_isic_tpu_torch.data.augment import mae_eval_batch
    from multimodal_isic_tpu_torch.train.mae import (make_encoder_step,
                                                     make_mae_eval_step)
    from multimodal_isic_tpu_torch.utils.profiling import timeit_closed
    fns = _mae_fns()
    g = torch.Generator(device=device).manual_seed(SEED + 25)
    bf, f32 = torch.bfloat16, torch.float32
    per_fw = {"fused_ln_mlp": [((LAT_BATCH, 56, 256), 2), ((LAT_BATCH, 28, 384), 2)],
              "flash_attention": [((LAT_BATCH, 12, 196, 64), 11)],
              "fused_front": [((LAT_BATCH, 56, 256, False), 2),
                              ((LAT_BATCH, 28, 384, False), 2)]}
    # attention in the validation forward (bs 16 f32): 11 encoder calls at
    # N 49 (mask 0.75), 8 decoder calls at N 196, D 32
    val_fw = [((VAL_BATCH, 12, 49, 64), 11), ((VAL_BATCH, 16, 196, 32), 8)]
    jobs = [(name, bf, geos, "an encoder forward at bs 128 bf16")
            for name, geos in per_fw.items()]
    val_path = f"a validation forward at bs {VAL_BATCH} f32"
    jobs.append(("flash_attention", f32, val_fw, val_path))
    # the conv stages of the validation forward (bs 16 f32, with keep)
    jobs.append(("fused_ln_mlp", f32, [((VAL_BATCH, 56, 256), 2),
                                       ((VAL_BATCH, 28, 384), 2)], val_path))
    jobs.append(("fused_front", f32, [((VAL_BATCH, 56, 256, True), 2),
                                      ((VAL_BATCH, 28, 384, True), 2)],
                 val_path))
    out = {}
    for name, dtype, geos, path in jobs:
        kern, ref = fns[name]
        tot = [0.0] * 5 + [None]
        dev = {}  # attention's device time a path (CUDA-graph replays)
        for geo, calls in geos:
            args = _mae_inputs(name, geo, dtype, device, g)
            fns3 = (lambda: kern(*args), lambda: ref(*args),
                    _sdpa_f32(args) if name == "flash_attention" else None)
            med = _time_interleaved(*fns3)
            how = ""
            if name != "flash_attention":  # device time and the yardstick
                b_bytes, b_ops = mae_bound_ms(name, dtype, geo)
                k_dev = _graph_ms(fns3[0])
                prod = _two_products(name, dtype, geo, device, g)
                p_ms = timeit_closed(prod, iters=5, repeats=3)["median"] * 1e3
                p_dev = _graph_ms(prod)
                how = (f"; device time (CUDA-graph replays): kernel "
                       f"{k_dev:.4f} ms ({max(b_bytes, b_ops) / k_dev:.1%} "
                       f"of the bound); yardstick, the two products alone as "
                       f"torch.matmul in {str(dtype)[6:]}: {p_ms:.4f} ms "
                       f"eager, {p_dev:.4f} ms device")
                for k, v in (("kernel", k_dev), ("products", p_dev),
                             ("products eager", p_ms)):
                    dev[k] = dev.get(k, 0.0) + calls * v
                del prod
            if name == "flash_attention":  # beside it, the device's time
                gr = _time_interleaved(*fns3, graph=True)
                how = (f"; device time (CUDA-graph replays): kernel "
                       f"{gr['kernel']:.4f}, plain {gr['plain']:.4f}, SDPA "
                       f"{gr['library']:.4f} ms")
                for k, v in gr.items():
                    dev[k] = dev.get(k, 0.0) + calls * v
            b_bytes, b_ops = mae_bound_ms(name, dtype, geo)
            bound = max(b_bytes, b_ops)
            lib = (f", SDPA on f32 copies {med['library']:.4f} ms"
                   if "library" in med else "")
            print(f"time {name} {geo} {str(dtype)[6:]}: kernel "
                  f"{med['kernel']:.4f} ms, plain {med['plain']:.4f} ms "
                  f"({med['plain'] / med['kernel']:.2f}x){lib}; bound "
                  f"{bound:.4f} ms (bytes {b_bytes:.4f}, operations "
                  f"{b_ops:.4f}): {bound / med['kernel']:.1%} of it; {calls} "
                  f"calls {path} (eager calls, CUDA events){how}")
            for i, v in enumerate((med["kernel"], med["plain"], bound,
                                   b_bytes, b_ops)):
                tot[i] += calls * v
            if "library" in med:
                tot[5] = (tot[5] or 0.0) + calls * med["library"]
            del args
        lib = f", SDPA {tot[5]:.4f} ms" if tot[5] is not None else ""
        if name == "flash_attention":
            how = (f"; device time (CUDA-graph replays): kernel "
                   f"{dev['kernel']:.4f}, plain {dev['plain']:.4f}, SDPA "
                   f"{dev['library']:.4f} ms: {tot[2] / dev['kernel']:.1%} of "
                   f"the bound")
        else:
            how = (f"; device time (CUDA-graph replays): kernel "
                   f"{dev['kernel']:.4f} ms: {tot[2] / dev['kernel']:.1%} of "
                   f"the bound; the two products alone (torch.matmul, "
                   f"yardstick) {dev['products eager']:.4f} ms eager, "
                   f"{dev['products']:.4f} ms device")
        print(f"time {name} per {path} (eager calls): kernel {tot[0]:.4f} ms, "
              f"plain {tot[1]:.4f} ms{lib}; bound {tot[2]:.4f} ms: "
              f"{tot[2] / tot[0]:.1%} of it{how}")
        out.setdefault(name, tot)  # the kernel line keeps the latent path

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
    type.  The kernels do those operations and no more; their workspace
    traffic (y, round(a), round(dh), dy) is their own and not in the
    bound."""
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
    step = {}  # dtype -> [kernel, plain, bound, bytes, operations] ms a step
    for dtype, m, c in b10_geometries()[:4]:
        args = _b10_inputs(dtype, m, c, device, g)
        med = _time_interleaved(lambda: FM.fused_ln_mlp_backward(*args),
                                lambda: FM.fused_ln_mlp_backward_reference(*args),
                                kernel_iters=5, plain_iters=2)
        b_bytes, b_ops = b10_bound_ms(dtype, m, c)
        bound = max(b_bytes, b_ops)
        ws = FM.ln_mlp_bwd_workspace(m, c, 4 * c, dtype)[1]
        print(f"time fused_ln_mlp_backward M {m} C {c} {str(dtype)[6:]}: "
              f"kernel {med['kernel']:.4f} ms, plain {med['plain']:.4f} ms "
              f"({med['plain'] / med['kernel']:.2f}x); bound {bound:.4f} ms "
              f"(bytes {b_bytes:.4f}, operations {b_ops:.4f}): "
              f"{bound / med['kernel']:.1%} of it; workspace "
              f"{ws / 2**20:.1f} MiB; library: none (no one PyTorch call "
              f"computes this function); 2 calls a step")
        kernel_breakdown(lambda: FM.fused_ln_mlp_backward(*args),
                         f"fused_ln_mlp_backward M {m} C {c} "
                         f"{str(dtype)[6:]}", r"ln_mlp_bwd_\w+")
        for i, v in enumerate((med["kernel"], med["plain"], bound, b_bytes,
                               b_ops)):
            step.setdefault(dtype, [0.0] * 5)[i] += 2 * v
        del args
    for dtype, (ker, pln, bnd, _, _) in step.items():
        bsz = VAL_BATCH if dtype == torch.float32 else MAE_LARGE_BATCH
        print(f"time fused_ln_mlp_backward per train step bs{bsz} "
              f"{str(dtype)[6:]} (4 calls): kernel {ker:.4f} ms, plain "
              f"{pln:.4f} ms; bound {bnd:.4f} ms: {bnd / ker:.1%} of it")

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
    return step[torch.float32] + [None]  # the slice's step: bs 16 float32


# -------------------------------------------- first order and the bare MLP

def firstorder_inputs(device, rgb, masks):
    """The radiomics chunk's first-order calls: for each of the 13 derived
    images, image [M, H·W] float32 and levels [M, H·W] int32 (M = 64 maps of
    450×600), as the extractor computes them."""
    from multimodal_isic_tpu_torch.analysis.radiomics import (
        RadiomicsExtractor, full_float32)
    from multimodal_isic_tpu_torch.ops import filters as FB
    from multimodal_isic_tpu_torch.ops import texture as T
    ex = RadiomicsExtractor(device=device)
    with torch.no_grad(), full_float32():
        chans, m4, _ = ex._prep(torch.from_numpy(rgb).to(device),
                                torch.from_numpy(masks).to(device))
        bank = FB.filter_bank(chans)
        m = chans.shape[0]
        return {t: (img.float().reshape(m, -1).contiguous(),
                    T.discretize(img, m4, 10.0)[0].reshape(m, -1).contiguous())
                for t, img in bank.items()}


def _firstorder_edge_cases(device, n=SRC_HW[0] * SRC_HW[1]):
    """(label, image, levels) of full-frame edge maps: an empty ROI, one
    valid pixel, codes in (NG, 128] and above 128 (negative codes too), and
    the scalar-load path (an odd row length, rows off a 16-byte boundary)."""
    g = torch.Generator(device=device).manual_seed(SEED + 50)
    x = torch.randn(4, n + 1, generator=g, device=device) * 40 + 90
    lv = torch.randint(-3, 200, (4, n + 1), generator=g, device=device,
                       dtype=torch.int32)
    lv[0] = 0
    lv[1] = 0
    lv[1, n // 3] = 9
    flat_x, flat_lv = x.reshape(-1)[1:], lv.reshape(-1)[1:]
    return [("empty, one pixel, high codes", x[:3, :n].contiguous(),
             lv[:3, :n].contiguous()),
            ("odd rows", x[:, :n - 1].contiguous(), lv[:, :n - 1].contiguous()),
            ("rows off 16 bytes", flat_x[:3 * n].view(3, n),
             flat_lv[:3 * n].view(3, n))]


FO_LARGE = (4, 1000 * 1000)  # maps past the cluster path's capacity: two-pass
PARENT_ROOT = Path(__file__).resolve().parent / "build" / "parent"


def _firstorder_large(device):
    """(label, image, levels) of 4 maps of 1000×1000 (more pixels than one
    thread-block cluster of ``histogram.firstorder_plan`` keeps): map 0 an
    empty ROI, map 1 one valid pixel, the rest ~60% valid with codes in
    1..NG, (NG, 128], above 128 and negative."""
    g = torch.Generator(device=device).manual_seed(SEED + 53)
    b, n = FO_LARGE
    x = torch.randn(b, n, generator=g, device=device) * 40 + 90
    lv = torch.randint(-3, 200, (b, n), generator=g, device=device,
                       dtype=torch.int32)
    lv = torch.where(torch.rand(b, n, generator=g, device=device) < 0.6, lv, 0)
    lv[0] = 0
    lv[1] = 0
    lv[1, n // 2] = 5
    return "1000x1000, the two-pass path", x, lv


def parent_kernels():
    """The parent commit's first-order and bare-MLP kernels, built from the
    checkout under ``PARENT_ROOT`` (``git archive`` of the parent unpacked
    there; absent in a plain checkout, which then times no parent) with this
    tree's nvcc flags → {name: a function with the entry point's signature,
    as the parent's wrapper called its library} or None."""
    import ctypes
    from multimodal_isic_tpu_torch.ops import _build
    csrc = PARENT_ROOT / "multimodal_isic_tpu_torch" / "csrc"
    if not (csrc / "fused_mlp.cu").exists():
        return None
    out_dir = Path(__file__).resolve().parent / "build" / "parent_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)

    def build(name):
        lib = out_dir / f"{name}.so"
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(lib), str(csrc / f"{name}.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"parent {name}.cu: {proc.stderr[-2000:]}")
        return ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(2) as pool:
        fo, mlp = pool.map(build, ("firstorder", "fused_mlp"))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fo.firstorder_accumulate.argtypes = [vp, vp, vp, vp, i32, i32, vp, vp]
    fo.firstorder_workspace.argtypes = [i32, i32]
    fo.firstorder_workspace.restype = ctypes.c_longlong
    for sfx in ("f32", "bf16"):
        getattr(mlp, f"fused_mlp_{sfx}").argtypes = [vp] * 6 + [i32] * 4 + [vp]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def firstorder(x, lv):
        b, n = x.shape
        stats = torch.empty((b, 9), dtype=torch.float32, device=x.device)
        hist = torch.empty((b, 64), dtype=torch.float32, device=x.device)
        ws = torch.empty(fo.firstorder_workspace(b, n), dtype=torch.uint8,
                         device=x.device)
        rc = fo.firstorder_accumulate(x.data_ptr(), lv.data_ptr(),
                                      stats.data_ptr(), hist.data_ptr(), b, n,
                                      ws.data_ptr(), stream())
        if rc != 0:
            raise RuntimeError(f"parent firstorder_accumulate: error {rc}")
        return stats, hist

    def fused(x, w1, b1, w2, b2):  # the parent wrapper's transposes included
        m, c = x.shape
        f, c2 = w2.shape
        w1k = w1.t().to(x.dtype).contiguous()
        w2k = w2.t().to(x.dtype).contiguous()
        b1f, b2f = b1.float().contiguous(), b2.float().contiguous()
        out = torch.empty((m, c2), dtype=x.dtype, device=x.device)
        sfx = "bf16" if x.dtype == torch.bfloat16 else "f32"
        rc = getattr(mlp, f"fused_mlp_{sfx}")(
            x.data_ptr(), w1k.data_ptr(), b1f.data_ptr(), w2k.data_ptr(),
            b2f.data_ptr(), out.data_ptr(), m, c, f, c2, stream())
        if rc != 0:
            raise RuntimeError(f"parent fused_mlp: error {rc}")
        return out

    return {"firstorder_accumulate": firstorder, "fused_mlp": fused}


def mlp_geometries():
    """(dtype, M, C, F, C2) of the bare MLP's calls: ConvViT-Base's conv
    stages 1 (C 256 → F 1024 → 256, M = B·56²) and 2 (384 → 1536 → 384,
    M = B·28²) at bs 16 float32 and bs 128 bf16, and C2 ≠ C at an M that is
    no multiple of either row tile."""
    f32, bf = torch.float32, torch.bfloat16
    return [(f32, VAL_BATCH * 56 * 56, 256, 1024, 256),
            (f32, VAL_BATCH * 28 * 28, 384, 1536, 384),
            (bf, LAT_BATCH * 56 * 56, 256, 1024, 256),
            (bf, LAT_BATCH * 28 * 28, 384, 1536, 384),
            (f32, 1000, 128, 512, 256), (bf, 1000, 128, 512, 256)]


def _mlp_args(geo, device, g):
    dtype, m, c, f, c2 = geo
    rn = lambda *s: torch.randn(*s, generator=g, device=device)
    return (rn(m, c).to(dtype), (rn(c, f) / c ** 0.5).to(dtype),
            (0.1 * rn(f)).to(dtype), (rn(f, c2) / f ** 0.5).to(dtype),
            (0.1 * rn(c2)).to(dtype))


def mlp_bound_ms(dtype, m, c, f, c2):
    """(bytes ms, operations ms) of one bare-MLP call: x, both weights, the
    biases and the output moved once; 2·M·(C·F + F·C2) operations at the
    rate of their operands' type."""
    esz = 2 if dtype == torch.bfloat16 else 4
    nbytes = (m * c + c * f + f * c2 + f + c2 + m * c2) * esz
    ops = 2 * m * (c * f + f * c2)
    return (nbytes / HBM_BPS * 1e3,
            ops_ms(bf16=ops) if dtype == torch.bfloat16 else ops_ms(f32=ops))


def _kernel_names(fn, keys):
    """Device kernels of one captured call of ``fn`` whose names hold one
    of ``keys``."""
    return [n for n in device_launches(fn) if any(k in n for k in keys)]


def firstorder_and_mlp(device, fo_inputs):
    """Phase 12: the two kernels' own entry points, driven once with the
    launch counts at 0 (the 13 first-order calls of a radiomics chunk; the
    bare MLP at every geometry), then each result held against its plain
    version (first order: n, min, max and hist equal, the sums within
    SUM_TOL of their magnitude; the MLP within ``fused_mlp.TOL``), the same
    bits on a rerun, the first-order edge cases and a map past the cluster
    path's capacity (the two-pass path), the plans' paths and device
    launches a call, the first-order stats against the port's own
    ``firstorder_features``, and the MLP's gradients → (launches, worst
    |kernel − plain| per kernel)."""
    from multimodal_isic_tpu_torch.ops import fused_mlp as FM
    from multimodal_isic_tpu_torch.ops import histogram as Hm
    from multimodal_isic_tpu_torch.ops import texture as T
    g = torch.Generator(device=device).manual_seed(SEED + 51)
    mlp_args = [_mlp_args(geo, device, g) for geo in mlp_geometries()]
    torch.cuda.synchronize()

    Hm.firstorder_accumulate.launches = 0
    FM.fused_mlp.launches = 0
    fo_out = {t: Hm.firstorder_accumulate(*a) for t, a in fo_inputs.items()}
    mlp_out = [FM.fused_mlp(*a) for a in mlp_args]
    torch.cuda.synchronize()
    launches = {"firstorder_accumulate": Hm.firstorder_accumulate.launches,
                "fused_mlp": FM.fused_mlp.launches}
    print(f"phase 12 main path: {len(fo_inputs)} first-order calls of one "
          f"radiomics chunk, {len(mlp_args)} bare-MLP calls; launches "
          f"{launches}")
    if launches != {"firstorder_accumulate": len(fo_inputs),
                    "fused_mlp": len(mlp_args)}:
        raise AssertionError(f"phase 12 launches {launches}")

    failures = []
    worst = {"firstorder_accumulate": 0.0, "fused_mlp": 0.0}
    print(f"firstorder_accumulate vs plain: n, min, max and hist equal, "
          f"each sum within SUM_TOL {Hm.SUM_TOL} of its magnitude sum")
    cases = [(t, *fo_inputs[t], fo_out[t]) for t in fo_inputs]
    cases += [(label, x, lv, Hm.firstorder_accumulate(x, lv))
              for label, x, lv in (*_firstorder_edge_cases(device),
                                   _firstorder_large(device))]
    for label, x, lv, got in cases:
        want = Hm.firstorder_accumulate_reference(x, lv)
        again = Hm.firstorder_accumulate(x, lv)
        exact, ratio = Hm.firstorder_disagreement(x, lv, got, want)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if label.startswith(("empty", "1000x1000")):  # map 0: sentinels, sums 0
            big = torch.tensor(3.4e38, device=device)
            st = got[0][0]
            exact = exact and bool(st[2] == big and st[3] == -big
                                   and not st[list(Hm.SUMS)].any())
        err = float((got[0] - want[0]).abs()[:, list(Hm.SUMS)].max())
        worst["firstorder_accumulate"] = max(worst["firstorder_accumulate"],
                                             err)
        plan = Hm.firstorder_plan(*x.shape)
        path_ok = plan["path"] == ("two_pass" if label.startswith("1000x1000")
                                   else "cluster")
        ok = exact and ratio <= 1.0 and same and path_ok
        print(f"check firstorder_accumulate {label} {tuple(x.shape)}: "
              f"{plan['path']} path, exact parts equal {exact}, worst sum "
              f"error {ratio:.3e} of its tolerance (max_abs_err {err:.3e}), "
              f"same bits on a rerun {same} ({'ok' if ok else 'FAIL'})")
        if not ok:
            failures.append(f"firstorder_accumulate {label}")
    # device launches a call: one on the cluster path, two on the two-pass
    for label, x, lv in (("the chunk's call", *fo_inputs["original"]),
                         _firstorder_large(device)):
        names = _kernel_names(lambda: Hm.firstorder_accumulate(x, lv),
                              ("firstorder",))
        want_n = Hm.firstorder_plan(*x.shape)["launches"]
        print(f"firstorder_accumulate device launches, {label}: "
              f"{len(names)} ({', '.join(sorted(set(names)))}); want {want_n}")
        if len(names) != want_n:
            failures.append(f"firstorder_accumulate launches {label}")

    # the stats against the port's own first-order features ("original")
    x, lv = fo_inputs["original"]
    stats, hist = fo_out["original"]
    m = x.shape[0]
    feats = T.firstorder_features(x.view(m, *SRC_HW),
                                  (lv > 0).view(m, *SRC_HW).to(torch.uint8),
                                  10.0)
    n = stats[:, 0].clamp_min(1.0)
    derived = {"Mean": stats[:, 1] / n, "Variance": stats[:, 5] / n,
               "MeanAbsoluteDeviation": stats[:, 8] / n,
               "Uniformity": ((hist / n[:, None]) ** 2).sum(1)}
    exact = (torch.equal(stats[:, 2], feats["Minimum"])
             and torch.equal(stats[:, 3], feats["Maximum"]))
    rel = {k: float(((v - feats[k]).abs() / feats[k].abs().clamp_min(1e-12))
                    .max()) for k, v in derived.items()}
    ok = exact and max(rel.values()) <= FEATURE_REL_TOL
    print(f"firstorder_accumulate vs texture.firstorder_features (original, "
          f"{m} maps): Minimum/Maximum equal {exact}; relative error "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (tolerance {FEATURE_REL_TOL}; {'ok' if ok else 'FAIL'})")
    if not ok:
        failures.append("firstorder_accumulate vs firstorder_features")

    print("fused_mlp vs plain tolerance |err| <= atol + rtol*|plain| "
          "(atol, rtol): " + ", ".join(f"{str(dt)[6:]} {t}"
                                       for dt, t in FM.TOL.items()))
    for geo, args, got in zip(mlp_geometries(), mlp_args, mlp_out):
        dtype, mm, c, f, c2 = geo
        want = FM.fused_mlp_reference(*args)
        again = FM.fused_mlp(*args)
        torch.cuda.synchronize()
        err, ok = _allclose_err(got, want, *FM.TOL[dtype])
        same = torch.equal(got, again)
        fin = bool(torch.isfinite(got).all()) and got.shape == (mm, c2)
        names = _kernel_names(lambda: FM.fused_mlp(*args),
                              ("mlp_wgmma", "mlp_f32"))
        plan = FM.mlp_plan(mm, c, f, c2, dtype)
        ok = ok and same and fin and len(names) == 1
        worst["fused_mlp"] = max(worst["fused_mlp"], err)
        label = f"fused_mlp M {mm} C {c} F {f} C2 {c2} {str(dtype)[6:]}"
        print(f"check {label}: plan bm {plan['bm']} fc {plan['fc']} stages "
              f"{plan['stages']} smem {plan['smem']}; max_abs_err {err:.3e}, "
              f"finite [M, C2] {fin}, same bits on a rerun {same}, device "
              f"kernels a call {len(names)} ({', '.join(names)}) "
              f"({'ok' if ok else 'FAIL'})")
        if not ok:
            failures.append(label)
        del want, again
    del mlp_out

    # the kernel's result stays on the autograd graph: its gradients are
    # the plain version's (the backward recomputes it, as the JAX _bwd does)
    leaves = [t.float().requires_grad_() for t in mlp_args[4]]
    gy = torch.randn(1000, 256, generator=g, device=device)
    out = FM.fused_mlp(*leaves)
    got = torch.autograd.grad(out, leaves, gy)
    want = torch.autograd.grad(FM.fused_mlp_reference(*leaves), leaves, gy)
    same = out.grad_fn is not None and all(
        torch.equal(a, b) for a, b in zip(got, want))
    print(f"fused_mlp under autograd on the card: grad_fn "
          f"{type(out.grad_fn).__name__}, gradients equal to the plain "
          f"version's {same}")
    if not same:
        failures.append("fused_mlp gradients")
    if failures:
        raise AssertionError(f"phase 12 kernel != plain: {failures}")
    return launches, worst


def _interleaved_medians(fns, order, iters):
    """Median ms a call of each of ``fns`` (name → function) over its turns
    in ``order`` (CUDA events, ``timeit_closed``: each turn the median of 3
    chains of ``iters[name]`` calls)."""
    from multimodal_isic_tpu_torch.utils.profiling import timeit_closed
    runs = {}
    for name in order:
        runs.setdefault(name, []).append(
            timeit_closed(fns[name], iters=iters[name], repeats=3)["median"])
    return {k: float(np.median(v)) * 1e3 for k, v in runs.items()}


def time_firstorder_and_mlp(device, fo_inputs):
    """The first-order kernel at the radiomics chunk's call (the original
    image, 64 maps of 450×600) and the bare MLP at the four conv-stage
    geometries, each against its plain version and bound, and against the
    parent commit's kernel where ``PARENT_ROOT`` holds it (turns parent,
    kernel, kernel, parent, parent, kernel: medians of 3; CUDA events); the
    MLP also against its two products alone as ``torch.matmul`` (a
    yardstick; no single PyTorch call computes either function) → name →
    (ms, plain ms, bound ms, bytes ms, operations ms, library ms).  The
    MLP's numbers are those of a ConvViT-Base encoder forward at bs 128
    bf16: two calls at stage 1 and two at stage 2."""
    from multimodal_isic_tpu_torch.ops import fused_mlp as FM
    from multimodal_isic_tpu_torch.ops import histogram as Hm
    parent = parent_kernels()
    print("parent kernels: " + (f"built from {PARENT_ROOT}" if parent else
                                "not timed (no parent checkout under "
                                f"{PARENT_ROOT})"))
    order = ["plain", "kernel", "kernel", "plain"]
    if parent:
        order = ["plain", "parent", "kernel", "kernel", "parent", "parent",
                 "kernel", "plain"]
    out = {}
    for i, (label, x, lv) in enumerate((("the chunk's call",
                                         *fo_inputs["original"]),
                                        _firstorder_large(device))):
        fns = {"kernel": lambda: Hm.firstorder_accumulate(x, lv),
               "plain": lambda: Hm.firstorder_accumulate_reference(x, lv)}
        if parent:
            fns["parent"] = lambda: parent["firstorder_accumulate"](x, lv)
        med = _interleaved_medians(fns, order, {"kernel": 20, "parent": 20,
                                                "plain": 5})
        m, n = x.shape
        b_bytes = (m * n * 8 + m * (9 + NG) * 4) / HBM_BPS * 1e3
        b_ops = 10 * m * n / F32_FLOPS * 1e3
        bound = max(b_bytes, b_ops)
        path = Hm.firstorder_plan(m, n)["path"]
        print(f"time firstorder_accumulate {label} ({m} maps of {n} px, "
              f"{path} path): kernel {med['kernel']:.4f} ms, "
              + (f"parent {med['parent']:.4f} ms, " if parent else "")
              + f"plain {med['plain']:.4f} ms, library none; bound "
              f"{bound:.4f} ms (bytes {b_bytes:.4f}, operations {b_ops:.4f}):"
              f" {bound / med['kernel']:.1%} of it"
              + (f" (parent {bound / med['parent']:.1%})" if parent else ""))
        if i == 0:  # the kernels line keeps the chunk's call
            out["firstorder_accumulate"] = (med["kernel"], med["plain"], bound,
                                            b_bytes, b_ops, None)

    g = torch.Generator(device=device).manual_seed(SEED + 52)
    tot = {k: 0.0 for k in ("kernel", "plain", "parent", "products", "bound",
                            "bytes", "ops")}
    for geo in mlp_geometries()[:4]:
        args = _mlp_args(geo, device, g)
        dtype, mm, c, f, c2 = geo
        rn = lambda *sh: torch.randn(*sh, generator=g, device=device).to(dtype)
        a_mid = rn(mm, f)
        fns = {"kernel": lambda: FM.fused_mlp(*args),
               "plain": lambda: FM.fused_mlp_reference(*args),
               "products": lambda: (torch.matmul(args[0], args[1]),
                                    torch.matmul(a_mid, args[3]))}
        if parent:
            fns["parent"] = lambda: parent["fused_mlp"](*args)
        med = _interleaved_medians(fns, order + ["products", "products",
                                                 "products"],
                                   {"kernel": 10, "parent": 5, "plain": 3,
                                    "products": 10})
        b_bytes, b_ops = mlp_bound_ms(*geo)
        bound = max(b_bytes, b_ops)
        print(f"time fused_mlp M {mm} C {c} F {f} C2 {c2} {str(dtype)[6:]}: "
              f"kernel {med['kernel']:.4f} ms, "
              + (f"parent {med['parent']:.4f} ms, " if parent else "")
              + f"plain (addmm, GELU, addmm) {med['plain']:.4f} ms "
              f"({med['plain'] / med['kernel']:.2f}x), the two products "
              f"alone (torch.matmul) {med['products']:.4f} ms, library none;"
              f" bound {bound:.4f} ms (bytes {b_bytes:.4f}, operations "
              f"{b_ops:.4f}): {bound / med['kernel']:.1%} of it"
              + (f" (parent {bound / med['parent']:.1%})" if parent else ""))
        if dtype == torch.bfloat16:  # an encoder forward: 2 calls a stage
            for k in ("kernel", "plain", "parent", "products"):
                tot[k] += 2 * med.get(k, 0.0)
            tot["bound"] += 2 * bound
            tot["bytes"] += 2 * b_bytes
            tot["ops"] += 2 * b_ops
        del args, a_mid
    print(f"time fused_mlp, an encoder forward's four bs 128 bf16 calls: "
          f"kernel {tot['kernel']:.4f} ms, "
          + (f"parent {tot['parent']:.4f} ms, " if parent else "")
          + f"plain {tot['plain']:.4f} ms, the products alone "
          f"{tot['products']:.4f} ms; bound {tot['bound']:.4f} ms: "
          f"{tot['bound'] / tot['kernel']:.1%} of it")
    out["fused_mlp"] = (tot["kernel"], tot["plain"], tot["bound"],
                        tot["bytes"], tot["ops"], None)
    return out

# ----------------------------------------------------- 13. the fusion CLI

CLI_N_TRAIN, CLI_N_TEST = 160, 32  # rendered lesions (HAM10000: 10,015)
CLI_EPOCHS = 2
CLI_EVENTS = ("train/epoch_loss", "train/epoch_acc", "val/epoch_loss",
              "val/epoch_acc", "val/patience_counter")
# the native decoder against cv2 (tests/test_native_io.py:34-36): the same
# JPEG bitstream through two libjpeg builds
NATIVE_MEAN_ABS, NATIVE_MAX_ABS = 1.0, 16
REMAT_LOSS_RTOL = 1e-6   # the forward is the same ops in the same order
# gradient norms: recomputed activations feed the same cuDNN/cuBLAS
# backward, whose reductions may order differently run to run (PR 12's
# card runs: 9.4e-8 at most)
REMAT_GRAD_RTOL = 1e-5
# BN running statistics: the first run's forward, as 'none''s
REMAT_STATS_TOL = dict(rtol=1e-6, atol=1e-8)
CLI_TIMED_REPS = 5  # host-clock repeats of each CLI-side rate, after a warm-up


def cli_workspace(root: Path):
    """192 rendered 450×600 lesions written by ``make_synthetic_isic``
    (160 train, 32 test) under ``root`` → the config dict of the CLI run."""
    import shutil
    from multimodal_isic_tpu_torch.data.synthetic import make_synthetic_isic
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    dirs = make_synthetic_isic(str(root / "data"), n_train=CLI_N_TRAIN,
                               n_test=CLI_N_TEST, image_hw=SRC_HW,
                               seed=SEED + 30)
    print(f"CLI: wrote {CLI_N_TRAIN} + {CLI_N_TEST} lesions of "
          f"{SRC_HW[0]}×{SRC_HW[1]} (JPEG + PNG mask) in "
          f"{time.perf_counter() - t0:.1f} s")
    params = {"patience": 10, "epochs": CLI_EPOCHS, "fold": 1,
              "batch_size": BATCH, "backbone": "efficientnet-b3",
              "augment_fast": True, "device_cache": True,
              "fold_bn_eval": True}
    return {"seed": SEED, "device": "cuda", "dir": dirs,
            "model_path": str(root / "models"), "log_dir": str(root / "runs"),
            "training_plan": {"modality": ["image", "radiomics", "clinical",
                                           "artifacts"],
                              "fusion": "concat",
                              "fusion_level": "intermediate",
                              "parameters": params}}


def run_cli(root: Path, config: dict, name: str):
    """``cli.main.main`` on ``config`` written as ``root/<name>.yml`` →
    (its result, its metrics events, host seconds)."""
    from multimodal_isic_tpu_torch.cli import main as cli_main
    from multimodal_isic_tpu_torch.utils.logging import read_metrics
    path = _write_yaml(root, name, config)
    t0 = time.perf_counter()
    result = cli_main.main(["--config_path", str(path)])
    torch.cuda.synchronize()
    return result, read_metrics(result["run_dir"]), time.perf_counter() - t0


def _host_rates(fn, n_items, reps=CLI_TIMED_REPS):
    """``fn`` once to warm up, then ``reps`` calls on the host clock, each
    closed by a device sync → items/s of each call, sorted."""
    fn()
    rates = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rates.append(n_items / (time.perf_counter() - t0))
    return sorted(rates)


def _spread(rates) -> str:
    return (f"{float(np.median(rates)):.1f} img/s (median of {len(rates)}, "
            f"{rates[0]:.1f}–{rates[-1]:.1f})")


def _epoch_seconds(events):
    """Host seconds of each train epoch after the first, from the run's
    metrics stamps: the previous epoch's last event to this epoch's train
    loss (the epoch ends in a device readback)."""
    stamps = [e["t"] for e in events if e["name"] in ("train/epoch_loss",
                                                      "val/patience_counter")]
    return [b - a for a, b in zip(stamps[1::2], stamps[2::2])]


def cli_slice(device):
    """The fusion CLI from files on disk to the test report at B3@380 full
    width → numbers for PERF.md."""
    import os

    import pandas as pd
    from multimodal_isic_tpu_torch.cli import prepare_df
    from multimodal_isic_tpu_torch.core import checkpoint
    from multimodal_isic_tpu_torch.core.rng import RngPool, generator
    from multimodal_isic_tpu_torch.data import augment, native_io
    from multimodal_isic_tpu_torch.data.pipeline import (
        RADIOMICS_PLACEHOLDER_DIM, DermRecords, DeviceDataset, DeviceLoader)
    from multimodal_isic_tpu_torch.entry import entry
    from multimodal_isic_tpu_torch.models.fusion import fold_fusion_params
    from multimodal_isic_tpu_torch.ops import affine_warp as aw
    from multimodal_isic_tpu_torch.ops import color_jitter as cj
    from multimodal_isic_tpu_torch.ops import fused_dwconv as fd
    from multimodal_isic_tpu_torch.train import fusion as T

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
    config = cli_workspace(root)
    prepare_df.main(["--config_path", str(_write_yaml(root, "prep", config))])
    out = {"root": root, "config": config}

    # the main path: counts at 0, the CLI, counts read
    torch.cuda.reset_peak_memory_stats()
    aw.affine_warp_batch.launches = cj.color_jitter_batch.launches = 0
    fd.dw_silu_pool.launches = fd.expand_dw_silu_pool.launches = 0
    result, events, wall = run_cli(root, config, "cached")
    launches = {"affine_warp_batch": aw.affine_warp_batch.launches,
                "color_jitter_batch": cj.color_jitter_batch.launches,
                "dw_silu_pool": fd.dw_silu_pool.launches,
                "expand_dw_silu_pool": fd.expand_dw_silu_pool.launches}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    n_train = len(result["train_idx"])
    epochs = sum(e["name"] == "train/epoch_loss" for e in events)
    steps = epochs * (n_train // BATCH)
    forwards = -(-CLI_N_TEST // BATCH)
    print(f"CLI (augment_fast, device_cache, fold_bn_eval; B3@380 f32, fold "
          f"1: {n_train} train, {len(result['val_idx'])} val, {CLI_N_TEST} "
          f"test): {epochs} epochs in {wall:.1f} s; test accuracy "
          f"{result['accuracy']:.5f}; launches {launches} ({steps} train "
          f"steps, {forwards} test forwards); peak {out['peak_gib']:.2f} GiB")
    want = {"affine_warp_batch": steps, "color_jitter_batch": steps,
            "dw_silu_pool": 2 * forwards, "expand_dw_silu_pool": 20 * forwards}
    if epochs != CLI_EPOCHS or launches != want:
        raise AssertionError(f"CLI launches {launches} != {want} "
                             f"({epochs} epochs)")
    names = {e["name"] for e in events}
    losses = [e["value"] for e in events if e["name"].endswith("epoch_loss")]
    if not set(CLI_EVENTS) <= names or not all(map(math.isfinite, losses)):
        raise AssertionError(f"CLI events {sorted(names)}, losses {losses}")
    if not bool(torch.isfinite(result["logits"]).all()) or \
            result["logits"].shape != (CLI_N_TEST, 7):
        raise AssertionError("CLI test logits not finite or mis-shaped")
    seconds = _epoch_seconds(events)
    print(f"CLI device-resident train epoch {epochs}: {seconds[-1]:.3f} s "
          f"(host clock, one reading) = "
          f"{(n_train // BATCH) * BATCH / seconds[-1]:.1f} img/s")

    # a fresh model restored from the checkpoint: the CLI's logits, bit for
    # bit, and the test pass's rate
    df_test = pd.read_pickle(config["dir"]["df_test"])
    folded = empty_model(device, backbone="efficientnet-b3",
                         radiomics_dim=RADIOMICS_PLACEHOLDER_DIM, fusion_strategy="concat",
                         backbone_bn_folded=True,
                         backbone_pallas_serving=True)
    folded.load_state_dict(fold_fusion_params(checkpoint.restore_checkpoint(
        result["model_path"], device=device), backbone="efficientnet-b3"))
    step = T.make_fusion_eval_step(folded)
    test_records = DermRecords(df_test)

    def test_pass():
        loader = DeviceLoader(test_records, BATCH,
                              transform=augment.POLICIES["fusion_eval"],
                              device=device)
        return torch.cat([step(b)[1] for b in loader]).cpu()

    logits = test_pass()
    if not torch.equal(logits, result["logits"]):
        err = float((logits - result["logits"]).abs().max())
        raise AssertionError(f"restored checkpoint's logits differ ({err})")
    out["test_img_s"] = _host_rates(test_pass, CLI_N_TEST)
    print(f"checkpoint {Path(result['model_path']).name}: restored, BN "
          f"folded, kernel path: the CLI's test logits bit for bit; test "
          f"pass (decode + preprocess + forward, host clock) "
          f"{_spread(out['test_img_s'])}")

    # host decode: the decoder the CLI used, and native against cv2
    df_train = pd.read_pickle(config["dir"]["df"])
    records = DermRecords(df_train)
    out["decoder"] = "native" if records.use_native else "cv2"
    out["decode_img_s"] = _host_rates(
        lambda: [records.read_image_mask(i) for i in range(32)], 32)
    print(f"host decode ({out['decoder']}, one thread, 450×600 → 450² crop, "
          f"32 lesions a call): {_spread(out['decode_img_s'])}")
    if native_io.available():
        cv = DermRecords(df_train, use_native=False)
        t0 = time.perf_counter()
        native_io.decode_crop_batch(df_train["image_path"].tolist()[:64],
                                    [str(p) for p in
                                     df_train["segmentation_path"]][:64],
                                    (450, 450))
        print(f"native batch decode ({os.cpu_count()} threads): "
              f"{64 / (time.perf_counter() - t0):.1f} img/s")
        for i in range(16):
            (a, ma), (b, mb) = records.read_image_mask(i), cv.read_image_mask(i)
            d = np.abs(a.astype(int) - b.astype(int))
            if d.mean() >= NATIVE_MEAN_ABS or d.max() > NATIVE_MAX_ABS or \
                    not np.array_equal(ma > 0, mb > 0):
                raise AssertionError(f"native vs cv2 at {i}: mean "
                                     f"{d.mean():.3f} max {d.max()}")
        print("native decoder vs cv2: within tests/test_native_io.py's "
              f"tolerances (mean < {NATIVE_MEAN_ABS}, max ≤ {NATIVE_MAX_ABS},"
              " same mask) on 16 lesions")
    else:
        print("native decoder: does not load here (no libjpeg/libpng); the "
              "CLI decoded with cv2")

    # one more epoch through the streaming loader (device_cache off)
    stream_cfg = json.loads(json.dumps(config))
    stream_cfg["training_plan"]["parameters"].update(
        {"device_cache": False, "epochs": 1})
    aw.affine_warp_batch.launches = cj.color_jitter_batch.launches = 0
    result_s, events_s, wall_s = run_cli(root, stream_cfg, "streaming")
    warp_s = aw.affine_warp_batch.launches
    jitter_s = cj.color_jitter_batch.launches
    steps_s = -(-n_train // BATCH)
    print(f"CLI streaming epoch (device_cache false): {wall_s:.1f} s for the "
          f"run; warp launches {warp_s}, jitter launches {jitter_s} over "
          f"{steps_s} steps")
    if warp_s != steps_s or jitter_s != steps_s or \
            not bool(torch.isfinite(result_s["logits"]).all()):
        raise AssertionError(f"streaming CLI: {warp_s} warp launches, "
                             f"{jitter_s} jitter launches")
    train_records = DermRecords(df_train.iloc[result["train_idx"]])
    order = np.random.RandomState(SEED + 1).permutation(len(train_records))
    busy = torch.randn(2048, 2048, device=device)
    n_checked = 0
    for start, batch in zip(range(0, len(order), BATCH),
                            DeviceLoader(train_records, BATCH, order=order,
                                         device=device)):
        busy = busy @ busy / 2048  # the consumer's stream is busy meanwhile
        idx = order[start:start + BATCH]
        want = [train_records[int(i)] for i in idx]
        for key in ("image", "mask", "radiomics", "age", "sex", "loc",
                    "artifacts", "target"):
            host = torch.from_numpy(np.stack([w[key] for w in want]))
            if not torch.equal(batch[key].cpu(), host.to(batch[key].dtype)) \
                    or batch[key].device != device:
                raise AssertionError(f"streamed batch at {start}: {key}")
        n_checked += len(idx)
    print(f"streaming loader: {n_checked} records on the card equal the "
          "records (pinned copies on a side stream)")
    # the CLI's two train epochs, timed over several epochs: streaming
    # (DeviceLoader) and device-resident (DeviceDataset), the fast policy
    model = T.build_fusion(generator(SEED + 31, device),
                           backbone="efficientnet-b3", radiomics_dim=RADIOMICS_PLACEHOLDER_DIM,
                           fusion_strategy="concat")
    opt = T.fusion_optimizer(model)
    train_step = T.make_fusion_train_step(model, opt)
    pool = RngPool(SEED + 32, device)
    fast = augment.POLICIES["fusion_train_fast"]

    def stream_epoch():
        loader = DeviceLoader(train_records, BATCH, order=order,
                              transform=fast, rng_stream=pool["augment"],
                              device=device)
        return T.train_epoch(train_step, model, loader, pool["dropout"])

    out["stream_img_s"] = _host_rates(stream_epoch, len(order))
    print(f"streaming train epoch (DeviceLoader: {out['decoder']} decode on "
          f"the prefetch thread, pinned copies; fast policy; bs {BATCH} "
          f"f32; {len(order)} lesions): {_spread(out['stream_img_s'])} "
          f"(host clock)")
    resident = DeviceDataset.from_records(train_records, device=device,
                                          with_masks=False)
    resident_epoch = T.make_fusion_train_epoch(model, opt, transform=fast)
    step_idx = resident.epoch_order(BATCH, order=order)
    out["resident_img_s"] = _host_rates(
        lambda: resident_epoch(resident.images, resident.masks,
                               resident.meta, step_idx,
                               pool["augment"].next(),
                               pool["dropout"].next()), step_idx.size)
    print(f"device-resident train epoch (DeviceDataset, fast policy, bs "
          f"{BATCH} f32, {len(step_idx)} steps): "
          f"{_spread(out['resident_img_s'])} (host clock)")

    # remat: one bs 16 train step, 'conv' and 'block' against 'none':
    # loss, gradient norms, BN running statistics, the generator's state
    staged = next(iter(DeviceLoader(train_records, BATCH, device=device)))
    batch = dict(staged)
    batch["image"] = augment.preprocess_eval_batch(staged["image"], (IMG, IMG))
    runs = {}
    del model, train_step, opt, resident, resident_epoch
    torch.cuda.empty_cache()
    for remat in ("none", "conv", "block"):
        m = T.build_fusion(generator(SEED + 33, device),
                           backbone="efficientnet-b3", radiomics_dim=RADIOMICS_PLACEHOLDER_DIM,
                           fusion_strategy="concat", backbone_remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        rng = generator(SEED + 34, device)
        logits = m(**T._inputs(batch), rng=rng)
        loss = T.cross_entropy(logits, batch["target"])
        loss.backward()
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
        norms = torch.stack([p.grad.norm() for p in m.parameters()]).cpu()
        stats = torch.cat([b.flatten() for k, b in m.named_buffers()
                           if "running_" in k]).cpu()
        runs[remat] = (float(loss.detach()), norms, peak, stats,
                       rng.get_state())
        del m, logits, loss
        torch.cuda.empty_cache()
    for remat in ("conv", "block"):
        loss, norms, peak, stats, rng_state = runs[remat]
        base = runs["none"]
        rel = float(((norms - base[1]).abs() / base[1].clamp(min=1e-12)).max())
        stats_err = float((stats - base[3]).abs().max())
        stats_ok = torch.allclose(stats, base[3], **REMAT_STATS_TOL)
        same_rng = torch.equal(rng_state, base[4])
        print(f"remat {remat!r}: loss {loss:.6f} (none {base[0]:.6f}), "
              f"gradient norms max rel diff {rel:.2e} (≤ {REMAT_GRAD_RTOL}), "
              f"{len(stats)} BN running statistics max abs diff "
              f"{stats_err:.2e} ({REMAT_STATS_TOL}), generator state "
              f"{'equal' if same_rng else 'DIFFERENT'}; step peak "
              f"{peak:.2f} GiB above the weights (none {base[2]:.2f})")
        if not math.isclose(loss, base[0], rel_tol=REMAT_LOSS_RTOL) \
                or rel > REMAT_GRAD_RTOL or not stats_ok \
                or not same_rng:
            raise AssertionError(f"remat {remat} differs from none")
    out["remat_peak_gib"] = {k: v[2] for k, v in runs.items()}

    # entry(): the program bench measures
    forward, (model, inputs) = entry(device)
    logits = forward(model, inputs)
    if logits.shape != (2, 7) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("entry() forward")
    print(f"entry(): bf16 B3 fusion forward of 2 uint8 450² requests → "
          f"{tuple(logits.shape)} finite logits")
    return out

# -------------------------------------------- 14. the radiomics and MAE CLIs

MAE_CLI_EPOCHS = 2
MAE_CLI_VAL_BS = 64   # cli/train_ae.py VAL_BS (JAX cli/train_ae.py:81-89)
HOST_REPS = 3         # host-clock repeats of the phase's rates
# R2 holds the L1 selection's float32 FISTA against the same steps in float64
# on the CPU, on its 160 × 4,008 problem, at two fixed limits (readings in
# PERF.md).  After FISTA_CHECK_STEPS steps: the largest |W − W64| / max |W64|
# a float32 solve may show; a TF32 solve must read above it.  After the 300
# steps of the selection, where any perturbation has grown: the largest
# |importance − float64's| (importance = mean over the classes of |W|) a
# float32 solve may show; a feature kept on the card and not on the CPU, or
# the reverse, passes only where both its importances lie within it of the
# 1e-5 threshold.
FISTA_CHECK_STEPS = 40
FISTA_STEP_LIMIT = 3e-5
FISTA_IMPORTANCE_LIMIT = 3e-4
# the six frames' columns, as the JAX package writes them
# (analysis/latent_pipeline.py:118-157)
LATENT_COLUMNS = {
    "patch_level_latents": ["image_path", "segmentation_path", "target",
                            "patch_id",
                            "patch_latent", "patch_in_mask",
                            "patch_latent_pca"],
    "latent_pooled": ["image_path", "segmentation_path", "target",
                      "latent_pooled_max", "latent_pooled_mean",
                      "ids_restore"],
    "latent_raw": ["image_path", "segmentation_path", "target", "latent",
                   "ids_restore", "lesion_mask_patches"],
}


def _quiet(fn):
    """``fn()`` with its standard output kept → (result, printed lines)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn()
    return result, buf.getvalue().splitlines()


def _fista_problem(norm, labels):
    """R2's L1 problem as ``lasso_importance`` poses it: X [N, D], the ±1
    one-vs-rest labels [K, N], the balanced sample weights [N] (numpy
    float64)."""
    classes = np.unique(labels)
    counts = np.bincount(labels)
    return (norm.values, np.stack([np.where(labels == c, 1.0, -1.0)
                                   for c in classes]),
            len(labels) / (len(classes) * counts[labels]))


def _tf32_products():
    """A context in which float32 matrix products may use TF32."""
    import contextlib

    @contextlib.contextmanager
    def tf32():
        prec = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(prec)
    return tf32()


def _importances(fn):
    """``fn()`` with every ``reduce.lasso_importance`` call it makes
    recorded → (result, [(importance, per-class C), ...])."""
    from multimodal_isic_tpu_torch.analysis import reduce as RD
    calls, kept = [], RD.lasso_importance

    def record(*args, **kwargs):
        calls.append(kept(*args, **kwargs))
        return calls[-1]
    RD.lasso_importance = record
    try:
        return fn(), calls
    finally:
        RD.lasso_importance = kept


def _fista_witness(device, norm, labels, c_k):
    """The selection's FISTA on the card against the same steps in float64
    on the CPU → (the largest |W − W64| / max |W64| after
    ``FISTA_CHECK_STEPS`` steps at the card's per-class C ``c_k`` and on the
    20-C grid, for the card in float32 and with TF32 products; the largest
    |importance − float64's| after 300 steps at ``c_k``, for the card's and
    the CPU's float32 and for float64 on X × (1 + 1e-7·N(0, 1)), float32's
    rounding of X)."""
    from multimodal_isic_tpu_torch.analysis import reduce as RD
    x, Y, sw = _fista_problem(norm, labels)

    def solve(dev, dtype, C, iters, X=x):
        def t(a):
            return torch.as_tensor(np.array(a, np.float64), dtype=dtype,
                                   device=dev)
        W, _ = RD._fista_l1_logistic(t(X), t(Y), t(sw), t(C), iters)
        return W.double().cpu().numpy()

    def solve_tf32(C, iters):
        kept = RD.full_float32
        RD.full_float32 = _tf32_products
        try:
            return solve(device, torch.float32, C, iters)
        finally:
            RD.full_float32 = kept

    steps = {}
    for name, C in (("final", c_k), ("grid", np.logspace(-2, 1, 20)[:, None])):
        ref = solve("cpu", torch.float64, C, FISTA_CHECK_STEPS)
        for run, W in (("card f32", solve(device, torch.float32, C,
                                          FISTA_CHECK_STEPS)),
                       ("card TF32", solve_tf32(C, FISTA_CHECK_STEPS))):
            steps[run, name] = float(np.abs(W - ref).max()
                                     / np.abs(ref).max())
    imp64 = np.abs(solve("cpu", torch.float64, c_k, 300)).mean(-2)
    noisy = x * (1 + 1e-7 * np.random.RandomState(SEED).randn(*x.shape))
    runs = {"card f32": solve(device, torch.float32, c_k, 300),
            "CPU f32": solve("cpu", torch.float32, c_k, 300),
            "float64 on X x (1 + 1e-7 N(0,1))": solve("cpu", torch.float64,
                                                      c_k, 300, noisy)}
    final = {run: float(np.abs(np.abs(W).mean(-2) - imp64).max())
             for run, W in runs.items()}
    return steps, final


def radiomics_chain(device, root, config):
    """Chain R from the files on disk: ``cli.extract_radiomics`` (450×600,
    4,872 features, chunks of 16, the kernel path) → ``cli.reduce_dim``
    (FISTA on the card) → ``cli.main`` for one epoch at the reduced width
    → numbers for PERF.md."""
    import pandas as pd
    from multimodal_isic_tpu_torch.analysis import radiomics as RA
    from multimodal_isic_tpu_torch.analysis import reduce as RD
    from multimodal_isic_tpu_torch.cli import extract_radiomics as XR
    from multimodal_isic_tpu_torch.cli import reduce_dim as RDC
    from multimodal_isic_tpu_torch.core import checkpoint
    from multimodal_isic_tpu_torch.data import augment, native_io
    from multimodal_isic_tpu_torch.data.pipeline import (
        RADIOMICS_PLACEHOLDER_DIM, DermRecords, DeviceLoader)
    from multimodal_isic_tpu_torch.models.fusion import fold_fusion_params
    from multimodal_isic_tpu_torch.ops import affine_warp as aw
    from multimodal_isic_tpu_torch.ops import fused_dwconv as fd
    from multimodal_isic_tpu_torch.train import fusion as T
    out = {}
    fns = _rad_fns()
    path = _write_yaml(root, "radiomics", config)
    df_train = pd.read_pickle(config["dir"]["df"])
    df_test = pd.read_pickle(config["dir"]["df_test"])

    # R1. extraction: counts at 0, the CLI, counts read
    for name in RAD_KERNELS:
        fns[name][0].launches = 0
    t0 = time.perf_counter()
    (train, test), lines = _quiet(lambda: XR.main(["--config_path",
                                                   str(path)]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fns[name][0].launches for name in RAD_KERNELS}
    n_chunks = -(-len(train) // XR.CHUNK) + -(-len(test) // XR.CHUNK)
    out["decoder"] = "native" if native_io.available() else "cv2"
    print("\n".join("  cli.extract_radiomics: " + ln for ln in lines))
    print(f"R1 cli.extract_radiomics ({out['decoder']} decoder): train "
          f"{train.shape}, test {test.shape} in {wall:.1f} s; launches "
          f"{launches} ({n_chunks} chunks of {XR.CHUNK})")
    suffixes = tuple(RA.CHANNEL_SUFFIX.values())
    for frame, n in ((train, CLI_N_TRAIN), (test, CLI_N_TEST)):
        per = [sum(c.endswith(s) for c in frame.columns) for s in suffixes]
        if frame.shape != (n, 4872) or per != [1218] * 4 or \
                not np.isfinite(frame.values).all():
            raise AssertionError(f"radiomics frame {frame.shape}, columns a "
                                 f"suffix {per}, NaN "
                                 f"{int(np.isnan(frame.values).sum())}")
    if any(v != 13 * n_chunks for v in launches.values()):
        raise AssertionError(f"launches {launches} != 13 x {n_chunks}")
    records = df_train.to_dict(orient="records")
    plain = RA.RadiomicsExtractor(use_kernels=False, device=device)
    rgb, masks = plain._decode_chunk(records[:RAD_CHUNK], SRC_HW,
                                     native_io.available())
    _, p_vals = RA.features_to_frame(plain.extract_channels_batch(rgb, masks))
    k_vals = train.values[:RAD_CHUNK]
    same_nan = np.array_equal(np.isnan(k_vals), np.isnan(p_vals))
    ok = ~np.isnan(p_vals)
    err = _feature_err(k_vals[ok], p_vals[ok])
    n_bad = int((err > RAD_TOL["atol"]
                 + RAD_TOL["rtol"] * np.abs(p_vals[ok])).sum())
    print(f"R1 the CLI's first {RAD_CHUNK} rows vs the plain path on the "
          f"same decoded images: max_abs_err {err.max():.3e}, {n_bad} values "
          f"outside {RAD_TOL}, NaNs at the same places: {same_nan}")
    if n_bad or not same_nan:
        raise AssertionError("CLI radiomics vs plain path differ")
    kernel_ex = RA.RadiomicsExtractor(device=device)
    out["extract_img_s"] = _host_rates(
        lambda: kernel_ex._batched_extraction(records[:2 * RAD_CHUNK]),
        2 * RAD_CHUNK, HOST_REPS)
    print(f"R1 extraction from disk ({out['decoder']} decode on a host "
          f"thread, kernel path, {2 * RAD_CHUNK} lesions a call): "
          f"{_spread(out['extract_img_s'])} (host clock)")

    # R2. reduction: the CLI on the card against reduce_features on the CPU
    t0 = time.perf_counter()
    ((red_tr, red_te), lines), [(imp_k, c_k)] = _importances(
        lambda: _quiet(lambda: RDC.main(["--config_path", str(path)])))
    out["reduce_s"] = time.perf_counter() - t0
    print("\n".join("  cli.reduce_dim: " + ln for ln in lines))
    rad_tr = pd.read_pickle(config["dir"]["radiomics"])
    rad_te = pd.read_pickle(config["dir"]["radiomics_test"])
    y = df_train["dx"]
    cpu_log = []
    (cpu_tr, cpu_te), [(imp_c, c_c)] = _importances(
        lambda: RD.reduce_features(rad_tr, rad_te, y, seed=SEED,
                                   log=cpu_log.append, device="cpu"))
    same = (lines[:len(cpu_log)] == cpu_log
            and list(red_tr.columns) == list(cpu_tr.columns)
            and list(red_te.columns) == list(cpu_te.columns))
    print(f"R2 cli.reduce_dim {out['reduce_s']:.1f} s (host clock): "
          f"{rad_tr.shape[1]} → {red_tr.shape[1]} features; the card's "
          f"stage counts and columns equal reduce_features on the CPU: "
          f"{same}")
    norm, _ = RD.normalize_features(*RD.filter_low_variance(rad_tr, rad_te))
    labels = y.values.astype(int)
    t0 = time.perf_counter()
    steps, final = _fista_witness(device, norm, labels, c_k)
    thr, lim = RD.SELECT_THRESHOLD, FISTA_IMPORTANCE_LIMIT
    print(f"R2 FISTA against the same steps in float64 on the CPU "
          f"({norm.shape[0]} rows x {norm.shape[1]} features; "
          f"{time.perf_counter() - t0:.1f} s): after {FISTA_CHECK_STEPS} "
          f"steps, largest |W - W64| / max |W64| at the card's per-class C "
          f"/ on the 20-C grid: " + ", ".join(
              f"{run} {steps[run, 'final']:.3e} / {steps[run, 'grid']:.3e}"
              for run in ("card f32", "card TF32"))
          + f" (fixed limit {FISTA_STEP_LIMIT:.1e}); after 300 steps at that "
          f"C, largest |importance - float64|: " + ", ".join(
              f"{run} {v:.3e}" for run, v in final.items())
          + f" (fixed limit {lim:.1e}); "
          f"{int((np.abs(imp_k - thr) <= lim).sum())} of {len(imp_k)} "
          f"card importances within it of the {thr:.0e} threshold")
    f32_steps = max(steps["card f32", name] for name in ("final", "grid"))
    if f32_steps > FISTA_STEP_LIMIT:
        raise AssertionError(f"the card's float32 FISTA is {f32_steps:.3e} "
                             f"from float64's after {FISTA_CHECK_STEPS} "
                             f"steps, above {FISTA_STEP_LIMIT:.1e}")
    tf32_steps = min(steps["card TF32", name] for name in ("final", "grid"))
    if tf32_steps <= FISTA_STEP_LIMIT:
        raise AssertionError(f"the limit {FISTA_STEP_LIMIT:.1e} passes a "
                             f"TF32 solve ({tf32_steps:.3e})")
    f32_err = max(final["card f32"], final["CPU f32"])
    if f32_err > lim:
        raise AssertionError(f"a float32 FISTA solve's importance is "
                             f"{f32_err:.3e} from float64's, above {lim:.1e}")
    if same:
        for got, want in ((red_tr, cpu_tr), (red_te, cpu_te)):
            if not np.array_equal(got.values, want.values):
                raise AssertionError("reduced frames differ from the CPU's")
        print("R2 reduced frames: the CPU's values bit for bit (the host "
              "stages are float64 numpy; only the selection ran on the card)")
    else:
        flips = np.flatnonzero((imp_k > thr) != (imp_c > thr))
        near = (np.abs(imp_k[flips] - thr) <= lim) & \
            (np.abs(imp_c[flips] - thr) <= lim)
        print(f"R2 the selection differs from the CPU's: features kept on "
              f"one side only "
              f"{[(norm.columns[i], float(imp_k[i]), float(imp_c[i])) for i in flips]}"
              f" (importance card, CPU); per-class C equal: "
              f"{np.array_equal(c_k, c_c)}; each flip within {lim:.1e} of "
              f"the threshold on both sides: {near.tolist()}")
        if not (len(flips) and near.all() and np.array_equal(c_k, c_c)):
            raise AssertionError("reduce_dim on the card differs from the CPU")
        for got, want in ((red_tr, cpu_tr), (red_te, cpu_te)):
            common = [c for c in got.columns if c in want.columns]
            if not np.array_equal(got[common].values, want[common].values):
                raise AssertionError("reduced frames differ on common columns")
        print(f"R2 NOTE: float32 ties at the selection threshold, not a "
              f"fault: the frames differ by those columns ({red_tr.shape[1]} "
              f"on the card, {cpu_tr.shape[1]} on the CPU) and hold the "
              f"CPU's values bit for bit on the columns they share")
    x, ys, sw = (torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in _fista_problem(norm, labels))
    grid = torch.as_tensor(np.logspace(-2, 1, 20), dtype=torch.float32,
                           device=device)[:, None]
    profile_steps(lambda: RD._fista_l1_logistic(x, ys, sw, grid),
                  f"FISTA grid (20 C x {ys.shape[0]} classes, "
                  f"{x.shape[0]} rows x {x.shape[1]} features, 300 steps; "
                  f"reduce_dim makes 5 such calls and 1 with a C a class)",
                  steps=1)

    # R3. the fusion CLI at the reduced width, one epoch
    cfg = json.loads(json.dumps(config))
    cfg["training_plan"]["parameters"]["epochs"] = 1
    aw.affine_warp_batch.launches = 0
    fd.dw_silu_pool.launches = fd.expand_dw_silu_pool.launches = 0
    result, events, wall = run_cli(root, cfg, "reduced")
    launches_m = {"affine_warp_batch": aw.affine_warp_batch.launches,
                  "dw_silu_pool": fd.dw_silu_pool.launches,
                  "expand_dw_silu_pool": fd.expand_dw_silu_pool.launches}
    state = checkpoint.restore_checkpoint(result["model_path"], device=device)
    width = state["radiomics_mlp.fc1.weight"].shape[1]
    forwards = -(-CLI_N_TEST // BATCH)
    steps = len(result["train_idx"]) // BATCH
    print(f"R3 cli.main with the reduced pickles (B3@380 f32, 1 epoch): "
          f"{wall:.1f} s; radiomics MLP input width {width} (reduced "
          f"{red_tr.shape[1]}, placeholder {RADIOMICS_PLACEHOLDER_DIM}); "
          f"launches {launches_m}")
    if width != red_tr.shape[1] or width == RADIOMICS_PLACEHOLDER_DIM:
        raise AssertionError(f"radiomics MLP width {width}")
    want = {"affine_warp_batch": steps, "dw_silu_pool": 2 * forwards,
            "expand_dw_silu_pool": 20 * forwards}
    if launches_m != want:
        raise AssertionError(f"R3 launches {launches_m} != {want}")
    folded = empty_model(device, backbone="efficientnet-b3",
                         radiomics_dim=width, fusion_strategy="concat",
                         backbone_bn_folded=True,
                         backbone_pallas_serving=True)
    folded.load_state_dict(fold_fusion_params(state,
                                              backbone="efficientnet-b3"))
    step = T.make_fusion_eval_step(folded)
    loader = DeviceLoader(DermRecords(df_test, radiomics=red_te.values),
                          BATCH, transform=augment.POLICIES["fusion_eval"],
                          device=device)
    logits = torch.cat([step(b)[1] for b in loader]).cpu()
    if not torch.equal(logits, result["logits"]):
        raise AssertionError("R3 restored checkpoint's logits differ")
    print("R3 checkpoint restored, BN folded, kernel path, the reduced test "
          "rows: the CLI's test logits bit for bit")
    return out


def _plots_without_matplotlib(viz, names=("latent_scatter",
                                           "reconstruction_grid")):
    """Where matplotlib is not installed, each plotting call of a CLI (by
    default the MAE CLI's epoch hook) must raise ``ImportError`` (as the
    JAX package's would): wrap the ``names`` of ``viz`` to check that and
    record it → the list of records."""
    raised = []

    def guard(fn):
        def call(*args, **kwargs):
            try:
                fn(*args, **kwargs)
            except ImportError as e:
                raised.append(f"{fn.__name__}: {e}")
                return None
            raise AssertionError(f"{fn.__name__} ran without matplotlib")
        return call

    for name in names:
        setattr(viz, name, guard(getattr(viz, name)))
    return raised


def _restored_val_loss(device, run, model_cfg, val_records, cached):
    """A fresh model restored from the run's ``mae_ckpt/`` → the validation
    loss on the saved epoch's draws, as the CLI computed it."""
    from multimodal_isic_tpu_torch.core.checkpoint import restore_train_state
    from multimodal_isic_tpu_torch.core.rng import RngPool
    from multimodal_isic_tpu_torch.data.augment import POLICIES
    from multimodal_isic_tpu_torch.data.pipeline import (DeviceDataset,
                                                         DeviceLoader)
    from multimodal_isic_tpu_torch.models.convmae import ConvMAE
    from multimodal_isic_tpu_torch.train import mae as M
    with torch.device("meta"):
        fresh = ConvMAE(**model_cfg)
    fresh.to_empty(device=device)
    meta = restore_train_state(run["checkpoint"], fresh)
    gen = RngPool(SEED, device)["eval"].at(meta["epoch"])
    if len(val_records) > MAE_CLI_VAL_BS:
        raise ValueError("one validation batch expected")
    if cached:
        val = DeviceDataset.from_records(val_records, device=device)
        order = np.arange(len(val))[None]
        loss = M.make_mae_eval_epoch(fresh, MASK_RATIO, POLICIES["mae_eval"])(
            val.images, val.masks, order, gen) * order.size / len(val)
    else:
        step = M.make_mae_eval_step(fresh, MASK_RATIO)
        batches = list(DeviceLoader(val_records, MAE_CLI_VAL_BS,
                                    transform=POLICIES["mae_eval"],
                                    device=device))
        loss = M._weighted_mean([step(b["image"], gen) for b in batches],
                                [len(b["image"]) for b in batches])
    return loss, meta


def mae_chain(device, root, config):
    """Chain M from the files on disk: ``cli.train_ae`` (ConvViT-Base,
    decoder 512 x 8, bs 16 f32, mask 0.75, norm-pix, flash attention, 2
    epochs) on the loader path and with ``device_cache`` → ``cli.save_latent``
    (encoder only, bs 128 bf16, PCA) on its checkpoint → numbers for
    PERF.md."""
    import contextlib
    import importlib.util
    import pandas as pd
    from multimodal_isic_tpu_torch.analysis.latent_pipeline import (
        extract_latent_bundle)
    from multimodal_isic_tpu_torch.cli import save_latent as SL
    from multimodal_isic_tpu_torch.cli import train_ae as TA
    from multimodal_isic_tpu_torch.core import checkpoint
    from multimodal_isic_tpu_torch.core.config import config_from_dict
    from multimodal_isic_tpu_torch.core.rng import generator
    from multimodal_isic_tpu_torch.data.augment import POLICIES
    from multimodal_isic_tpu_torch.data.pipeline import (DermRecords,
                                                         DeviceLoader)
    from multimodal_isic_tpu_torch.models.convmae import ConvMAE
    from multimodal_isic_tpu_torch.utils import viz
    out = {}
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    raised = [] if has_mpl else _plots_without_matplotlib(viz)
    df_train_val = pd.read_pickle(config["dir"]["df"])
    params = {"epochs": MAE_CLI_EPOCHS, "batch_size": VAL_BATCH,
              "model_size": "base", "norm_pix_loss": True,
              "masking_ratio": MASK_RATIO, "eval_masking_ratio": MASK_RATIO,
              "include_lesion_mask": False, "use_flash_attention": True}
    model_cfg = dict(norm_pix_loss=True, use_flash_attention=True,
                     use_fused_mlp=True)
    runs = {}
    for cached in (False, True):
        name = "mae_cached" if cached else "mae_loader"
        cfg = json.loads(json.dumps(config))
        cfg["model_path"] = str(root / name / "models")
        cfg["log_dir"] = str(root / name / "runs")
        cfg["training_plan"]["parameters"].update(params,
                                                  device_cache=cached)
        _reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = TA.main(["--config_path", str(_write_yaml(root, name, cfg))])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _all_launches()
        n_val = len(run["val_idx"])
        steps = MAE_CLI_EPOCHS * (len(run["train_idx"]) // VAL_BATCH)
        val_fw = MAE_CLI_EPOCHS * -(-n_val // MAE_CLI_VAL_BS)
        hooks = MAE_CLI_EPOCHS  # epoch 0 (every 10th) and the last
        enc_fw = hooks * -(-n_val // MAE_CLI_VAL_BS)
        grids = hooks * min(4, n_val, MAE_CLI_VAL_BS)
        want = {"fused_ln_mlp": 4 * (steps + val_fw + enc_fw + grids),
                "flash_attention": 19 * (steps + val_fw + grids) + 11 * enc_fw,
                "fused_front": 0, "fused_ln_mlp_backward": 4 * steps}
        losses = [v for h in run["history"]
                  for v in (h["train_loss"], h["val_loss"])]
        print(f"M1 cli.train_ae ({'device_cache' if cached else 'loader'} "
              f"path; ConvViT-Base, bs {VAL_BATCH} f32, flash attention): "
              f"{wall:.1f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB; {len(run['train_idx'])} train / {n_val} val; losses "
              f"{[round(v, 5) for v in losses]}; launches {launches} ({steps} "
              f"train steps, {val_fw} validation forwards, {enc_fw} encoder "
              f"and {grids} reconstruction forwards in the hook)")
        if launches != want:
            raise AssertionError(f"M1 launches {launches} != {want}")
        if not all(map(math.isfinite, losses)):
            raise AssertionError("M1 non-finite MAE loss")
        models = Path(cfg["model_path"])
        arts = Path(run["run_dir"]) / "artifacts"
        names = sorted(p.name for p in arts.iterdir())
        if not (Path(run["model_path"]) / checkpoint.MANIFEST).exists() \
                or not (models / "mae_ckpt").is_dir():
            raise AssertionError(f"M1 checkpoints: {sorted(models.iterdir())}")
        for epoch in range(MAE_CLI_EPOCHS):
            with np.load(arts / f"latent_moments_ep{epoch}.npz") as z:
                if z["feats"].shape != (n_val, 6 * 768) or \
                        not np.isfinite(z["feats"]).all():
                    raise AssertionError(f"M1 moments {z['feats'].shape}")
            pngs = {f"latent_scatter_ep{epoch}.png"} | {
                f"image_comparison_{i + 1}_ep{epoch}.png"
                for i in range(min(4, n_val))}
            if has_mpl and not pngs <= set(names):
                raise AssertionError(f"M1 artifacts {names}")
        print(f"M1 artifacts: {names}; checkpoint "
              f"{Path(run['model_path']).name} and mae_ckpt/ written")
        val_records = DermRecords(df_train_val.iloc[run["val_idx"]])
        loss, meta = _restored_val_loss(device, run, model_cfg, val_records,
                                        cached)
        print(f"M1 mae_ckpt/ (epoch {meta['epoch']}) restored into a fresh "
              f"model: validation loss {loss!r} on the saved epoch's draws "
              f"vs saved {meta['val_loss']!r} (must be equal)")
        if loss != meta["val_loss"]:
            raise AssertionError("M1 restored validation loss differs")
        runs[name] = run
    if not has_mpl:
        print(f"M1 NOTE: matplotlib is not installed on this machine; the "
              f"hook's {len(raised)} plotting calls each raised ImportError "
              f"as the JAX hook's would (first: {raised[0]}); no PNG written")

    # the CLI's trained weights: one train step's gradients, its kernels
    # (B9, B10, B11) against the plain path
    best = checkpoint.restore_checkpoint(runs["mae_cached"]["model_path"],
                                         device=device)
    models = {}
    for key, flags in (("kernel", model_cfg), ("plain",
                                               dict(norm_pix_loss=True))):
        with torch.device("meta"):
            models[key] = ConvMAE(**flags)
        models[key].to_empty(device=device).load_state_dict(best)
    val_records = DermRecords(
        df_train_val.iloc[runs["mae_cached"]["val_idx"]])
    imgs = next(iter(DeviceLoader(val_records, VAL_BATCH,
                                  transform=POLICIES["mae_eval"],
                                  device=device)))["image"]
    draws = models["kernel"].masking(len(imgs), MASK_RATIO,
                                     generator(SEED + 40, device))
    _reset_all_launches()
    _step_grads(models, imgs, draws)
    launches = _all_launches()
    _check_grads(f"M1 the CLI's best weights, one step at bs {len(imgs)} "
                 f"f32 (fused LN-MLP, flash attention)", models, launches)
    want = {"fused_ln_mlp": 4, "flash_attention": 19, "fused_front": 0,
            "fused_ln_mlp_backward": 4}
    if launches != want:
        raise AssertionError(f"M1 gradient step launches {launches}")
    del models, best

    # M2. latents from the checkpoint: bf16, bs 128, PCA
    cfg = json.loads(json.dumps(config))
    cfg.update(latent_dtype="bfloat16", pca=True)
    cfg["training_plan"]["parameters"].update(model_size="base")
    path = _write_yaml(root, "latents", cfg)
    model_path = runs["mae_cached"]["model_path"]
    n_all = len(df_train_val) + CLI_N_TEST
    _reset_all_launches()
    with contextlib.chdir(root):
        t0 = time.perf_counter()
        frames, lines = _quiet(lambda: SL.main([
            "--config_path", str(path), "--model_name", model_path]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _all_launches()
        written = sorted(p.name for p in (root / "dataframes_latents")
                         .iterdir())
    print("\n".join("  cli.save_latent: " + ln for ln in lines))
    forwards = -(-len(df_train_val) // SL.LATENT_BS) + \
        -(-CLI_N_TEST // SL.LATENT_BS)
    print(f"M2 cli.save_latent (bf16, bs {SL.LATENT_BS}, PCA) on checkpoint "
          f"{Path(model_path).name}: {n_all} lesions in {wall:.1f} s; "
          f"launches {launches} over {forwards} forwards; wrote {written}")
    want = {"fused_ln_mlp": 4 * forwards, "flash_attention": 0,
            "fused_front": 0, "fused_ln_mlp_backward": 0}
    if launches != want:
        raise AssertionError(f"M2 launches {launches} != {want}")
    if written != sorted(f"{n}.pkl" for n in SL.FRAME_NAMES):
        raise AssertionError(f"M2 pickles {written}")
    for name, frame in zip(SL.FRAME_NAMES, frames):
        if list(frame.columns) != LATENT_COLUMNS[name.rsplit("_", 2)[0]]:
            raise AssertionError(f"M2 {name} columns {list(frame.columns)}")
    with torch.device("meta"):
        plain = ConvMAE(with_decoder=False, dtype=torch.bfloat16)
    plain.to_empty(device=device)
    plain.load_state_dict(checkpoint.restore_partial(model_path,
                                                     plain.state_dict()))
    df_test = pd.read_pickle(config["dir"]["df_test"])
    want_lat = torch.cat([extract_latent_bundle(plain, DeviceLoader(
        DermRecords(df), SL.LATENT_BS, transform=POLICIES["mae_eval"],
        device=device)).latents for df in (df_train_val, df_test)])
    got_lat = torch.from_numpy(np.concatenate([
        np.stack(frames[4]["latent"].values),
        np.stack(frames[5]["latent"].values)])).to(device)
    mx, rel = _latent_err(got_lat, want_lat)
    print(f"M2 the CLI's latents vs the same encoder with every kernel flag "
          f"off: max_abs_err {mx:.4f}, relative RMS {rel:.5f} (tolerance "
          f"{LATENT_TOL}); finite {bool(torch.isfinite(got_lat).all())}")
    if mx > LATENT_TOL["max_abs"] or rel > LATENT_TOL["rel_rms"] or \
            not bool(torch.isfinite(got_lat).all()):
        raise AssertionError("M2 latents out of tolerance")
    typed = config_from_dict(cfg)
    out["latent_img_s"] = _host_rates(
        lambda: _quiet(lambda: SL.extract_latents(typed, model_path)), n_all,
        HOST_REPS)
    print(f"M2 save_latent's extraction from disk (decode, bs "
          f"{SL.LATENT_BS} bf16 encoder, tables, PCA, frames; {n_all} "
          f"lesions a call): {_spread(out['latent_img_s'])} (host clock)")
    out.update(checkpoint=runs["mae_cached"]["checkpoint"],
               latent_config=cfg)
    return out


MIL_FOLDS = 5          # cli.use_latent's default
MIL_EPOCHS = 2         # depth cut: the CLI's default is 200 epochs
MIL_PATIENCE = 2       # depth cut: the CLI's default is 16
MIL_NODES, MIL_DIM = 196, 768   # patches a bag, the encoder's width
GNN_TYPES = ("gcn", "gin", "graphsage", "gat", "transformer")
GRAPH_TYPES = ("grid", "knn", "random")
# card vs CPU, float32 without TF32 on both (different GEMM and reduction
# orders): eval-mode probabilities and attention; one train step's
# gradients, |card − CPU| ≤ MIL_GRAD_TOL · the tensor's largest |gradient|
# + MIL_ZERO_GRAD · the model's largest.  The second term is float32's
# noise floor for a gradient that is 0 in exact arithmetic: a softmax over
# the patches or a row's edges does not see the attention-score biases
# (``att_fc2``, ``pool_att{j}_fc2``), a transformer layer's key bias, or
# GAT's ``att_dst`` where every edge of each row has one LeakyReLU slope
MIL_FWD_TOL = dict(rtol=1e-4, atol=1e-5)
MIL_GRAD_TOL = 1e-3
MIL_ZERO_GRAD = 1e-5
MIL_STEPS = 64         # timed per-bag steps


def _every_launch():
    """Every kernel wrapper (each counts its launches), by the kernels
    line's names."""
    from multimodal_isic_tpu_torch.ops import affine_warp as aw
    from multimodal_isic_tpu_torch.ops import fused_dwconv as fd
    from multimodal_isic_tpu_torch.ops import fused_mlp as FM
    from multimodal_isic_tpu_torch.ops import histogram as Hm
    fns = {"expand_dw_silu_pool": fd.expand_dw_silu_pool,
           "dw_silu_pool": fd.dw_silu_pool,
           "affine_warp_batch": aw.affine_warp_batch,
           "fused_ln_mlp_backward": FM.fused_ln_mlp_backward,
           "firstorder_accumulate": Hm.firstorder_accumulate,
           "fused_mlp": FM.fused_mlp}
    fns.update({k: v[0] for k, v in _rad_fns().items()})
    fns.update({k: v[0] for k, v in _mae_fns().items()})
    return fns


def _reset_every_launch():
    for fn in _every_launch().values():
        fn.launches = 0


def _launched():
    return {k: fn.launches for k, fn in _every_launch().items()
            if fn.launches}


def _best_params():
    """``configs/config.yml``'s two HPO records (the smoke's widths)."""
    import yaml
    raw = yaml.safe_load((Path(__file__).parent / "configs" /
                          "config.yml").read_text())
    return dict(raw["best_params"]), dict(raw["best_params_graph-mil"])


class _FoldRecorder:
    """Wraps ``train.cv``'s two trainables: records each fold's test bags
    and the epoch losses, then trains as the CLI asked."""

    def __init__(self, cv):
        self.cv, self.folds = cv, []
        self.kept = (cv.train_mil, cv.train_graph_mil)
        cv.train_mil = self._wrap(self.kept[0])
        cv.train_graph_mil = self._wrap(self.kept[1])

    def _wrap(self, fn):
        def run(config, data, **kw):
            out = fn(config, data, **kw)
            self.folds.append({"test_feats": data["test_feats"],
                               "n_train": len(data["train_feats"]),
                               "losses": out["_epoch_losses"]})
            return out
        return run

    def close(self):
        self.cv.train_mil, self.cv.train_graph_mil = self.kept


def _mil_rows_check(label, frame, n_rows):
    """``n_rows`` rows, each column finite."""
    cols = [c for c in frame.columns if c not in ("fold", "error", "id",
                                                  "checkpoint_type")]
    vals = frame[cols].astype(float).values
    if len(frame) != n_rows or not np.isfinite(vals).all():
        bad = [c for c in cols
               if not np.isfinite(frame[c].astype(float)).all()]
        raise AssertionError(f"{label}: {len(frame)} rows, non-finite {bad}")


def mil_single_frame(device, root, config, frame_path):
    """15a: ``cli.use_latent`` in single-frame mode on phase 14's patch
    frame, ``mil`` then ``graph-mil``, at ``configs/config.yml``'s widths
    → numbers for PERF.md."""
    import pandas as pd
    from multimodal_isic_tpu_torch.analysis.bags import build_patient_bags
    from multimodal_isic_tpu_torch.cli import use_latent as UL
    from multimodal_isic_tpu_torch.train import cv as CV
    best_mil, best_graph = _best_params()
    bags, labels, _ = build_patient_bags(pd.read_pickle(frame_path))
    folds = CV.fold_splits(labels, MIL_FOLDS, SEED)
    print(f"15a patch frame {frame_path.name}: {len(bags)} patient bags of "
          f"{sorted({len(b) for b in bags})} patches × {bags[0].shape[1]} "
          f"(PCA), classes {np.bincount(labels).tolist()}")
    out = {}
    for kind in ("mil", "graph-mil"):
        cfg = json.loads(json.dumps(config))
        cfg.update(num_classes=7, best_params=best_mil,
                   **{"best_params_graph-mil": best_graph})
        path = _write_yaml(root, f"use_latent_{kind}", cfg)
        csv = root / f"cv_{kind}.csv"
        rec = _FoldRecorder(CV)
        _reset_every_launch()
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            res, lines = _quiet(lambda: UL.main([
                "--config_path", str(path), "--model_type", kind,
                "--patch_df", str(frame_path), "--n_folds", str(MIL_FOLDS),
                "--max_epochs", str(MIL_EPOCHS),
                "--patience", str(MIL_PATIENCE), "--csv", str(csv)]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            rec.close()
        launched = _launched()
        rows = pd.read_csv(csv)
        print("\n".join(f"  cli.use_latent {kind}: {ln}" for ln in lines
                        if not ln.startswith(("val_", "test_"))))
        summary = res["summary"]
        print(f"15a cli.use_latent --model_type {kind} ({MIL_FOLDS} folds, "
              f"{MIL_EPOCHS} epochs, patience {MIL_PATIENCE}): {wall:.1f} s, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
              f"kernel launches {launched or 'none'}; epoch losses "
              f"{[[round(v, 4) for v in f['losses']] for f in rec.folds]}; "
              + ", ".join(f"{k} {summary[k][0]:.4f} ± {summary[k][1]:.4f}"
                          for k in ("val_bacc", "test_bacc_best_bacc",
                                    "test_auc_best_bacc",
                                    "test_loss_best_loss")))
        if launched:
            raise AssertionError(f"15a {kind}: kernel launches {launched}")
        _mil_rows_check(f"15a {kind}", rows, MIL_FOLDS)
        want_keys = {f"val_{k}" for k in CV.METRIC_KEYS} | {
            f"test_{k}_{c}" for k in CV.TEST_METRIC_KEYS
            for c in ("best_bacc", "best_loss")}
        if set(summary) != want_keys:
            raise AssertionError(f"15a summary keys {sorted(summary)}")
        if len(rec.folds) != MIL_FOLDS or not all(
                np.isfinite(f["losses"]).all() for f in rec.folds):
            raise AssertionError("15a fold losses")
        for (tr, te), fold in zip(folds, rec.folds):
            if fold["n_train"] != len(tr) or len(fold["test_feats"]) != len(
                    te) or not all(np.array_equal(a, bags[i]) for a, i in
                                   zip(fold["test_feats"], te)):
                raise AssertionError(f"15a {kind}: fold membership differs "
                                     "from StratifiedKFold on the CPU")
        print(f"15a {kind}: {MIL_FOLDS} finite rows; summary keys; fold "
              f"membership equal to StratifiedKFold on the CPU "
              f"({[len(te) for _, te in folds]} test bags a fold)")
        out[kind] = wall
    return out, bags, labels


def mil_sweep(device, root, config, mae):
    """15b: ``cli.use_latent`` in sweep mode on a checkpoint whose tree
    matches nothing and on phase 14's ``mae_ckpt/`` best step: NaN rows,
    finite rows, the snapshot's hash header, 4 B9 launches an encoder
    forward of the re-extraction, the latents within ``LATENT_TOL`` of
    phase 14's frames."""
    import contextlib
    import hashlib
    import pandas as pd
    from multimodal_isic_tpu_torch.cli import save_latent as SL
    from multimodal_isic_tpu_torch.cli import use_latent as UL
    from multimodal_isic_tpu_torch.core import checkpoint
    from multimodal_isic_tpu_torch.train import cv as CV
    best_mil, _ = _best_params()
    cfg = json.loads(json.dumps(mae["latent_config"]))
    cfg.update(num_classes=7, best_params=best_mil)
    path = _write_yaml(root, "use_latent_sweep", cfg)
    bad = root / "bad_ckpt"
    checkpoint.save_checkpoint(str(bad), {"unrelated.w": torch.zeros(3)})
    good = mae["checkpoint"]
    out_dir = root / "mil_sweep"
    extracted = []
    kept = SL.extract_latents

    def record(*args, **kwargs):
        frames = kept(*args, **kwargs)
        extracted.append(frames)
        return frames
    SL.extract_latents = record
    _reset_every_launch()
    torch.cuda.reset_peak_memory_stats()
    try:
        with contextlib.chdir(root):
            t0 = time.perf_counter()
            res, lines = _quiet(lambda: UL.main([
                "--config_path", str(path), "--model_type", "mil",
                "--checkpoints", f"{bad},{good}",
                "--n_folds", str(MIL_FOLDS), "--max_epochs", str(MIL_EPOCHS),
                "--patience", str(MIL_PATIENCE), "--out_dir", str(out_dir)]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        SL.extract_latents = kept
    launched = _launched()
    n_train = len(pd.read_pickle(config["dir"]["df"]))
    forwards = -(-n_train // SL.LATENT_BS) + -(-CLI_N_TEST // SL.LATENT_BS)
    print("\n".join(f"  cli.use_latent sweep: {ln}" for ln in lines
                    if "Error" in ln or "patient bags" in ln
                    or "Processing" in ln))
    print(f"15b cli.use_latent sweep (bad checkpoint, then "
          f"{Path(good).parent.name}/{Path(good).name}; mil, {MIL_FOLDS} "
          f"folds, {MIL_EPOCHS} epochs): {wall:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launched} over {forwards} encoder forwards")
    if launched != {"fused_ln_mlp": 4 * forwards}:
        raise AssertionError(f"15b launches {launched} != "
                             f"{{'fused_ln_mlp': {4 * forwards}}}")
    (csv,) = [p for p in out_dir.iterdir()
              if p.name.startswith("runs_df_mil_results_")]
    rows = pd.read_csv(csv)
    stems = [c for _, c in CV.SWEEP_COLS]
    if list(rows["checkpoint_type"]) != ["best_bacc", "best_loss"] * 2 or \
            not rows.iloc[:2][stems].isna().all().all():
        raise AssertionError(f"15b rows {rows.to_dict('records')}")
    _mil_rows_check("15b good checkpoint", rows.iloc[2:][stems + [
        f"{c}_std" for c in stems]], 2)
    (snap,) = [p for p in out_dir.iterdir() if p.name.startswith("config_")]
    header, body = snap.read_text().split("\n", 1)
    if header != "# config_hash: " + hashlib.sha1(
            body.encode()).hexdigest()[:8]:
        raise AssertionError(f"15b snapshot header {header!r}")
    print(f"15b rows: bad checkpoint NaN ({rows['error'].iloc[0][:60]}...), "
          f"good finite (micro_accuracy "
          f"{rows['micro_accuracy'].iloc[2]:.4f} ± "
          f"{rows['micro_accuracy_std'].iloc[2]:.4f}); {snap.name}: {header}")
    (frames,) = extracted
    got = torch.from_numpy(np.concatenate([
        np.stack(frames[4]["latent"].values),
        np.stack(frames[5]["latent"].values)])).to(device)
    want = torch.from_numpy(np.concatenate([
        np.stack(pd.read_pickle(root / "dataframes_latents" /
                                f"latent_raw_{s}_df.pkl")["latent"].values)
        for s in ("train", "test")])).to(device)
    mx, rel = _latent_err(got, want)
    print(f"15b re-extracted latents vs phase 14's frames: max_abs_err "
          f"{mx:.4f}, relative RMS {rel:.5f} (tolerance {LATENT_TOL})")
    if mx > LATENT_TOL["max_abs"] or rel > LATENT_TOL["rel_rms"]:
        raise AssertionError("15b latents out of tolerance")
    return {"wall": wall, "b9": launched["fused_ln_mlp"],
            "forwards": forwards}


def _mil_grads(model, x, adj, valid, y):
    """One train step's gradients at dropout 0 (no draw: the CPU's and the
    card's generators differ)."""
    from multimodal_isic_tpu_torch.models.mil import mil_loss
    model.zero_grad(set_to_none=True)
    probs, _ = model(*((x,) if adj is None else (x, adj)), valid=valid)
    mil_loss(probs, y).backward()
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def mil_card_vs_cpu(device, real_bag):
    """15c: every gnn type on every graph type (and AttentionMIL) at the
    best-params widths on one 196 × 768 bag, seeded weights: the eval
    forward on the card and on the CPU within ``MIL_FWD_TOL``, one train
    step's gradients (dropout 0) within ``MIL_GRAD_TOL`` and
    ``MIL_ZERO_GRAD``, and the grid and
    kNN adjacencies equal bit for bit (kNN built on the card with TF32 on
    globally; the random graph drawn on the CPU and copied)."""
    import copy
    from multimodal_isic_tpu_torch.core.rng import generator
    from multimodal_isic_tpu_torch.models.mil import AttentionMIL
    from multimodal_isic_tpu_torch.train import mil as TM
    best_mil, best_graph = _best_params()
    rng = np.random.RandomState(SEED + 50)
    x = rng.randn(MIL_NODES, MIL_DIM).astype(np.float32)
    x[150:160] = x[149]  # planted exact ties for kNN
    xc, vc = torch.from_numpy(x), torch.ones(MIL_NODES, dtype=torch.bool)
    xd, vd, y = xc.to(device), vc.to(device), torch.tensor(3)
    worst = {"probs": 0.0, "att": 0.0, "grad": 0.0, "zero": 0.0}

    def compare(label, m_cpu, adj_c, adj_d):
        m_dev = copy.deepcopy(m_cpu).to(device)
        with torch.no_grad():
            pc, ac = m_cpu(*((xc,) if adj_c is None else (xc, adj_c)),
                           valid=vc)
            pd_, ad = m_dev(*((xd,) if adj_d is None else (xd, adj_d)),
                            valid=vd)
        torch.testing.assert_close(pd_.cpu(), pc, **MIL_FWD_TOL)
        torch.testing.assert_close(ad.cpu(), ac, **MIL_FWD_TOL)
        worst["probs"] = max(worst["probs"],
                             float((pd_.cpu() - pc).abs().max()))
        worst["att"] = max(worst["att"], float((ad.cpu() - ac).abs().max()))
        gc = _mil_grads(m_cpu, xc, adj_c, vc, y)
        gd = _mil_grads(m_dev, xd, adj_d, vd, y.to(device))
        top = max(float(g.abs().max()) for g in gc.values())
        for n, g in gc.items():
            if not bool(torch.isfinite(gd[n]).all()):
                raise AssertionError(f"15c {label} gradient {n} not finite")
            scale = float(g.abs().max())
            err = float((gd[n] - g).abs().max())
            if err > MIL_GRAD_TOL * scale + MIL_ZERO_GRAD * top:
                raise AssertionError(f"15c {label} gradient {n}: |card − "
                                     f"CPU| {err:.3e}, its largest "
                                     f"{scale:.3e}, the model's {top:.3e}")
            if scale > 1e-3 * top:
                worst["grad"] = max(worst["grad"], err / scale)
            else:
                worst["zero"] = max(worst["zero"], err / top)

    m = AttentionMIL(MIL_DIM, int(best_mil["hidden_dim"]),
                     int(best_mil["att_dim"]), float(best_mil["dropout"]), 7)
    TM.init_params_(m, SEED)
    compare("mil", m, None, None)
    adj_checks = []
    for graph_type in GRAPH_TYPES:
        cfg = {**best_graph, "graph_type": graph_type}
        adj_c = TM._adj_for_bag(xc, vc, cfg, generator(SEED, "cpu"))
        if graph_type == "random":
            adj_d = adj_c.to(device)
        else:
            for bag in (x, real_bag):
                bc = torch.from_numpy(np.ascontiguousarray(bag))
                want = TM._adj_for_bag(bc, vc, cfg)
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    got = TM._adj_for_bag(bc.to(device), vd, cfg)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(
                        f"15c {graph_type} adjacency: card != CPU in "
                        f"{int((got.cpu() != want).sum())} entries")
                adj_checks.append(f"{graph_type} {int(want.sum())} edges")
            adj_d = TM._adj_for_bag(xd, vd, cfg)
        for gnn_type in GNN_TYPES:
            m = TM.graph_mil_from_config({**cfg, "gnn_type": gnn_type},
                                         MIL_DIM, 7)
            TM.init_params_(m, SEED)
            compare(f"{gnn_type}/{graph_type}", m, adj_c, adj_d)
    print(f"15c card vs CPU at 196 × 768, best-params widths (AttentionMIL "
          f"{best_mil['hidden_dim']}/{best_mil['att_dim']}; GraphMIL hidden "
          f"{best_graph['gnn_hidden']} × {best_graph['gnn_layers']} layers, "
          f"heads {best_graph['gnn_heads']}, pool {best_graph['att_dim']} × "
          f"{best_graph['att_heads']}) for {', '.join(GNN_TYPES)} on "
          f"{', '.join(GRAPH_TYPES)}: worst probs {worst['probs']:.2e}, "
          f"attention {worst['att']:.2e} (tolerance {MIL_FWD_TOL}); "
          f"gradients {worst['grad']:.2e} of each tensor's largest where "
          f"that is above 1e-3 of the model's, {worst['zero']:.2e} of the "
          f"model's largest elsewhere (tolerance {MIL_GRAD_TOL} of the "
          f"tensor's + {MIL_ZERO_GRAD} of the model's); adjacency bit for "
          f"bit, kNN with TF32 "
          f"on ({'; '.join(adj_checks)}; seeded bag, then a phase 14 bag)")
    return worst


def time_mil(device, bags, labels):
    """15d: per-bag train steps (ms a step, launches a step, busy share),
    a training epoch's and an evaluation's bags/s, at the best-params
    widths on phase 14's bags."""
    from multimodal_isic_tpu_torch.core.rng import generator
    from multimodal_isic_tpu_torch.models.mil import AttentionMIL
    from multimodal_isic_tpu_torch.train import mil as TM
    best_mil, best_graph = _best_params()
    feats, valid = TM.pad_bags(bags)
    labels = np.asarray(labels)
    order = np.random.RandomState(SEED).choice(len(bags), MIL_STEPS)
    out = {}
    for kind, cfg in (("mil", best_mil), ("graph-mil", best_graph)):
        if kind == "mil":
            model = AttentionMIL(feats.shape[-1], int(cfg["hidden_dim"]),
                                 int(cfg["att_dim"]), float(cfg["dropout"]),
                                 7)
        else:
            model = TM.graph_mil_from_config(cfg, feats.shape[-1], 7)
        TM.init_params_(model, SEED)
        model.to(device)
        split = TM.BagSplit(feats, valid, labels, device,
                            cfg if kind == "graph-mil" else None)
        opt = TM.make_optimizer(model.parameters(), cfg["optimizer"],
                                float(cfg["lr"]), float(cfg["weight_decay"]))
        gen = generator(SEED, device)

        def epoch():
            return TM.train_epoch(model, opt, split, order, gen)
        steps = _host_rates(epoch, MIL_STEPS, HOST_REPS)
        prof = profile_steps(lambda: TM.train_epoch(model, opt, split,
                                                    order[:8], gen),
                             f"{kind} 8 per-bag steps", steps=1)
        evals = _host_rates(lambda: TM.predict_probs(model, split),
                            len(bags), HOST_REPS)
        med = float(np.median(steps))
        out[kind] = {"step_ms": 1e3 / med, "launches": prof["launches"] / 8,
                     "busy": prof["busy_share"], "train_bags_s": med,
                     "eval_bags_s": float(np.median(evals))}
        print(f"15d {kind} per-bag step (bs 1, {feats.shape[1]} × "
              f"{feats.shape[2]}, {cfg['optimizer']}): "
              f"{1e3 / med:.3f} ms a step ({med:.1f} bags/s, "
              f"{steps[0]:.1f}–{steps[-1]:.1f}, {HOST_REPS} epochs of "
              f"{MIL_STEPS} steps); {prof['launches'] / 8:.0f} launches a "
              f"step, busy share {prof['busy_share']:.3f}; evaluation "
              f"{float(np.median(evals)):.1f} bags/s ({len(bags)} bags in "
              f"batches of {TM.EVAL_CHUNK}) (host clock)")
    return out


def mil_chain(device, root, config, mae):
    """Phase 15: MIL cross-validation on phase 14's latents through
    ``cli.use_latent`` (both modes), the card against the CPU, times →
    numbers for PERF.md."""
    frame_path = root / "dataframes_latents" / \
        "patch_level_latents_train_df.pkl"
    walls, bags, labels = mil_single_frame(device, root, config, frame_path)
    sweep = mil_sweep(device, root, config, mae)
    worst = mil_card_vs_cpu(device, bags[0])
    times = time_mil(device, bags, labels)
    return {"walls": walls, "sweep": sweep, "worst": worst, "times": times}


HPO_SAMPLES = 8        # depth cut: cli.tune_mil's default is 1000 samples
HPO_EPOCHS = 2         # depth cut: its default is 200 epochs
HPO_GRACE, HPO_RF = 1, 2   # ASHA: the CLI's grace 10 cut with the epochs
HPO_MEMBER_BAGS, HPO_MEMBER_EPOCHS = 40, 2   # 16b: 32 train + 8 val bags
MEMBER_LOSS_RTOL = 1e-4
HPO_LARGE_BAGS = 20    # 16c: 16 train + 4 val bags of 196 × 768
HPO_MEM_GB = 30        # 16c's second budget (ISIC_HPO_MEM_GB)
HPO_COHORTS = (1, 2, 4, 8)
HPO_STEPS = 16         # 16d: timed per-bag cohort steps
# 16e: de-saturated bags (30% of the labels moved to another class, so no
# trial can reach 0.9 val_bacc), in cohorts of 8
HPO_DESAT_BAGS, HPO_DESAT_CLASSES, HPO_FLIP = 96, 4, 0.3
HPO_DESAT = {"mil": (16, 6), "graph-mil": (8, 4)}   # samples, epochs
DESAT_CEILING = 0.9
# the graph space's large end (tune_mil.py:172-200): GAT 512 × 8 heads,
# concatenated, 8 layers, pooling 512 × 8, the deep classifier at 512
LARGE_END = {"gnn_type": "gat", "gnn_hidden": 512, "gnn_layers": 8,
             "gnn_heads": 8, "gnn_concat": True, "graph_type": "grid",
             "k_neighbors": 8, "connect_diagonals": False, "att_dim": 512,
             "att_heads": 8, "classifier_dim": 512,
             "classifier_light": False, "use_residual": True,
             "use_layer_norm": True, "optimizer": "adamw"}


def _hpo_bags(n, classes, seed, flip=0.0):
    """``n`` bags of 196 × 768 float32 patches, labels cycling over
    ``classes``: N(0, 1) noise, and an eighth of each bag's patches shifted
    by 2 along its class's unit direction; a share ``flip`` of the labels
    then moved to another class → the trainables' data dict."""
    rng = np.random.RandomState(seed)
    labels = np.arange(n) % classes
    dirs = rng.randn(classes, MIL_DIM).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    bags = []
    for i in range(n):
        x = rng.randn(MIL_NODES, MIL_DIM).astype(np.float32)
        x[:MIL_NODES // 8] += 2.0 * dirs[labels[i]]
        bags.append(x)
    moved = rng.permutation(n)[:int(round(flip * n))]
    labels[moved] = (labels[moved] + rng.randint(1, classes, len(moved))) \
        % classes
    return {"train_feats": bags, "train_labels": labels}


def _no_launch(label, fn):
    """``fn()`` with every launch count set to 0 before it; fails if a
    kernel launched."""
    _reset_every_launch()
    out = fn()
    torch.cuda.synchronize()
    launched = _launched()
    if launched:
        raise AssertionError(f"{label}: kernel launches {launched}")
    return out


def _in_space(label, space, cfg):
    """Every key of ``space`` in ``cfg`` and in its support."""
    from multimodal_isic_tpu_torch.hpo.space import Choice, QRandInt
    if set(cfg) != set(space):
        raise AssertionError(f"{label}: keys {sorted(cfg)}")
    for k, spec in space.items():
        v = cfg[k]
        if isinstance(spec, Choice):
            ok = v in spec.options
        elif isinstance(spec, QRandInt):
            ok = spec.low <= v <= spec.high and float(v).is_integer()
        else:
            ok = spec.low * (1 - 1e-12) <= v <= spec.high * (1 + 1e-12)
        if not ok:
            raise AssertionError(f"{label}: {k}={v!r} outside {spec}")


def hpo_cli(device, root, config, frame_path):
    """16a: ``cli.tune_mil`` on phase 14's patch frame, ``mil`` and
    ``graph-mil``, ``--packed auto`` and ``never`` → wall seconds."""
    import yaml
    import pandas as pd
    from multimodal_isic_tpu_torch.cli import tune_mil as TTM
    from multimodal_isic_tpu_torch.hpo import GRAPH_MIL_SPACE, MIL_SPACE
    cfg = json.loads(json.dumps(config))
    cfg.update(num_classes=7)
    path = _write_yaml(root, "tune_mil", cfg)
    walls = {}
    for kind in ("mil", "graph-mil"):
        space = GRAPH_MIL_SPACE if kind == "graph-mil" else MIL_SPACE
        for packed in ("auto", "never"):
            label = f"16a {kind} --packed {packed}"
            out_dir = root / f"hpo_{kind}_{packed}"
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out, lines = _no_launch(label, lambda: _quiet(lambda: TTM.main([
                "--config_path", str(path), "--model_type", kind,
                "--num_samples", str(HPO_SAMPLES),
                "--max_epochs", str(HPO_EPOCHS),
                "--grace_period", str(HPO_GRACE),
                "--reduction_factor", str(HPO_RF), "--packed", packed,
                "--patch_df", str(frame_path),
                "--output_dir", str(out_dir)])))
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            names = sorted(p.name for p in out_dir.iterdir())
            if [n.split("_")[0] for n in names] != ["best", "hpo"]:
                raise AssertionError(f"{label}: artifacts {names}")
            table = pd.read_csv(out_dir / names[1])
            best = yaml.safe_load((out_dir / names[0]).read_text())
            errors = [t.error for t in out.get("trials", []) if t.error]
            if errors:
                raise AssertionError(f"{label}: failed trials {errors}")
            vals = table["val_bacc"].astype(float)
            if len(table) != HPO_SAMPLES or not np.isfinite(vals).all():
                raise AssertionError(f"{label}: {len(table)} rows, "
                                     f"val_bacc {vals.tolist()}")
            if best["best_config"] != out["best_config"] or peak == 0:
                raise AssertionError(f"{label}: best {best}, peak {peak}")
            _in_space(label, space, best["best_config"])
            n_stop = int(table["stopped_early"].astype(bool).sum())
            print("\n".join(f"  cli.tune_mil {kind} {packed}: {ln}"
                            for ln in lines if ln.startswith(
                                ("Packed", "Best val", "cohort"))))
            print(f"{label} ({HPO_SAMPLES} samples, {HPO_EPOCHS} epochs, "
                  f"ASHA grace {HPO_GRACE} rf {HPO_RF}): {wall:.1f} s, peak "
                  f"{peak / 2**30:.3f} GiB, no kernel launch; "
                  f"{len(table)} finite rows, {n_stop} ASHA-stopped, best "
                  f"val_bacc {vals.max():.4f}; best_config in the space; "
                  f"no trial error")
            walls[f"{kind} {packed}"] = wall
    return walls


def hpo_member(device):
    """16b: a cohort member against the sequential trial, dropout 0, at the
    best-params widths on 196 × 768 bags: every epoch's val_bacc equal and
    val_loss within ``MEMBER_LOSS_RTOL``."""
    from multimodal_isic_tpu_torch.hpo import population as HP
    from multimodal_isic_tpu_torch.train import mil as TM
    best_mil, best_graph = _best_params()
    data = _hpo_bags(HPO_MEMBER_BAGS, 7, SEED + 60)
    worst = {}
    for kind, cfg, rate_keys, shape_keys in (
            ("mil", {**best_mil, "dropout": 0.0}, ("dropout",),
             HP.SHAPE_KEYS),
            ("graph-mil", {**best_graph, "gnn_dropout": 0.0,
                           "pool_dropout": 0.0},
             ("gnn_dropout", "pool_dropout"), HP.GRAPH_SHAPE_KEYS)):
        seq_rec, pop_rec = [], {}
        kw = dict(seed=SEED, num_classes=7, patience=HPO_MEMBER_EPOCHS,
                  max_epochs=HPO_MEMBER_EPOCHS, device=device)
        trainable = TM.train_graph_mil if kind == "graph-mil" \
            else TM.train_mil
        packed = HP.train_graph_mil_population if kind == "graph-mil" \
            else HP.train_mil_population
        lr, wd = float(cfg["lr"]), float(cfg["weight_decay"])
        pop = {"lr": np.array([lr, 3 * lr]), "weight_decay": np.full(2, wd),
               **{k: np.zeros(2) for k in rate_keys}}
        shape = {k: cfg[k] for k in shape_keys if k in cfg}

        def run():
            trainable(cfg, data, report_fn=lambda r: seq_rec.append(r)
                      if "val_macro_p" in r else None, **kw)
            packed(shape, pop, data, report_fn=lambda t, m: pop_rec.setdefault(
                t, []).append(m) if "val_macro_p" in m else None, **kw)
        _no_launch(f"16b {kind}", run)
        member = pop_rec[0]
        if not len(member) == len(seq_rec) == HPO_MEMBER_EPOCHS:
            raise AssertionError(f"16b {kind}: epochs {len(member)}, "
                                 f"{len(seq_rec)}")
        rel = max(abs(m["val_loss"] - s["val_loss"]) / abs(s["val_loss"])
                  for m, s in zip(member, seq_rec))
        if any(m["val_bacc"] != s["val_bacc"] for m, s in zip(member,
                                                              seq_rec)) \
                or rel > MEMBER_LOSS_RTOL:
            raise AssertionError(
                f"16b {kind}: member {[(m['val_bacc'], m['val_loss']) for m in member]} "
                f"vs sequential {[(s['val_bacc'], s['val_loss']) for s in seq_rec]}")
        worst[kind] = rel
        print(f"16b {kind} cohort member (P 2: lr {lr:g} and {3 * lr:g}) vs "
              f"the sequential trial at {cfg['optimizer']}, dropout 0, "
              f"{HPO_MEMBER_BAGS} bags of {MIL_NODES} × {MIL_DIM}, "
              f"{HPO_MEMBER_EPOCHS} epochs, TF32 off: val_bacc equal "
              f"{[round(s['val_bacc'], 4) for s in seq_rec]}, val_loss "
              f"within {rel:.2e} relative (tolerance {MEMBER_LOSS_RTOL}); "
              f"the lr {3 * lr:g} member's val_loss "
              f"{pop_rec[1][-1]['val_loss']:.5f} vs {member[-1]['val_loss']:.5f}")
    return worst


def hpo_large_end(device, mem_gb=None):
    """16c: the graph space's large end at 196 × 768: the per-trial
    parameter bytes, the sub-cohort the budget gives (the card's default,
    or ``ISIC_HPO_MEM_GB=mem_gb``) and its counted bytes, one epoch over 16
    bags, the peak memory against the budget."""
    import os
    from multimodal_isic_tpu_torch.hpo import population as HP
    kept = os.environ.get("ISIC_HPO_MEM_GB")
    if mem_gb is None:
        os.environ.pop("ISIC_HPO_MEM_GB", None)
    else:
        os.environ["ISIC_HPO_MEM_GB"] = str(mem_gb)
    try:
        mb = HP.estimate_trial_param_bytes("graph-mil", LARGE_END, MIL_DIM,
                                           7) / 1e6
        budget = HP.memory_budget_bytes(device)
        sub = HP.max_cohort_for_shape("graph-mil", LARGE_END, MIL_DIM, 7, 8,
                                      device, MIL_NODES)
    finally:
        if kept is None:
            os.environ.pop("ISIC_HPO_MEM_GB", None)
        else:
            os.environ["ISIC_HPO_MEM_GB"] = kept
    counted = HP.estimate_cohort_bytes("graph-mil", LARGE_END, MIL_DIM, 7,
                                       sub, MIL_NODES)
    data = _hpo_bags(HPO_LARGE_BAGS, 7, SEED + 61)
    pop = {"lr": np.geomspace(1e-6, 1e-3, sub),
           "weight_decay": np.geomspace(1e-8, 1e-3, sub),
           "gnn_dropout": np.full(sub, 0.5), "pool_dropout": np.full(sub,
                                                                     0.3)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reps = _no_launch("16c", lambda: HP.train_graph_mil_population(
        LARGE_END, pop, data, seed=SEED, num_classes=7, patience=1,
        max_epochs=1, device=device))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [r["val_loss"] for r in reps]
    where = ("the card's default budget" if mem_gb is None
             else f"ISIC_HPO_MEM_GB={mem_gb}")
    print(f"16c graph space's large end (GAT {LARGE_END['gnn_hidden']} × "
          f"{LARGE_END['gnn_heads']} heads concat × "
          f"{LARGE_END['gnn_layers']} layers, pooling "
          f"{LARGE_END['att_dim']} × {LARGE_END['att_heads']}, classifier "
          f"{LARGE_END['classifier_dim']}) at {MIL_NODES} × {MIL_DIM}, "
          f"{where}: {mb:.1f} MB of parameters a trial; budget "
          f"{budget / 2**30:.2f} GiB → sub-cohort {sub}, counted "
          f"{counted / 2**30:.2f} GiB; one epoch over "
          f"{int(HPO_LARGE_BAGS * 0.8)} bags in {wall:.1f} s, val losses "
          f"{[round(v, 4) for v in losses]}, peak "
          f"{peak / 2**30:.2f} GiB")
    if not np.isfinite(losses).all() or peak > budget or len(reps) != sub:
        raise AssertionError("16c: non-finite losses or over the budget")
    return {"mb": mb, "sub": sub, "peak_gib": peak / 2**30,
            "budget_gib": budget / 2**30, "counted_gib": counted / 2**30,
            "wall": wall}


def time_cohorts(device, bags, labels, seq_times):
    """16d: the per-bag cohort step at P = 1, 2, 4, 8 on phase 14's bags
    at the best-params widths and rates: ms a step, launches a step, busy
    share, trial-bags/s (host clock)."""
    from multimodal_isic_tpu_torch.core.rng import generator
    from multimodal_isic_tpu_torch.hpo import population as HP
    from multimodal_isic_tpu_torch.train import mil as TM
    best_mil, best_graph = _best_params()
    feats, valid = TM.pad_bags(bags)
    labels = np.asarray(labels)
    order = np.random.RandomState(SEED).choice(len(bags), HPO_STEPS)
    out = {}
    for kind, cfg in (("mil", best_mil), ("graph-mil", best_graph)):
        if kind == "mil":
            spec = HP.mil_spec(cfg, 7)
            shape = {k: cfg[k] for k in HP.SHAPE_KEYS}
        else:
            spec = HP.graph_mil_spec(cfg, 7)
            shape = {k: cfg[k] for k in HP.GRAPH_SHAPE_KEYS if k in cfg}
        split = TM.BagSplit(feats, valid, labels, device, spec.graph_cfg)
        gen = generator(SEED, device)
        for p in HPO_COHORTS:
            pop = {"lr": np.full(p, float(cfg["lr"])),
                   "weight_decay": np.full(p, float(cfg["weight_decay"])),
                   **{k: np.full(p, float(cfg[k])) for k in spec.rate_keys}}
            cohort = HP.make_cohort(spec, shape, pop, feats.shape[-1], SEED,
                                    device)

            def steps(bs=order):
                for b in bs.tolist():
                    cohort.step(split.feats[b], split.valid[b],
                                split.graph(b), split.y[b], gen)
            rates = _no_launch(f"16d {kind} P {p}", lambda: _host_rates(
                steps, HPO_STEPS, HOST_REPS))
            prof = _no_launch(f"16d {kind} P {p} profile",
                              lambda: profile_steps(
                                  lambda: steps(order[:8]),
                                  f"{kind} cohort P {p}, 8 per-bag steps",
                                  steps=1))
            med = float(np.median(rates))
            out[(kind, p)] = {"step_ms": 1e3 / med,
                              "launches": prof["launches"] / 8,
                              "busy": prof["busy_share"],
                              "trial_bags_s": p * med}
            seq = seq_times.get(kind, {}).get("step_ms")
            print(f"16d {kind} cohort step P {p} ({feats.shape[1]} × "
                  f"{feats.shape[2]}, {cfg['optimizer']}, dropout as "
                  f"best_params): {1e3 / med:.3f} ms a step "
                  f"({rates[0]:.1f}–{rates[-1]:.1f} steps/s, {HOST_REPS} "
                  f"runs of {HPO_STEPS}); {prof['launches'] / 8:.0f} "
                  f"launches a step, busy share {prof['busy_share']:.3f}; "
                  f"{p * med:.1f} trial-bags/s"
                  + (f" (phase 15's sequential step {seq:.3f} ms: "
                     f"{1e3 / seq:.1f} trial-bags/s)" if seq else "")
                  + " (host clock)")
            del cohort
        del split
    return out


class _OutOfTime(Exception):
    """A sequential trial started after the packed search's wall time."""


def hpo_pruning(device):
    """16e: on de-saturated 196 × 768 bags, the packed search with ASHA
    against the same search without a scheduler (stopped trials, trial
    epochs, wall), and against the sequential runner given the packed
    run's wall time (best val_bacc) → numbers for PERF.md."""
    from multimodal_isic_tpu_torch.hpo import (ASHAScheduler,
                                               GRAPH_MIL_SPACE, MIL_SPACE,
                                               run_population_search,
                                               run_search)
    from multimodal_isic_tpu_torch.train import mil as TM
    data = _hpo_bags(HPO_DESAT_BAGS, HPO_DESAT_CLASSES, SEED + 62, HPO_FLIP)
    out = {}
    for kind, (samples, epochs) in HPO_DESAT.items():
        space = GRAPH_MIL_SPACE if kind == "graph-mil" else MIL_SPACE
        trainable = TM.train_graph_mil if kind == "graph-mil" \
            else TM.train_mil
        kw = dict(seed=SEED, max_epochs=epochs, patience=epochs,
                  num_classes=HPO_DESAT_CLASSES)

        def asha():
            return ASHAScheduler(grace_period=HPO_GRACE,
                                 reduction_factor=HPO_RF, max_t=epochs)

        def packed(sched):
            t0 = time.perf_counter()
            res = run_population_search(
                space, data, num_samples=samples, cohort_size=8,
                verbose=False, scheduler=sched, model_type=kind,
                device=device, **kw)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0
        (pa, wall_a), (pn, wall_n) = _no_launch(
            f"16e {kind} packed", lambda: (packed(asha()), packed(None)))
        t_seq = time.perf_counter()

        def budgeted(config, d, **k):
            if time.perf_counter() - t_seq > wall_a:
                raise _OutOfTime
            return trainable(config, d, **k)
        seq = _no_launch(f"16e {kind} sequential", lambda: run_search(
            budgeted, space, data, num_samples=64, scheduler=asha(),
            verbose=False, max_failures=10**6, device=device, **kw))
        wall_s = time.perf_counter() - t_seq
        ran = [t for t in seq["trials"] if not t.error]
        bad = [t.error for t in seq["trials"]
               if t.error and not t.error.startswith("_OutOfTime")]
        if bad:
            raise AssertionError(f"16e {kind} sequential: {bad}")
        ra, rn = pa["results"], pn["results"]
        best = {"packed ASHA": float(ra["val_bacc"].max()),
                "packed, no scheduler": float(rn["val_bacc"].max()),
                "sequential ASHA": max(t.final["val_bacc"] for t in ran)}
        if max(best.values()) >= DESAT_CEILING or not all(
                np.isfinite(v) for v in best.values()):
            raise AssertionError(f"16e {kind}: not de-saturated {best}")
        n_stop = int(ra["stopped_early"].astype(bool).sum())
        ep_a, ep_n = int(ra["epochs_run"].sum()), int(rn["epochs_run"].sum())
        print(f"16e {kind} on {HPO_DESAT_BAGS} de-saturated bags of "
              f"{MIL_NODES} × {MIL_DIM} ({HPO_DESAT_CLASSES} classes, "
              f"{HPO_FLIP:.0%} of the labels moved), {samples} samples in "
              f"cohorts of 8, {epochs} epochs, ASHA grace {HPO_GRACE} rf "
              f"{HPO_RF}: packed + ASHA {wall_a:.1f} s, {n_stop} stopped "
              f"early, {ep_a} trial-epochs, best val_bacc "
              f"{best['packed ASHA']:.4f}; packed without a scheduler "
              f"{wall_n:.1f} s, {ep_n} trial-epochs, best "
              f"{best['packed, no scheduler']:.4f}; sequential + ASHA in "
              f"the packed run's time: {len(ran)} trials in {wall_s:.1f} s, "
              f"best {best['sequential ASHA']:.4f} (host clock)")
        out[kind] = {"asha_wall": wall_a, "none_wall": wall_n,
                     "stopped": n_stop, "epochs": (ep_a, ep_n),
                     "seq_trials": len(ran), "seq_wall": wall_s,
                     "best": best}
    return out


def hpo_chain(device, root, config, seq_times):
    """Phase 16: the MIL search on the card → numbers for PERF.md."""
    import pandas as pd
    from multimodal_isic_tpu_torch.analysis.bags import build_patient_bags
    frame_path = root / "dataframes_latents" / \
        "patch_level_latents_train_df.pkl"
    walls = hpo_cli(device, root, config, frame_path)
    member = hpo_member(device)
    large = [hpo_large_end(device), hpo_large_end(device, HPO_MEM_GB)]
    bags, labels, _ = build_patient_bags(pd.read_pickle(frame_path))
    steps = time_cohorts(device, bags, labels, seq_times)
    pruning = hpo_pruning(device)
    return {"walls": walls, "member": member, "large": large,
            "steps": steps, "pruning": pruning}


CLUSTER_RUNS = {  # 17a: cli.cluster_latents's flags a run
    "pca-kmeans": [],
    "neighbor-density-viz": ["--embed", "neighbor", "--clusterer",
                             "density"],
    "approx-density": ["--knn_method", "approx", "--clusterer", "density"],
}
CLUSTER_STAGES = ("kNN", "layout", "PCA", "clustering", "trustworthiness",
                  "statistics")
CARD_CPU_SHARE = 0.999  # 17b: entries / labels that must agree
CARD_CPU_DIST = 1e-4    # 17b: distances, relative (with a floor, below)
REF_ROWS, REF_DIM = 2_097_152, 64   # 17c: the reference's ~2M-row table
REF_QUERIES, REF_RECALL = 4096, 0.95
REF_COMPONENTS = 128    # 17c: Gaussian components of the table


class _StageClock:
    """Wraps module functions to time them as stages (synchronised host
    clock), a nested call's time taken out of the enclosing stage's, and
    keeps what the clustering and trustworthiness calls returned."""

    def __init__(self):
        from multimodal_isic_tpu_torch.analysis import cluster as C
        from multimodal_isic_tpu_torch.analysis import embed as E
        from multimodal_isic_tpu_torch.analysis import kmeans as KM
        from multimodal_isic_tpu_torch.analysis import pca as P
        self.targets = [
            (E, "knn", "kNN"), (E, "neighbor_embedding", "layout"),
            (P, "fit", "PCA"), (E, "hdbscan_cluster", "clustering"),
            (E, "density_cluster", "clustering"),
            (KM, "fit_best_of", "clustering"),
            (C, "trustworthiness", "trustworthiness"),
            (C, "patient_class_weights", "statistics"),
            (C, "cluster_purity_stats", "statistics"),
            (C, "filter_low_purity_clusters", "statistics")]
        self.kept = [getattr(m, name) for m, name, _ in self.targets]
        self.seconds = dict.fromkeys(CLUSTER_STAGES, 0.0)
        self.returned = {}
        self._stack = []

    def _wrap(self, fn, name, stage):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            self._stack.append(0.0)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent = time.perf_counter() - t0
            inner = self._stack.pop()
            self.seconds[stage] += spent - inner
            if self._stack:
                self._stack[-1] += spent
            self.returned.setdefault(name, []).append(out)
            return out
        return timed

    def __enter__(self):
        for (mod, name, stage), fn in zip(self.targets, self.kept):
            setattr(mod, name, self._wrap(fn, name, stage))
        return self

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.targets, self.kept):
            setattr(mod, name, fn)


def _cluster_columns(frame_cols, num_classes=7):
    """The columns of JAX's ``df_filtered.pkl`` (``cli/cluster_latents.py:
    128-134``)."""
    return (list(frame_cols) + ["cluster", "cluster_same_count",
                                "cluster_other_count", "cluster_prop_same",
                                "cluster_ratio_same_other",
                                "cluster_prop_same_weighted"]
            + [f"cluster_count_class_{c}" for c in range(num_classes)])


def cluster_cli(device, root, config, frame_path):
    """17a: ``cli.cluster_latents`` on phase 14's patch table, three
    backbones, each run with every launch count at 0 and still 0 after;
    then ``cli.fetch_experiments`` over the run directories of phases
    13–16 → the runs' numbers."""
    import importlib.util
    import pandas as pd
    from multimodal_isic_tpu_torch.cli import cluster_latents as TCL
    from multimodal_isic_tpu_torch.cli import fetch_experiments as TFE
    from multimodal_isic_tpu_torch.utils import viz
    frame = pd.read_pickle(frame_path)
    rows, width = len(frame), len(frame["patch_latent_pca"].iloc[0])
    path = _write_yaml(root, "cluster", config)
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    raised = [] if has_mpl else _plots_without_matplotlib(
        viz, ("embedding_scatter",))
    runs = {}
    for name, flags in CLUSTER_RUNS.items():
        label = f"17a cluster_latents {name}"
        out = root / f"df_filtered_{name}.pkl"
        viz_prefix = root / "cluster_viz"
        extra = (["--viz_out", str(viz_prefix)] if name.endswith("viz")
                 else [])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _StageClock() as clock:
            _, lines = _no_launch(label, lambda: _quiet(lambda: TCL.main(
                ["--config_path", str(path), "--patch_df",
                 str(frame_path), "--out", str(out), *flags, *extra])))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        kept = pd.read_pickle(out)
        if list(kept.columns) != _cluster_columns(frame.columns):
            raise AssertionError(f"{label}: columns {list(kept.columns)}")
        stats = kept[["cluster_prop_same",
                      "cluster_prop_same_weighted"]].values
        if not len(kept) or not np.isfinite(stats).all():
            raise AssertionError(f"{label}: {len(kept)} rows kept")
        labels = (clock.returned["fit_best_of"][0][1].cpu().numpy()
                  if name == "pca-kmeans"
                  else clock.returned["hdbscan_cluster"][0])
        trust = clock.returned["trustworthiness"]
        n_clusters = len(np.unique(labels[labels >= 0]))
        noise = int((labels < 0).sum())
        if extra:
            page = Path(f"{viz_prefix}_interactive.html")
            pngs = [Path(f"{viz_prefix}_{m}.png")
                    for m in ("euclidean", "cosine")]
            if not page.exists() or (has_mpl and not all(
                    p.exists() for p in pngs)):
                raise AssertionError(f"{label}: viz files missing")
        print("\n".join(f"  cli.cluster_latents {name}: {ln}"
                        for ln in lines))
        print(f"{label}: {rows} rows × {width}, {wall:.1f} s, peak "
              f"{peak / 2**30:.3f} GiB, no kernel launch; stages "
              + ", ".join(f"{k} {v:.2f} s"
                          for k, v in clock.seconds.items())
              + f"; trustworthiness {[round(t, 4) for t in trust]}; "
              f"{n_clusters} clusters, {noise} noise; {len(kept)} rows "
              f"kept with JAX's columns")
        runs[name] = {"wall": wall, "stages": dict(clock.seconds),
                      "trust": trust, "clusters": n_clusters,
                      "noise": noise, "peak_gib": peak / 2**30}
    if not has_mpl:
        print(f"17a NOTE: matplotlib is not installed on this machine; each "
              f"embedding_scatter call raised ImportError ({raised}), the "
              f"interactive page was written")
    log_dirs = sorted({p.parent.parent for p in root.rglob("metrics.jsonl")})
    rows_out = []
    for log_dir in log_dirs:
        _, printed = _quiet(lambda: TFE.main(["--log_dir", str(log_dir)]))
        print(f"17a fetch_experiments {log_dir.relative_to(root)}: "
              + " | ".join(printed))
        rows_out += [ln for ln in printed if ln.endswith("\\\\")]
    if not any(re.search(r"\d+\.\d+ \$\\pm\$", r) for r in rows_out):
        raise AssertionError(f"17a fetch_experiments: no LaTeX row with a "
                             f"metric ({rows_out})")
    return runs


def _shared_entries(x, nbr_a, dist_a, nbr_b, dist_b):
    """Share of the (row, neighbour) entries of graph b also in graph a,
    an entry also counting where a holds another neighbour at the same
    distance within the tolerance (duplicate rows tie, and either may be
    kept), and
    over the shared entries the largest relative distance difference, with
    a floor of ``CARD_CPU_DIST`` × the rows' norm (float32 rounds the
    expanded ‖q‖² − 2q·c + ‖c‖² at that scale, not at d's)."""
    norm = np.sqrt((x.astype(np.float64) ** 2).sum(1))
    same, worst = 0, 0.0
    for r in range(len(nbr_b)):
        shared, ia, ib = np.intersect1d(nbr_a[r], nbr_b[r],
                                        return_indices=True)
        same += len(shared)
        if len(shared):
            a = dist_a[r][ia].astype(np.float64)
            b = dist_b[r][ib].astype(np.float64)
            scale = np.maximum(b, CARD_CPU_DIST * (norm[r] + norm[shared]))
            worst = max(worst, float(np.max(np.abs(a - b) / scale)))
        rest_a = list(np.delete(dist_a[r], ia))
        for d in np.delete(dist_b[r], ib):
            tol = CARD_CPU_DIST * max(float(d), 2.0 * norm[r])
            tie = [i for i, e in enumerate(rest_a) if abs(e - d) <= tol]
            if tie:
                rest_a.pop(tie[0])
                same += 1
    return same / nbr_b.size, worst


def cluster_card_vs_cpu(device, frame_path):
    """17b: on phase 14's table, the exact kNN graph, Lloyd from one set of
    initial centers and HDBSCAN given one graph, on the card against the
    same functions on the CPU."""
    import pandas as pd
    from multimodal_isic_tpu_torch.analysis import embed as E
    from multimodal_isic_tpu_torch.analysis import kmeans as KM
    frame = pd.read_pickle(frame_path)
    x = np.stack([np.asarray(v, np.float32)
                  for v in frame["patch_latent_pca"]])
    xd = torch.from_numpy(x).to(device)
    t0 = time.perf_counter()
    nbr_d, dist_d = E.knn_graph(xd, 15)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    nbr_c, dist_c = E.knn_graph(x, 15, device="cpu")
    t_cpu = time.perf_counter() - t0
    share, worst = _shared_entries(x, nbr_d.cpu().numpy(),
                                   dist_d.cpu().numpy(), nbr_c.numpy(),
                                   dist_c.numpy())
    print(f"17b exact knn_graph (k 15) on {x.shape[0]} × {x.shape[1]}: "
          f"card {t_card:.2f} s, CPU {t_cpu:.2f} s; {share:.5f} of the "
          f"entries equal, distances within {worst:.2e} relative")
    if share < CARD_CPU_SHARE or worst > CARD_CPU_DIST:
        raise AssertionError("17b knn_graph: the card disagrees")

    init = KM.kmeanspp_init(torch.Generator().manual_seed(SEED), x, 20)
    _, lab_d = KM.lloyd(xd, init.to(device))
    _, lab_c = KM.lloyd(torch.from_numpy(x), init)
    agree = float((lab_d.cpu() == lab_c).float().mean())
    print(f"17b lloyd (k 20, 100 iterations) from one set of k-means++ "
          f"centers: labels equal at {agree:.5f}")
    if agree < CARD_CPU_SHARE:
        raise AssertionError("17b lloyd: the card disagrees")

    graph = (nbr_d, dist_d)
    hd = E.hdbscan_cluster(x, precomputed_knn=graph, device=device)
    hc = E.hdbscan_cluster(x, precomputed_knn=tuple(t.cpu() for t in graph),
                           device="cpu")
    print(f"17b hdbscan_cluster given the card's graph: "
          f"{len(np.unique(hd[hd >= 0]))} clusters, {(hd < 0).sum()} noise "
          f"on the card; labels {'equal' if np.array_equal(hd, hc) else 'DIFFER'}"
          f" on the CPU")
    if not np.array_equal(hd, hc):
        raise AssertionError("17b hdbscan_cluster: the card disagrees")
    return {"knn_share": share, "knn_dist": worst, "lloyd": agree}


def reference_table(device, seed=SEED + 70):
    """17c's table: ``REF_ROWS`` × ``REF_DIM`` float32 from a seeded mixture of
    ``REF_COMPONENTS`` Gaussians, each dimension's spread decaying as a PCA
    projection's does (the stand-in for ``patch_latent_pca``), made on the
    card → (card tensor, host copy)."""
    rows, dim = REF_ROWS, REF_DIM
    g = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn(REF_COMPONENTS, dim, generator=g, device=device)
    decay = 0.93 ** torch.arange(dim, device=device, dtype=torch.float32)
    spread = 0.15 + 0.35 * torch.rand(REF_COMPONENTS, 1, generator=g,
                                      device=device)
    which = torch.randint(0, REF_COMPONENTS, (rows,), generator=g,
                          device=device)
    x = (centers[which] * 3.0 * decay
         + torch.randn(rows, dim, generator=g, device=device)
         * spread[which] * decay)
    return x, x.cpu().numpy()


def _stage(label, fn):
    """``fn()`` timed on a synchronised host clock, its peak memory → (out,
    seconds, peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = _no_launch(label, fn)
    return out, time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated() / 2**30


def cluster_reference_scale(device):
    """17c: the approximate kNN graph (k 15, default nprobe) of a
    2,097,152 × 64 table with its recall@15 on 4,096 sampled queries, then
    HDBSCAN and the neighbour embedding on that graph and k-means (k 20)."""
    from multimodal_isic_tpu_torch.analysis import ann as A
    from multimodal_isic_tpu_torch.analysis import embed as E
    from multimodal_isic_tpu_torch.analysis import kmeans as KM
    t0 = time.perf_counter()
    xd, x = reference_table(device)
    print(f"17c table: {x.shape[0]} × {x.shape[1]} float32 "
          f"({x.nbytes / 2**20:.0f} MiB; width 64 stands in for "
          f"patch_latent_pca: a reduction), {REF_COMPONENTS} Gaussian "
          f"components, made in {time.perf_counter() - t0:.1f} s")
    out = {}
    (nbr, dist), out["knn_s"], out["knn_gib"] = _stage(
        "17c approx_knn_graph", lambda: A.approx_knn_graph(
            x, 15, device=device))
    print(f"17c approx_knn_graph (k 15, default nprobe): "
          f"{out['knn_s']:.1f} s, peak {out['knn_gib']:.2f} GiB", flush=True)
    q = torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(
        SEED))[:REF_QUERIES]
    exact, _ = E.knn_graph(xd, 15, rows=q.to(device))
    out["recall"] = A.knn_recall(nbr[q.numpy()], exact.cpu().numpy(),
                                 dist[q.numpy()])
    print(f"17c recall@15 {out['recall']:.4f} on {REF_QUERIES} sampled "
          f"queries against the exact graph (bar {REF_RECALL}); "
          f"{int((dist >= A.FINITE).sum())} unfilled slots")
    if out["recall"] < REF_RECALL:
        raise AssertionError("17c: recall under the bar")
    graph = (torch.from_numpy(nbr).to(device), torch.from_numpy(dist).to(
        device))
    labels, out["hdbscan_s"], out["hdbscan_gib"] = _stage(
        "17c hdbscan_cluster", lambda: E.hdbscan_cluster(
            x, precomputed_knn=graph, device=device))
    print(f"17c hdbscan_cluster on that graph: {out['hdbscan_s']:.1f} s, "
          f"peak {out['hdbscan_gib']:.2f} GiB; "
          f"{len(np.unique(labels[labels >= 0]))} clusters, "
          f"{int((labels < 0).sum())} noise")
    (state, km), out["kmeans_s"], out["kmeans_gib"] = _stage(
        "17c kmeans", lambda: KM.fit_best_of(
            torch.Generator(device=device).manual_seed(SEED), xd, 20))
    print(f"17c kmeans.fit_best_of (k 20, 4 restarts batched): "
          f"{out['kmeans_s']:.1f} s, peak {out['kmeans_gib']:.2f} GiB; "
          f"inertia {float(state.inertia):.6g}, {int(state.n_iter)} shifts "
          f"above tol, {len(torch.unique(km))} clusters")
    emb, out["layout_s"], out["layout_gib"] = _stage(
        "17c neighbor_embedding", lambda: E.neighbor_embedding(
            x, precomputed_knn=graph, device=device))
    if emb.shape != (x.shape[0], 2) or not np.isfinite(emb).all():
        raise AssertionError(f"17c neighbor_embedding: {emb.shape}")
    print(f"17c neighbor_embedding (2-d, 500 epochs, "
          f"{E.layout_segments(nbr.size)} segments) on that graph: "
          f"{out['layout_s']:.1f} s, peak {out['layout_gib']:.2f} GiB")
    return out


def cluster_chain(device, root, config):
    """Phase 17: latent clustering on the card → numbers for PERF.md."""
    frame_path = root / "dataframes_latents" / \
        "patch_level_latents_train_df.pkl"
    runs = cluster_cli(device, root, config, frame_path)
    agree = cluster_card_vs_cpu(device, frame_path)
    ref = cluster_reference_scale(device)
    return {"runs": runs, "agree": agree, "ref": ref}


# ----------------------------------------------- 18. several processes

PAR_RANKS = 2             # ranks a group: two processes share the one card
PAR_TIMEOUT_S = 240       # wall timeout of a group of ranks
PAR_BATCH = 16            # 18a, 18c, 18d: the global batch (8 a rank)
PAR_STEPS = 4             # 18a: fusion train steps from one seed
# 18a-18d, the parallel programs against one process on the card
# (``parallel.checks.compare_states``): after the steps, |got − want| ≤
# atol + rtol·|want| for every parameter and BN statistic; losses rtol 1e-5.
# float32 sums in another order (global-batch BN's parallel variance, the
# ranks' gradient mean, the row-split partial products), no TF32
PAR_TOL = dict(rtol=1e-4, atol=1e-6)
# 18b: the 2-rank test pass (8 rows a forward) against one process's
# evaluation of the same checkpoint (16 rows a forward): other GEMM shapes
RANK_LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
PAR_VAL_RTOL = 1e-5       # 18c: the gathered val_n_true loss, one process
# 18a/c/d's sizes, handed to the ranks (a CPU rehearsal shrinks them)
PAR_PROGRAMS = dict(hw=IMG, src_hw=450, batch=PAR_BATCH, steps=PAR_STEPS,
                    mae_img=224)
PAR_MAE_SIZE = "base"     # 18c's cli.train_ae model (ConvViT-Base)
PAR_HPO = ["--model_type", "mil", "--num_samples", "8", "--max_epochs", "2",
           "--patience", "2", "--grace_period", "1", "--cohort_size", "4"]


def run_group(n, target, kwargs, label, timeout_s=PAR_TIMEOUT_S):
    """Ranks 0..n-1 of ``target`` ('module:function') with a ``FileStore``
    under ``build/``, a wall timeout and every rank's output kept
    (``build/ranks_*/rank<r>.log``) → (each rank's result, wall seconds).
    A rank that fails or a group past its timeout fails the phase."""
    from multimodal_isic_tpu_torch.parallel.launch import (rank_command,
                                                           rank_results,
                                                           run_ranks)
    work = Path(__file__).resolve().parent / "build"
    work.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    outs = run_ranks(n, rank_command(target, kwargs), str(work), timeout_s)
    wall = time.perf_counter() - t0
    for r, out in enumerate(outs):
        for line in out.splitlines():
            if line.startswith(("torch.distributed:", "  [rank")):
                print(f"  {label} rank {r}: {line}")
    return rank_results(outs), wall


def _rank_setup(device):
    """A rank of phase 18: TF32 off as in every phase, the group joined
    (gloo: the ranks share the card), the grid and the rank's device."""
    from multimodal_isic_tpu_torch.parallel import distributed as D
    from multimodal_isic_tpu_torch.parallel.sharding import make_grid
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    D.initialize(device=device)
    return make_grid(), D.rank_device(device)


def rank_programs(device, hw, src_hw, batch, steps, mae_img):
    """18a, 18c's step and 18d in one rank: the fusion DP steps (B3@380
    f32, the fast policy), the MAE DP step (ConvViT-Base f32, B9/B10), the
    MAE TP step (its blocks split over the 2 ranks, B11 on the local
    heads), each against one process on rank 0."""
    from multimodal_isic_tpu_torch.parallel import checks as C
    from multimodal_isic_tpu_torch.parallel.sharding import make_grid
    grid, device = _rank_setup(device)
    out = {"fusion": C.fusion_dp_check(
        grid, device, backbone="efficientnet-b3", hw=hw, src_hw=src_hw,
        batch=batch, steps=steps, **PAR_TOL)}
    out["mae"] = C.mae_check(grid, device, dict(
        img_size=mae_img, norm_pix_loss=True, use_fused_mlp=True),
        batch=batch, mask_ratio=MASK_RATIO, **PAR_TOL)
    out["tp"] = C.mae_check(make_grid(n_model=PAR_RANKS), device, dict(
        img_size=mae_img, norm_pix_loss=True, use_fused_mlp=True,
        use_flash_attention=True), batch=batch, mask_ratio=MASK_RATIO,
        tp=True, **PAR_TOL)
    return out


def _want_launches(label, got, want):
    """Fail unless every rank's launch counts ``got`` are ``want``."""
    if got != [want] * len(got):
        raise AssertionError(f"{label}: launches a rank {got} != {want}")


def rank_clis(paths, hpo_dir, frame_path, device):
    """18b, 18c's CLI, 18e and 18f in one rank: ``cli.main``,
    ``cli.train_ae``, ``cli.extract_radiomics`` and ``cli.tune_mil`` one
    after the other under ``ISIC_*``, each with the launch counts at 0
    before it and read after it."""
    import importlib.util
    from multimodal_isic_tpu_torch.cli import extract_radiomics as XR
    from multimodal_isic_tpu_torch.cli import main as M
    from multimodal_isic_tpu_torch.cli import train_ae as TA
    from multimodal_isic_tpu_torch.cli import tune_mil as TU
    from multimodal_isic_tpu_torch.parallel import distributed as D
    from multimodal_isic_tpu_torch.utils import viz
    _, dev = _rank_setup(device)
    rank = D.process_index()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if importlib.util.find_spec("matplotlib") is None:
        _plots_without_matplotlib(viz)  # the hook's plots raise, recorded
    out = {}
    for name, run in (
            ("main", lambda: M.main(["--config_path", paths["main"]])),
            ("train_ae", lambda: TA.main(["--config_path", paths["mae"]])),
            ("extract_radiomics",
             lambda: XR.main(["--config_path", paths["rad"]])),
            ("tune_mil", lambda: TU.main([
                "--config_path", paths["hpo"], *PAR_HPO, "--patch_df",
                frame_path, "--output_dir", f"{hpo_dir}{rank}"]))):
        _reset_every_launch()
        sync()
        t0 = time.perf_counter()
        res = run()
        sync()
        out[name] = {"wall": time.perf_counter() - t0,
                     "launches": _every_launch_counts()}
        if name == "main":
            np.save(f"{paths['main']}.logits{rank}.npy", res["logits"].numpy())
            out[name].update(model_path=res["model_path"],
                             run_dir=res["run_dir"])
        elif name == "train_ae":
            out[name].update(model_path=res["model_path"],
                             run_dir=res["run_dir"],
                             val=res["best_val_loss"],
                             history=res["history"])
        elif name == "tune_mil":
            res["results"].to_csv(f"{hpo_dir}{rank}.csv", index=False)
    return out


def _every_launch_counts():
    return {k: int(fn.launches) for k, fn in _every_launch().items()}


def _nccl_world_one(device):
    """A world-1 group through the backend rule (one rank, one card:
    nccl) on a ``FileStore``: an all-reduce, an object gather, a barrier."""
    from multimodal_isic_tpu_torch.parallel import distributed as D
    store = Path(__file__).resolve().parent / "build" / "nccl_world1.store"
    store.unlink(missing_ok=True)
    D.initialize(store.as_uri(), 1, 0, device=device)
    try:
        import torch.distributed as dist
        backend = dist.get_backend()
        got = D.gather_to_host(torch.arange(4, device=device))
        objs = D.all_gather_object({"rank": 0})
        D.barrier()
    finally:
        D.shutdown()
    if backend != "nccl" or got.tolist() != [0, 1, 2, 3] or objs != [
            {"rank": 0}]:
        raise AssertionError(f"world-1 group: backend {backend}, {got}, "
                             f"{objs}")
    print("18: a world-1 group on the card: the rule chose nccl; "
          "all-reduce, object gather and barrier ran")


def _held(label, r):
    if not (r["err"]["ok"] and r["losses_ok"]):
        raise AssertionError(f"{label}: {r['err']}, losses_ok "
                             f"{r['losses_ok']}")


def parallel_chain(device, root, config, rad_frames, frame_path):
    """Phase 18: the parallel layer in 2 processes on the one card (gloo)
    → numbers for PERF.md.  ``rad_frames`` are the one-process radiomics
    frames of ``config``'s manifests (phase 14's), ``frame_path`` a patch
    frame (phase 14's latents)."""
    import pandas as pd
    from multimodal_isic_tpu_torch.cli.main import GLOBAL_BS, _empty_model
    from multimodal_isic_tpu_torch.core import checkpoint
    from multimodal_isic_tpu_torch.core.rng import RngPool
    from multimodal_isic_tpu_torch.data import augment
    from multimodal_isic_tpu_torch.data.pipeline import (DermRecords,
                                                         DeviceLoader)
    from multimodal_isic_tpu_torch.models.convmae import ConvMAE
    from multimodal_isic_tpu_torch.models.fusion import fold_fusion_params
    from multimodal_isic_tpu_torch.train import fusion as T
    from multimodal_isic_tpu_torch.train.mae import \
        make_mae_eval_persample_step
    from multimodal_isic_tpu_torch.utils.logging import read_metrics
    import os
    import shutil
    from multimodal_isic_tpu_torch.core.splits import StratifiedKFold
    out = {}
    _nccl_world_one(device)

    # 18a, 18c's step, 18d: the parallel programs against one process
    res, wall = run_group(PAR_RANKS, "chip_smoke:rank_programs",
                          dict(PAR_PROGRAMS, device=device.type), "18a/c/d")
    out["programs_wall"] = wall
    fus = res[0]["fusion"]
    _held("18a fusion DP", fus)
    warps = [r["fusion"]["warp_launches"] for r in res]
    print(f"18a fusion DP (B3@380 f32, global bs {PAR_BATCH} = "
          f"{PAR_RANKS} × {PAR_BATCH // PAR_RANKS}, fast policy, "
          f"{PAR_STEPS} steps, global-batch BN, dropout on): losses "
          f"{[f'{v:.6f}' for v in fus['losses']]} vs one process "
          f"{[f'{v:.6f}' for v in fus['ref_losses']]}; parameters and BN "
          f"statistics max_abs_err {fus['err']['max_abs']:.3e} (worst "
          f"{fus['err']['worst']}, {PAR_TOL}); warp launches a rank {warps}")
    _want_launches("18a", warps, PAR_PROGRAMS["steps"])
    out["fusion_img_s"] = (fus["img_s"], fus["ref_img_s"])
    print(f"18a clocks (host, steps 2-{PAR_STEPS}, a device sync at each "
          f"end): 2 ranks on the one card {fus['img_s']:.1f} img/s; one "
          f"process {fus['ref_img_s']:.1f} img/s")
    for key, label, want in (
            ("mae", "18c MAE DP step (ConvViT-Base f32, mask 0.75, B9/B10, "
             "SGD)", {"fused_ln_mlp": 4, "fused_ln_mlp_backward": 4}),
            ("tp", "18d MAE TP step (blocks split over 2 ranks: 6 of 12 "
             "encoder heads, 8 of 16 decoder heads a rank)",
             {"flash_attention": 19, "fused_ln_mlp": 4})):
        r = res[0][key]
        _held(label, r)
        got = [{k: x[key]["launches"][k] for k in want} for x in res]
        print(f"{label}: loss {r['loss']:.6f} vs one process "
              f"{r['ref_loss']:.6f}; max_abs_err {r['err']['max_abs']:.3e} "
              f"({PAR_TOL}); step {r['seconds'] * 1e3:.1f} ms vs one "
              f"process {r['ref_seconds'] * 1e3:.1f} ms (host clock, "
              f"first step); launches a rank {got}")
        _want_launches(label, got, want)
        out[key] = (r["seconds"], r["ref_seconds"])

    # 18b, 18c's CLI, 18e, 18f: the CLIs in 2 processes
    par = root / "par"
    shutil.rmtree(par, ignore_errors=True)
    par.mkdir(parents=True)
    main_cfg = json.loads(json.dumps(config))
    main_cfg.update(model_path=str(par / "models"), log_dir=str(par / "runs"))
    main_cfg["training_plan"]["parameters"].update(epochs=1)
    mae_cfg = json.loads(json.dumps(config))
    mae_cfg.update(model_path=str(par / "mae_models"),
                   log_dir=str(par / "mae_runs"))
    mae_cfg["training_plan"]["parameters"].update(
        epochs=1, batch_size=VAL_BATCH, model_size=PAR_MAE_SIZE,
        norm_pix_loss=True,
        masking_ratio=MASK_RATIO, eval_masking_ratio=MASK_RATIO,
        include_lesion_mask=False, use_flash_attention=True,
        device_cache=False)
    rad_cfg = json.loads(json.dumps(config))
    rad_cfg["dir"].update(radiomics=str(par / "rad.pkl"),
                          radiomics_test=str(par / "rad_test.pkl"))
    hpo_cfg = {"seed": SEED, "device": config["device"], "num_classes": 7}
    paths = {k: str(_write_yaml(par, k, c)) for k, c in (
        ("main", main_cfg), ("mae", mae_cfg), ("rad", rad_cfg),
        ("hpo", hpo_cfg))}
    res, wall = run_group(PAR_RANKS, "chip_smoke:rank_clis",
                          {"paths": paths, "hpo_dir": str(par / "hpo"),
                           "frame_path": str(frame_path),
                           "device": device.type}, "18b/c/e/f")
    out["clis_wall"] = wall
    out["cli_walls"] = {k: [r[k]["wall"] for r in res] for k in res[0]}

    # 18b: cli.main
    m0 = res[0]["main"]
    events = read_metrics(m0["run_dir"])
    losses = [e["value"] for e in events if e["name"].endswith("epoch_loss")]
    runs = os.listdir(par / "runs")
    df_test = pd.read_pickle(config["dir"]["df_test"])
    n_test = len(df_test)
    logits = np.load(f"{paths['main']}.logits0.npy")
    same = np.array_equal(logits, np.load(f"{paths['main']}.logits1.npy"))
    df = pd.read_pickle(config["dir"]["df"])
    fold = list(StratifiedKFold(n_splits=10, shuffle=True,
                                random_state=SEED).split(df, df["dx"]))[1]
    forwards = -(-n_test // GLOBAL_BS)  # a rank's test forwards of 8 rows
    want = {"dw_silu_pool": 2 * forwards, "expand_dw_silu_pool": 20 * forwards,
            "affine_warp_batch": len(fold[0]) // GLOBAL_BS}
    got = [{k: r["main"]["launches"][k] for k in want} for r in res]
    rad_red = config["dir"].get("radiomics_test_red")
    rad_test = (pd.read_pickle(rad_red).values
                if rad_red and os.path.exists(rad_red) else None)
    records = DermRecords(df_test, radiomics=rad_test)
    plan = config["training_plan"]
    model = _empty_model(device, modality=plan["modality"],
                         fusion_level=plan["fusion_level"],
                         fusion_strategy=plan["fusion"],
                         radiomics_dim=records.radiomics_dim,
                         backbone=plan["parameters"]["backbone"],
                         backbone_bn_folded=True,
                         backbone_pallas_serving=True)
    model.load_state_dict(fold_fusion_params(checkpoint.restore_checkpoint(
        m0["model_path"], device=device),
        backbone=plan["parameters"]["backbone"]))
    step = T.make_fusion_eval_step(model)
    one = torch.cat([step(b)[1] for b in DeviceLoader(
        records, GLOBAL_BS, transform=augment.POLICIES["fusion_eval"],
        device=device)]).float().cpu().numpy()
    err = float(np.abs(logits - one).max())
    print(f"18b cli.main in 2 processes (B3@380 f32, 1 epoch, streaming "
          f"loader, fold_bn_eval): {len(runs)} run record, losses "
          f"{[f'{v:.4f}' for v in losses]}; test logits {logits.shape} "
          f"({n_test} true rows; the ranks' copies equal: {same}); the "
          f"checkpoint restored in one process: max_abs_err {err:.3e} "
          f"({RANK_LOGIT_TOL}); launches a rank {got} ({forwards} test "
          f"forwards and {want['affine_warp_batch']} train steps a rank); wall {out['cli_walls']['main']} s")
    if len(runs) != 1 or not losses or not all(map(math.isfinite, losses)) \
            or logits.shape != (n_test, 7) or not same:
        raise AssertionError("18b cli.main in 2 processes")
    _want_launches("18b", got, want)
    np.testing.assert_allclose(logits, one, **RANK_LOGIT_TOL)

    # 18c: cli.train_ae, its val_n_true loss against one process
    a0 = res[0]["train_ae"]
    if res[1]["train_ae"]["model_path"] is not None or \
            len(os.listdir(par / "mae_runs")) != 1:
        raise AssertionError("18c: rank 1 wrote a checkpoint or a record")
    val_records = DermRecords(df.iloc[fold[1]])
    from multimodal_isic_tpu_torch.cli import train_ae as TA
    with torch.device("meta"):
        mae = ConvMAE(**TA.model_config(
            mae_cfg["training_plan"]["parameters"], device))
    mae.to_empty(device=device)
    mae.load_state_dict(checkpoint.restore_checkpoint(a0["model_path"],
                                                      device=device))
    n_val = len(val_records)
    gen = RngPool(SEED, device)["eval"].at(0)
    ps = make_mae_eval_persample_step(mae, MASK_RATIO)
    per = torch.cat([ps(b["image"], gen) for b in DeviceLoader(
        val_records, TA.VAL_BS, order=np.resize(np.arange(n_val), TA.VAL_BS),
        transform=augment.POLICIES["mae_eval"], device=device)])[:n_val]
    want_val = float(per.double().mean())
    alaunch = [{k: r["train_ae"]["launches"][k] for k in (
        "fused_ln_mlp", "fused_ln_mlp_backward", "flash_attention")}
        for r in res]
    print(f"18c cli.train_ae in 2 processes (ConvViT-Base f32, global bs "
          f"{VAL_BATCH}, 1 epoch): history {a0['history']}; val_n_true loss "
          f"{a0['val']:.6f} vs one process on the saved weights "
          f"{want_val:.6f} (rtol {PAR_VAL_RTOL}); launches a rank "
          f"{alaunch}; wall {out['cli_walls']['train_ae']} s")
    if not math.isclose(a0["val"], want_val, rel_tol=PAR_VAL_RTOL) or \
            res[1]["train_ae"]["val"] != a0["val"]:
        raise AssertionError("18c val_n_true loss")

    # 18e: cli.extract_radiomics
    two = (pd.read_pickle(par / "rad.pkl"), pd.read_pickle(par / "rad_test.pkl"))
    chunks = [-(-len(f) // 16) for f in two]
    mine = [sum(len(range(r, c, PAR_RANKS)) for c in chunks)
            for r in range(PAR_RANKS)]
    rlaunch = [{k: r["extract_radiomics"]["launches"][k] for k in RAD_KERNELS}
               for r in res]
    worst = 0.0
    for got_f, want_f in zip(two, rad_frames):
        if list(got_f.columns) != list(want_f.columns) or \
                got_f.shape != want_f.shape:
            raise AssertionError("18e frame columns or shape")
        g, w = got_f.values, want_f.values
        if not np.array_equal(np.isnan(g), np.isnan(w)):
            raise AssertionError("18e NaNs at other places")
        ok = ~np.isnan(w)
        bad = np.abs(g[ok] - w[ok]) > RAD_TOL["atol"] + RAD_TOL["rtol"] * \
            np.abs(w[ok])
        worst = max(worst, float(np.abs(g[ok] - w[ok]).max()))
        if bad.any():
            raise AssertionError(f"18e {int(bad.sum())} values outside "
                                 f"{RAD_TOL}")
    print(f"18e cli.extract_radiomics in 2 processes: frames "
          f"{[f.shape for f in two]} in the one-process row order, against "
          f"phase 14's: max_abs_err {worst:.3e} ({RAD_TOL}); chunks a rank "
          f"{mine}, launches a rank {rlaunch}; wall "
          f"{out['cli_walls']['extract_radiomics']} s")
    for r, m in enumerate(mine):
        _want_launches(f"18e rank {r}", [rlaunch[r]],
                       {k: 13 * m for k in RAD_KERNELS})

    # 18f: cli.tune_mil
    tables = [pd.read_csv(f"{par / 'hpo'}{r}.csv") for r in range(PAR_RANKS)]
    arts = sorted(p.name.split("_")[0] for p in (par / "hpo0").iterdir())
    if not tables[0].equals(tables[1]) or len(tables[0]) != 8 or \
            tables[0]["trial_id"].nunique() != 8 or \
            not np.isfinite(tables[0]["val_bacc"]).all() or \
            arts != ["best", "hpo"] or (par / "hpo1").exists():
        raise AssertionError("18f cli.tune_mil in 2 processes")
    tl = [r["tune_mil"]["launches"] for r in res]
    _want_launches("18f", tl, {k: 0 for k in tl[0]})
    print(f"18f cli.tune_mil in 2 processes (mil, 8 samples × 2 epochs, "
          f"cohorts of 4: one a rank): one table of 8 trials on both ranks, "
          f"val_bacc max {tables[0]['val_bacc'].max():.4f}; artifacts on "
          f"rank 0 only; no kernel launch; wall "
          f"{out['cli_walls']['tune_mil']} s")
    out["launches"] = {
        "affine_warp_batch": warps[0],
        "dw_silu_pool": got[0]["dw_silu_pool"],
        "expand_dw_silu_pool": got[0]["expand_dw_silu_pool"],
        **rlaunch[0], "fused_ln_mlp": res[0]["train_ae"]["launches"][
            "fused_ln_mlp"],
        "fused_ln_mlp_backward": res[0]["train_ae"]["launches"][
            "fused_ln_mlp_backward"],
        "flash_attention": res[0]["train_ae"]["launches"]["flash_attention"]}
    return out


def _write_yaml(root: Path, name: str, config: dict) -> Path:
    import yaml
    path = root / f"{name}.yml"
    path.write_text(yaml.safe_dump(config))
    return path


def to_device_batch(reqs, device, sl=slice(None)):
    return {k: torch.from_numpy(np.ascontiguousarray(v[sl])).to(device)
            for k, v in reqs.items()}


def prepare() -> torch.device:
    """Phases 1 and 2: float32 products in full float32 (no TF32), the
    card's name and power limit printed, and every kernel library built,
    one ``nvcc`` per source, all started together → the card.  A phase run
    alone starts with this (README)."""
    from multimodal_isic_tpu_torch.ops import _build
    from multimodal_isic_tpu_torch.ops import affine_warp as aw
    from multimodal_isic_tpu_torch.ops import attention, color_jitter
    from multimodal_isic_tpu_torch.ops import connected_components as cc
    from multimodal_isic_tpu_torch.ops import fused_convblock, fused_mlp
    from multimodal_isic_tpu_torch.ops import fused_dwconv as fd
    from multimodal_isic_tpu_torch.ops import glcm, glrlm_runs, histogram

    # float32 in full float32 (no TF32), for the plain versions, the
    # comparisons and the float32 training
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

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
            "fused_ln_mlp_bwd": fused_mlp._bwd_lib,
            "firstorder": histogram._fo_lib, "fused_mlp": fused_mlp._mlp_lib,
            "color_jitter": color_jitter._lib}
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
    return torch.device("cuda", 0)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from multimodal_isic_tpu_torch.data.augment import preprocess_eval_batch
    from multimodal_isic_tpu_torch.ops import fused_dwconv as fd
    from multimodal_isic_tpu_torch.train.fusion import (evaluate_test,
                                                        make_fusion_eval_step)
    from multimodal_isic_tpu_torch.utils.profiling import timeit_closed

    t_start = time.perf_counter()
    device = prepare()

    # 3. fused kernels vs plain at every serving geometry, bs 16 and 128
    worst_err = check_kernels(device)
    for name, err in check_kernels(device, LARGE_BATCH).items():
        worst_err[name] = max(worst_err[name], err)

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

    # 5. the warp and colour jitter kernels
    worst_err["affine_warp_batch"] = check_warp(device)
    worst_err["color_jitter_batch"] = check_jitter(device)

    # 6. the training slice end to end
    train_launches, train_ds = train_slice(device, reqs)
    launches.update(train_launches)

    # 7. learning evidence on a fixed batch
    learning_evidence(device, train_ds)

    # 8. times
    warp_times = time_training(device, train_ds)
    jitter_times = time_jitter(device)
    totals = time_kernels(device)
    time_kernels(device, LARGE_BATCH)  # printed; the kernels line keeps bs 16
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
        for name, m in (("kernel", kernel_m), ("plain", plain_m)):
            profile_steps(lambda: serve(m), f"serve bs{bsz} bf16 {name} path")
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
    check_radiomics_capture(device, *_rad_chunk_levels(
        device, rgb[:RAD_CHUNK], masks[:RAD_CHUNK], ("original",))["original"])
    launches.update(radiomics_path(device, rgb, masks))
    rad_times = time_radiomics(device, rgb, masks)
    print(f"wall {time.perf_counter() - t_start:.1f} s")

    # 10. ConvMAE: kernels vs plain, latent extraction, the validation
    # forward, times
    fo_chunk = (rgb[:RAD_CHUNK].copy(), masks[:RAD_CHUNK].copy())
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
    del mae_ds
    torch.cuda.empty_cache()

    # 12. first-order accumulation and the bare MLP: their entry points,
    # kernels vs plain, times
    t12 = time.perf_counter()
    fo_inputs = firstorder_inputs(device, *fo_chunk)
    fo_launches, fo_worst = firstorder_and_mlp(device, fo_inputs)
    launches.update(fo_launches)
    worst_err.update(fo_worst)
    fo_times = time_firstorder_and_mlp(device, fo_inputs)
    print(f"phase 12 (first order, bare MLP) {time.perf_counter() - t12:.1f} "
          f"s; wall {time.perf_counter() - t_start:.1f} s")
    del fo_inputs
    torch.cuda.empty_cache()

    # 13. the fusion CLI from files on disk: prepare_df → main (device
    # cache, fast policy, folded test pass), the restored checkpoint, a
    # streaming epoch, remat, entry()
    t13 = time.perf_counter()
    cli = cli_slice(device)
    print(f"phase 13 (fusion CLI) {time.perf_counter() - t13:.1f} s: decoder "
          f"{cli['decoder']} {_spread(cli['decode_img_s'])}; "
          f"device-resident epoch {_spread(cli['resident_img_s'])}; "
          f"streaming epoch {_spread(cli['stream_img_s'])}; test pass "
          f"{_spread(cli['test_img_s'])}; CLI peak {cli['peak_gib']:.2f} "
          f"GiB; wall {time.perf_counter() - t_start:.1f} s")

    # 14. the radiomics and MAE chains from phase 13's files on disk through
    # their CLIs: extract_radiomics → reduce_dim → main, train_ae →
    # save_latent
    t14 = time.perf_counter()
    rad_cli = radiomics_chain(device, cli["root"], cli["config"])
    mae_cli = mae_chain(device, cli["root"], cli["config"])
    print(f"phase 14 (radiomics and MAE CLIs) {time.perf_counter() - t14:.1f}"
          f" s: decoder {rad_cli['decoder']}; extraction from disk "
          f"{_spread(rad_cli['extract_img_s'])}; reduce_dim "
          f"{rad_cli['reduce_s']:.1f} s; save_latent "
          f"{_spread(mae_cli['latent_img_s'])}; wall "
          f"{time.perf_counter() - t_start:.1f} s")

    # 15. MIL cross-validation on phase 14's latents through cli.use_latent:
    # single-frame mode (mil, graph-mil), the checkpoint sweep (B9 in the
    # re-extraction), the card against the CPU, times
    t15 = time.perf_counter()
    mil = mil_chain(device, cli["root"], cli["config"], mae_cli)
    print(f"phase 15 (MIL CLIs) {time.perf_counter() - t15:.1f} s: "
          f"single-frame mil {mil['walls']['mil']:.1f} s, graph-mil "
          f"{mil['walls']['graph-mil']:.1f} s; sweep "
          f"{mil['sweep']['wall']:.1f} s ({mil['sweep']['b9']} B9 launches, "
          f"{mil['sweep']['forwards']} forwards); per-bag step "
          + ", ".join(f"{k} {v['step_ms']:.2f} ms ({v['launches']:.0f} "
                      f"launches, busy {v['busy']:.3f})"
                      for k, v in mil["times"].items())
          + f"; wall {time.perf_counter() - t_start:.1f} s")

    # 16. the MIL search through cli.tune_mil (packed and sequential, mil
    # and graph-mil), a cohort member against the sequential trial, the
    # graph space's large end, the cohort step at P 1-8, ASHA's pruning and
    # packed against sequential at equal wall clock
    t16 = time.perf_counter()
    hpo = hpo_chain(device, cli["root"], cli["config"], mil["times"])
    print(f"phase 16 (MIL search) {time.perf_counter() - t16:.1f} s: "
          + ", ".join(f"tune_mil {k} {v:.1f} s"
                      for k, v in hpo["walls"].items())
          + "; cohort step P 8 "
          + ", ".join(f"{k} {hpo['steps'][(k, 8)]['step_ms']:.2f} ms"
                      for k in ("mil", "graph-mil"))
          + f"; wall {time.perf_counter() - t_start:.1f} s")

    # 17. latent clustering: cli.cluster_latents on phase 14's latents (three
    # backbones) and cli.fetch_experiments over the runs of phases 13-16,
    # the card against the CPU, the reference's ~2M-row scale
    t17 = time.perf_counter()
    clu = cluster_chain(device, cli["root"], cli["config"])
    print(f"phase 17 (latent clustering) {time.perf_counter() - t17:.1f} s: "
          + ", ".join(f"cluster_latents {k} {v['wall']:.1f} s"
                      for k, v in clu["runs"].items())
          + f"; 2M rows: approx kNN {clu['ref']['knn_s']:.1f} s (recall@15 "
          f"{clu['ref']['recall']:.4f}), HDBSCAN "
          f"{clu['ref']['hdbscan_s']:.1f} s, k-means "
          f"{clu['ref']['kmeans_s']:.1f} s, layout "
          f"{clu['ref']['layout_s']:.1f} s; wall "
          f"{time.perf_counter() - t_start:.1f} s")

    # 18. the parallel layer in 2 processes on the card: the data- and
    # tensor-parallel programs against one process, then cli.main,
    # cli.train_ae, cli.extract_radiomics and cli.tune_mil under ISIC_*
    import pandas as pd
    t18 = time.perf_counter()
    d = cli["config"]["dir"]
    par = parallel_chain(
        device, cli["root"], cli["config"],
        (pd.read_pickle(d["radiomics"]), pd.read_pickle(d["radiomics_test"])),
        cli["root"] / "dataframes_latents" / "patch_level_latents_train_df.pkl")
    print(f"phase 18 (2 processes) {time.perf_counter() - t18:.1f} s: "
          f"programs group {par['programs_wall']:.1f} s, CLIs group "
          f"{par['clis_wall']:.1f} s; launches in phase 18 (rank 0) "
          f"{par['launches']}; wall {time.perf_counter() - t_start:.1f} s")

    med, bound, b_bytes, b_ops = warp_times[BATCH]
    totals["affine_warp_batch"] = [med["kernel"], med["plain"], bound, b_bytes,
                                   b_ops]
    library = {"affine_warp_batch": med["grid_sample"]}
    med, bound, b_bytes, b_ops = jitter_times[BATCH]
    totals["color_jitter_batch"] = [med["kernel"], med["plain"], bound,
                                    b_bytes, b_ops]
    for name, (ker, pln, bnd, bb, bo, lib) in (*rad_times.items(),
                                               *mae_times.items(),
                                               *fo_times.items()):
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
                     "affine_warp_batch", "color_jitter_batch")
        + RAD_KERNELS + MAE_KERNELS
        + ("fused_ln_mlp_backward", "firstorder_accumulate", "fused_mlp")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
