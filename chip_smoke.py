#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving slice on one CUDA card.

    python3 chip_smoke.py

Drives ``multimodal_isic_tpu_torch`` end to end at the full EfficientNet-B3
width with random weights from a seed:

1. prints the card's name and power limit (nvidia-smi);
2. builds the fused MBConv kernels (``csrc/fused_dwconv.cu``) with nvcc;
3. holds each kernel against its plain PyTorch version at every geometry the
   B3@380 serving forward gives it, in bf16 and float32;
4. serves 64 in-memory requests (rendered 450×600 samples, centroid-cropped
   to 450²) in batches of 16 through preprocess → BN-folded fusion net on the
   fused-kernel path → ``make_fusion_eval_step`` → ``evaluate_test``; checks
   the kernel launch counts, that the logits are finite and that they agree
   with the plain folded path and with the unfolded standard-BN model;
5. times each kernel against its plain version, and preprocess + folded
   forward on the kernel path against the plain path, with CUDA events.

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

import numpy as np
import torch

SEED = 0
N_REQUESTS = 64
BATCH = 16                # the serving batch of the CLI's test pass
LARGE_BATCH = 128
SRC_HW = (450, 600)
IMG = 380
RADIOMICS_DIM = 780
SOURCE = "multimodal_isic_tpu_torch/csrc/fused_dwconv.cu"
REPLACES = {"dw_silu_pool": "multimodal_isic_tpu/ops/fused_dwconv.py:272",
            "expand_dw_silu_pool": "multimodal_isic_tpu/ops/fused_dwconv.py:326"}

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
    nets with the same seeded weights, backbone in ``dtype``."""
    from multimodal_isic_tpu_torch.models.fusion import (MultiModalFusionNet,
                                                         fold_fusion_params)
    kw = dict(backbone=name, radiomics_dim=radiomics_dim, dtype=dtype)
    standard = MultiModalFusionNet(backbone=name, radiomics_dim=radiomics_dim)
    seeded_init_(standard, seed)
    std_sd = standard.state_dict()  # float32: fold before rounding to dtype
    folded_sd = fold_fusion_params(std_sd, backbone=name)
    standard.image_model.to(dtype)
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


def time_kernels(device, bsz=BATCH, dtype=torch.bfloat16):
    """Per-geometry kernel vs plain time (ms) at the serving batch, and the
    per-forward totals over the blocks that use each geometry."""
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
        per_geo[geo] = (ker, pln)
        print(f"time {kind:6s} {h}²·{cin}→{cmid} k{k} bs{bsz} "
              f"{str(dtype)[6:]}: kernel {ker:.4f} ms, plain {pln:.4f} ms "
              f"({pln / ker:.2f}x)")
    totals = {"dw_silu_pool": [0.0, 0.0], "expand_dw_silu_pool": [0.0, 0.0]}
    for geo in geos:
        name = "dw_silu_pool" if geo[0] == "dw" else "expand_dw_silu_pool"
        totals[name][0] += per_geo[geo][0]
        totals[name][1] += per_geo[geo][1]
    return totals


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
    from multimodal_isic_tpu_torch.ops import fused_dwconv as fd
    from multimodal_isic_tpu_torch.train.fusion import (evaluate_test,
                                                        make_fusion_eval_step)
    from multimodal_isic_tpu_torch.utils.profiling import timeit_closed

    # plain f32 versions in full f32, as the kernels compute
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
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    fd._lib()
    lib = _build.library_path("fused_dwconv")
    print(f"build: {lib.relative_to(lib.parents[2])} "
          f"in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "bytes stack" in line or "Compiling" in line:
            print("  ptxas:", line.strip())

    # 3. kernel vs plain at every slice geometry
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

    # 5. times
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

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": worst_err[name], "ms": totals[name][0],
         "plain_ms": totals[name][1]}
        for name in ("expand_dw_silu_pool", "dw_silu_pool")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
