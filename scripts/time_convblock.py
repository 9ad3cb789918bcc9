#!/usr/bin/env python3
"""Time ConvMAE's conv-stage kernels of one checkout on one CUDA card.

    python3 scripts/time_convblock.py [ROOT] [--kernels-only]

ROOT (default: this checkout) is the root of a checkout of the repository;
its ``chip_smoke.py`` and ``multimodal_isic_tpu_torch`` are imported, so two
commits are compared by running this script once from each (in turns: parent,
change, change, parent) in one call on the card.  It prints:

- the card's name and power limit;
- ``fused_ln_mlp`` (B9) and ``fused_front`` (B12) at the geometries of the
  latent path (bs 128 bf16, no ``keep``) and of the validation forward (bs 16
  float32, B12 with ``keep``): eager calls (CUDA events around chains of
  calls), device time (CUDA-graph replays), the bound of
  ``chip_smoke.mae_bound_ms``, and, as a yardstick only, the two products
  alone as ``torch.matmul`` in the kernel's dtype (B9: y·w1 and a·w2; B12:
  the two 1×1s), eager and as graph replays; then a JSON line of the
  per-forward totals (two calls at each geometry);
- unless ``--kernels-only``, end to end, each with its time (CUDA events),
  img/s and ``chip_smoke.profile_steps`` (device time, busy share,
  families): the encoder at bs 128 bf16 on the kernel path and on the flash
  + front path, the validation forward at bs 16 float32 with every kernel,
  and the MAE train step at bs 16 float32 and bs 64 bf16 on the kernel path.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

GEOMETRIES = (("fused_ln_mlp", "bf16", (128, 56, 256)),
              ("fused_ln_mlp", "bf16", (128, 28, 384)),
              ("fused_ln_mlp", "f32", (16, 56, 256)),
              ("fused_ln_mlp", "f32", (16, 28, 384)),
              ("fused_front", "bf16", (128, 56, 256, False)),
              ("fused_front", "bf16", (128, 28, 384, False)),
              ("fused_front", "f32", (16, 56, 256, True)),
              ("fused_front", "f32", (16, 28, 384, True)))


def events_ms(fn, calls=10, repeats=5):
    """Median milliseconds a call over ``repeats`` chains of ``calls`` calls
    of ``fn``, timed with CUDA events after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[repeats // 2]


def graph_ms(cs, fn, calls=10, repeats=5):
    """Device milliseconds a call: ``calls`` calls captured in one CUDA graph
    (``chip_smoke._graphed``), replays timed with CUDA events."""
    return events_ms(cs._graphed(fn, calls), 1, repeats) / calls


def products(name, dtype, geo, device, g):
    """The kernel's two products alone as ``torch.matmul`` on random
    operands of the call's shapes in ``dtype``: the yardstick."""
    import torch
    b, hw, c = geo[:3]
    m, f = b * hw * hw, (4 * c if name == "fused_ln_mlp" else c)
    rn = lambda *s: torch.randn(*s, generator=g, device=device).to(dtype)
    y, w1, a, w2 = rn(m, c), rn(c, f), rn(m, f), rn(f, c)
    return lambda: (torch.matmul(y, w1), torch.matmul(a, w2))


def time_kernels(cs, device):
    import torch
    from multimodal_isic_tpu_torch.ops import fused_convblock, fused_mlp
    mods = {"fused_ln_mlp": fused_mlp, "fused_front": fused_convblock}
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    g = torch.Generator(device=device).manual_seed(cs.SEED + 25)
    totals = {}
    for name, dt, geo in GEOMETRIES:
        dtype = dts[dt]
        args = cs._mae_inputs(name, geo, dtype, device, g)
        kern = getattr(mods[name], name)
        fn = lambda: kern(*args)
        ms = events_ms(fn)
        dev = graph_ms(cs, fn)
        mm = products(name, dtype, geo, device, g)
        mm_ms, mm_dev = events_ms(mm), graph_ms(cs, mm)
        bound = max(cs.mae_bound_ms(name, dtype, geo))
        print(f"time {name} {geo} {dt}: kernel {ms:.4f} ms eager, "
              f"{dev:.4f} ms device (graph replays); bound {bound:.4f} ms "
              f"({bound / ms:.1%} eager, {bound / dev:.1%} device); the two "
              f"products alone (torch.matmul, yardstick) {mm_ms:.4f} ms "
              f"eager, {mm_dev:.4f} ms device")
        key = f"{name} {dt}"
        tot = totals.setdefault(key, [0.0] * 5)
        for i, v in enumerate((ms, dev, bound, mm_ms, mm_dev)):
            tot[i] += 2 * v
        del args
    print("per forward [kernel eager, kernel device, bound, products eager, "
          "products device] ms: " + json.dumps(totals))


def time_end_to_end(cs, device):
    import torch
    from multimodal_isic_tpu_torch.core.rng import generator
    from multimodal_isic_tpu_torch.data.augment import mae_eval_batch
    from multimodal_isic_tpu_torch.train import mae as M
    crops, masks, _ = cs.mae_samples(128)
    imgs = torch.from_numpy(crops).to(device)
    msks = torch.from_numpy(masks).to(device)
    enc_img, _ = mae_eval_batch(imgs, msks)

    def report(label, fn, bsz, iters=5):
        ms = events_ms(fn, iters, 3)
        print(f"{label}: {ms:.2f} ms, {bsz / ms * 1e3:.1f} img/s (CUDA "
              f"events, median of 3 chains of {iters})")
        cs.profile_steps(fn, label, steps=3)

    variants = {k: cs.LAT_VARIANTS[k] for k in ("kernel", "flash+front")}
    models = cs.mae_models(device, cs.SEED + 22, with_decoder=False,
                           dtype=torch.bfloat16, variants=variants)
    for name, m in models.items():
        step = M.make_encoder_step(m)
        report(f"encoder bs128 bf16 ({name} path)", lambda: step(enc_img),
               128)
    del models

    models = cs.mae_models(device, cs.SEED + 23, norm_pix_loss=True,
                           variants={"kernel": cs.ALL_FLAGS})
    val_img = enc_img[:16].float()
    draws = models["kernel"].masking(16, cs.MASK_RATIO,
                                     generator(cs.SEED + 24, device))
    step = M.make_mae_eval_step(models["kernel"], cs.MASK_RATIO)
    report("MAE validation forward bs16 f32 (all kernels)",
           lambda: step(val_img, masking=draws), 16)
    del models

    pol = generator(cs.SEED + 41, device)
    for bsz, dtype in ((16, torch.float32), (64, torch.bfloat16)):
        img = enc_img[:bsz]
        m = cs.mae_models(device, cs.SEED + 42, norm_pix_loss=True,
                          dtype=dtype,
                          variants={"kernel": dict(use_fused_mlp=True)}
                          )["kernel"]
        step = M.make_mae_train_step(m.train(), M.mae_optimizer(m),
                                     cs.MASK_RATIO)
        report(f"MAE train step bs{bsz} {str(dtype)[6:]} (kernel path)",
               lambda: step(img, generator=pol), bsz, iters=3)
        del m, step
        torch.cuda.empty_cache()


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = Path(args[0] if args else Path(__file__).resolve().parents[1])
    root = root.resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("time_convblock: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from multimodal_isic_tpu_torch.ops import fused_convblock, fused_mlp
    for mod in (cs, fused_mlp):
        assert Path(mod.__file__).resolve().is_relative_to(root), mod.__file__
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(f"{root}: {smi.stdout.strip()}")
    t0 = time.perf_counter()
    fused_mlp._lib()
    fused_convblock._lib()
    print(f"build {time.perf_counter() - t0:.1f} s")
    with torch.inference_mode():
        time_kernels(cs, device)
    if "--kernels-only" not in sys.argv:
        time_end_to_end(cs, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
