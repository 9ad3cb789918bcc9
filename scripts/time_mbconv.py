#!/usr/bin/env python3
"""Time the fused MBConv serving kernels of one checkout on one CUDA card.

    python3 scripts/time_mbconv.py [ROOT] [--no-profile]

ROOT (default: this checkout) is the root of a checkout of the repository;
its ``chip_smoke.py`` and ``multimodal_isic_tpu_torch`` are imported, so two
commits are compared by running this script once from each (in turns: parent,
change, change, parent) in one call on the card.  It prints:

- the card's name and power limit;
- ``expand_dw_silu_pool`` and ``dw_silu_pool`` against their plain versions
  at every geometry of the B3@380 serving forward, at bs 16 and bs 128 in
  bf16 (CUDA events around eager calls, ``chip_smoke.time_kernels``), and a
  JSON line of the per-forward totals;
- each kernel's device time at those geometries and batches (CUDA-graph
  replays of 20 calls, which leave out the host's launch cost) and its
  per-forward totals;
- the host time of one eager call of each wrapper (host clock around a chain
  of calls that the device does not hold back);
- unless ``--no-profile``, ``chip_smoke.profile_steps`` of one serving
  forward (preprocess + folded net) at bs 16 and bs 128 on the kernel path
  and on the plain path.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path


def host_ms_per_call(fn, calls=200, repeats=7):
    """Host milliseconds a call, median and best of ``repeats`` chains of
    ``calls`` eager calls on the host clock, each after a synchronize and
    closed before the device catches up (so the enqueue, not the device, is
    timed)."""
    import torch
    for _ in range(10):
        fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2], times[0]


def graph_ms(replay, calls, repeats=5):
    """Median device milliseconds a call of ``repeats`` replays of a graph
    of ``calls`` calls, timed with CUDA events."""
    import torch
    replay()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[repeats // 2]


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = Path(args[0] if args else Path(__file__).resolve().parents[1])
    root = root.resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("time_mbconv: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from multimodal_isic_tpu_torch.data.augment import preprocess_eval_batch
    from multimodal_isic_tpu_torch.ops import fused_dwconv as fd
    assert Path(fd.__file__).resolve().is_relative_to(root), fd.__file__
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(f"{root}: {smi.stdout.strip()}")
    t0 = time.perf_counter()
    fd._lib()
    print(f"build {time.perf_counter() - t0:.1f} s")

    totals = {}
    for bsz in (cs.BATCH, cs.LARGE_BATCH):
        totals[bsz] = cs.time_kernels(device, bsz)
    print("mbconv totals a forward, [kernel, plain, bound, bytes, ops] ms: "
          + json.dumps({str(k): v for k, v in totals.items()}))

    g = torch.Generator(device=device).manual_seed(cs.SEED)
    with torch.inference_mode():
        for bsz in (cs.BATCH, cs.LARGE_BATCH):
            dev = {"dw_silu_pool": 0.0, "expand_dw_silu_pool": 0.0}
            geos = cs.serving_geometries()
            for geo in dict.fromkeys(geos):
                fn = fd.dw_silu_pool if geo[0] == "dw" else fd.expand_dw_silu_pool
                a = cs._kernel_inputs(*geo[:1], bsz, *geo[1:], torch.bfloat16,
                                      device, g)
                ms = graph_ms(cs._graphed(lambda: fn(*a), 20), 20)
                dev[fn.__name__] += ms * geos.count(geo)
                print(f"device time {geo} bs{bsz} bf16: {ms:.4f} ms a call "
                      "(CUDA-graph replays)")
            print(f"device time a serving forward bs{bsz} bf16, ms: "
                  + json.dumps(dev))
        for geo, fn in ((("expand", 12, 232, 1392, 5), fd.expand_dw_silu_pool),
                        (("dw", 190, 24, 24, 3), fd.dw_silu_pool)):
            a = cs._kernel_inputs(*geo[:1], 1, *geo[1:], torch.bfloat16,
                                  device, g)
            med, best = host_ms_per_call(lambda: fn(*a))
            print(f"host time a call, {fn.__name__} {geo} bs1 bf16: median "
                  f"{med:.4f} ms, best {best:.4f} ms")

    if "--no-profile" in sys.argv:
        return 0
    reqs = cs.to_device_batch(cs.make_requests(cs.N_REQUESTS), device)
    kernel_m, plain_m, _ = cs.build_models(device)
    for bsz in (cs.BATCH, cs.LARGE_BATCH):
        reps = -(-bsz // cs.N_REQUESTS)
        batch = {k: torch.cat([v] * reps)[:bsz] for k, v in reqs.items()}
        inputs = {k: batch[k] for k in ("radiomics", "age", "sex", "loc",
                                        "artifacts")}
        for name, m in (("kernel", kernel_m), ("plain", plain_m)):
            def serve(m=m):
                with torch.inference_mode():
                    img = preprocess_eval_batch(batch["image"], (cs.IMG, cs.IMG),
                                                dtype=torch.bfloat16)
                    return m(image=img, **inputs)
            cs.profile_steps(serve, f"serve bs{bsz} bf16 {name} path")
    return 0


if __name__ == "__main__":
    sys.exit(main())
