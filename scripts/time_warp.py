#!/usr/bin/env python3
"""Time the ShiftScaleRotate warp kernel (B3) of one checkout on one CUDA
card, at the fusion train step's shapes.

    python3 scripts/time_warp.py [ROOT]

ROOT (default: this checkout) is the root of a checkout of the repository;
its ``chip_smoke.py`` and ``multimodal_isic_tpu_torch`` are imported, so two
commits are compared by running this script once from each (in turns:
parent, change, change, parent) in one call on the card.  At bs 16 (the
float32 train step) and bs 128 (the bf16 step; the warp stays float32), on
380² × 3 float32 images on the 0..255 scale warped by the fast policy's
draws (every image drawn), it prints:

- the card's name and power limit;
- the kernel's eager time (CUDA events around 20 calls, the best of the
  medians of two runs of 5 chains), its plain version's and
  ``F.grid_sample``'s (the library call; used nowhere in the port), in the
  order plain, grid_sample, kernel, kernel, grid_sample, plain;
- its bound (``chip_smoke.warp_bound_ms``) and the share of it;
- the device time of its launch (``torch.profiler``, the mean over 3
  traced calls);
- the largest difference to the plain version and to grid_sample, and
  whether a rerun gives the same bits;
- a JSON line with these numbers, for the records.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

SIZE = 380


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = Path(args[0] if args else Path(__file__).resolve().parents[1])
    root = root.resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("time_warp: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from multimodal_isic_tpu_torch.data.augment import ssr_draw, ssr_inverse
    from multimodal_isic_tpu_torch.ops import affine_warp as aw
    from multimodal_isic_tpu_torch.utils.profiling import timeit_closed
    from time_radiomics_kernels import launch_ms
    assert Path(aw.__file__).resolve().is_relative_to(root), aw.__file__
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(f"{root}: {smi.stdout.strip()}")
    aw._lib()

    record = {}
    hw = (SIZE, SIZE)
    for bsz in (cs.BATCH, cs.LARGE_BATCH):
        g = torch.Generator(device=device).manual_seed(cs.SEED + 5)
        imgs = torch.rand(bsz, SIZE, SIZE, 3, generator=g, device=device) * 255
        d = ssr_draw(g, bsz, p=1.0)
        inv = ssr_inverse(SIZE, SIZE, d["dx"], d["dy"], d["scale"], d["angle"])
        fns = {"kernel": lambda: aw.affine_warp_batch(imgs, inv, hw),
               "plain": lambda: aw.affine_warp_batch_reference(imgs, inv, hw),
               "grid_sample": lambda: aw.affine_warp_grid_sample(imgs, inv, hw)}
        out = fns["kernel"]()
        same = torch.equal(out, fns["kernel"]())
        e_ref = float((out - fns["plain"]()).abs().max())
        e_lib = float((out - fns["grid_sample"]()).abs().max())
        t = {k: [] for k in fns}
        for name in ("plain", "grid_sample", "kernel", "kernel", "grid_sample",
                     "plain"):
            t[name].append(timeit_closed(fns[name], iters=20, repeats=5))
        med = {k: min(r["median"] for r in v) * 1e3 for k, v in t.items()}
        b_bytes, b_ops = cs.warp_bound_ms(bsz, SIZE, SIZE, 3, hw)
        bound = max(b_bytes, b_ops)
        dev = launch_ms(fns["kernel"], r"affine_warp\w*")
        record[bsz] = {"ms": med["kernel"], "plain_ms": med["plain"],
                       "library_ms": med["grid_sample"], "bound_ms": bound,
                       "launches": dev, "max_abs_err": e_ref,
                       "grid_sample_err": e_lib, "rerun_same_bits": same}
        print(f"warp bs{bsz} {SIZE}² C3 f32: kernel {med['kernel']:.4f} ms, "
              f"plain {med['plain']:.4f} ms, grid_sample "
              f"{med['grid_sample']:.4f} ms; bound {bound:.4f} ms (bytes "
              f"{b_bytes:.4f}, operations {b_ops:.4f}): "
              f"{bound / med['kernel']:.1%} of it; device ms a launch: "
              + ", ".join(f"{k} {v:.4f}" for k, v in dev)
              + f"; max_abs_err vs plain {e_ref:.3e}, vs grid_sample "
              f"{e_lib:.3e}; rerun {'same bits' if same else 'DIFFERENT BITS'}")
        if e_ref > cs.WARP_ATOL or e_lib > cs.GRID_SAMPLE_ATOL or not same:
            raise AssertionError(f"warp bs{bsz} out of tolerance or unstable")
    print("warp times: " + json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
