#!/usr/bin/env python3
"""Time the colour jitter kernel (``ops/color_jitter.py``) of one checkout
on one CUDA card, at the fusion train step's shapes.

    python3 scripts/time_jitter.py [ROOT]

ROOT (default: this checkout) is the root of a checkout of the repository;
its ``multimodal_isic_tpu_torch`` is imported.  At bs 64 (the benchmark's
train cell) and bs 16 (the CLI's train step), on 380² × 3 float32 images on
the 0..255 scale and the fast policy's jitter draws (``color_jitter_draw``:
each image drawn with p 0.5, its own order), it prints:

- the card's name and power limit;
- the kernel's eager time (CUDA events around 20 calls, the best of the
  medians of two runs of 5 chains) and its plain version's, in the order
  plain, kernel, kernel, plain; the input is the same tensor every call, so
  what of it the last call left in L2 is warm;
- its bound: the batch read once and written once at 3.35 TB/s, and the
  share of it;
- the device time of its launch (``torch.profiler``, the mean over 3
  traced calls);
- the largest difference to the plain version, whether the images not
  drawn came through bit for bit and whether a rerun gives the same bits;
- a JSON line with these numbers, for the records.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

SIZE = 380
HBM_BPS = 3.35e12   # H100 SXM, NVIDIA's data sheet
ATOL = 1e-3         # tests/test_torch_cuda_kernels.py::JITTER_ATOL


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = Path(args[0] if args else Path(__file__).resolve().parents[1])
    root = root.resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("time_jitter: no CUDA device", file=sys.stderr)
        return 1
    from multimodal_isic_tpu_torch.data.augment import color_jitter_draw
    from multimodal_isic_tpu_torch.ops import color_jitter as cj
    from multimodal_isic_tpu_torch.utils.profiling import timeit_closed
    from time_radiomics_kernels import launch_ms
    assert Path(cj.__file__).resolve().is_relative_to(root), cj.__file__
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(f"{root}: {smi.stdout.strip()}")
    cj._lib()

    record = {}
    for bsz in (64, 16):
        g = torch.Generator(device=device).manual_seed(22 + bsz)
        imgs = torch.rand(bsz, SIZE, SIZE, 3, generator=g, device=device) * 255
        d = color_jitter_draw(g, bsz)
        fns = {"kernel": lambda: cj.color_jitter_batch(
                   imgs, d["apply"], d["brightness"], d["contrast"],
                   d["saturation"], d["hue"], d["perm"]),
               "plain": lambda: cj.color_jitter_reference(imgs, d)}
        out = fns["kernel"]()
        same = torch.equal(out, fns["kernel"]())
        kept = torch.equal(out[~d["apply"]], imgs[~d["apply"]])
        err = float((out - fns["plain"]()).abs().max())
        t = {k: [] for k in fns}
        for name in ("plain", "kernel", "kernel", "plain"):
            t[name].append(timeit_closed(fns[name], iters=20, repeats=5))
        med = {k: min(r["median"] for r in v) * 1e3 for k, v in t.items()}
        nbytes = 2 * imgs.numel() * 4
        bound = nbytes / HBM_BPS * 1e3
        dev = launch_ms(fns["kernel"], r"color_jitter\w*")
        drawn = int(d["apply"].sum())
        record[bsz] = {"ms": med["kernel"], "plain_ms": med["plain"],
                       "bound_ms": bound, "share": bound / med["kernel"],
                       "launches": dev, "drawn": drawn, "max_abs_err": err,
                       "not_drawn_same_bits": kept, "rerun_same_bits": same}
        print(f"jitter bs{bsz} {SIZE}² f32 ({drawn} drawn): kernel "
              f"{med['kernel']:.4f} ms, plain {med['plain']:.4f} ms; bound "
              f"{bound:.4f} ms (bytes, {nbytes / 1e6:.1f} MB): "
              f"{bound / med['kernel']:.1%} of it; device ms a launch: "
              + ", ".join(f"{k} {v:.4f}" for k, v in dev)
              + f"; max_abs_err vs plain {err:.3e}; not drawn "
              f"{'same bits' if kept else 'CHANGED'}; rerun "
              f"{'same bits' if same else 'DIFFERENT BITS'}")
        if err > ATOL or not same or not kept:
            raise AssertionError(f"jitter bs{bsz} out of tolerance or unstable")
    print("jitter times: " + json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
