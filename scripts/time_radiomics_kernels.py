#!/usr/bin/env python3
"""Time the radiomics chunk's GLCM counts (B4), connected components (B7)
and GLRLM run bookkeeping (B5) kernels of one checkout on one CUDA card.

    python3 scripts/time_radiomics_kernels.py [ROOT] [--kernels-only]

ROOT (default: this checkout) is the root of a checkout of the repository;
its ``chip_smoke.py`` and ``multimodal_isic_tpu_torch`` are imported, so two
commits are compared by running this script once from each (in turns:
parent, change, change, parent) in one call on the card.  On one chunk of 16
rendered 450×600 lesions (``chip_smoke.radiomics_samples``) it prints:

- the card's name and power limit;
- for each derived image of ``chip_smoke.RAD_CHECK_TYPES`` (original, LoG
  σ 3, wavelet-HH; M = 64 maps of 450×600 each) and each kernel: whether it
  equals its plain version bit for bit, its eager time (CUDA events around
  20 calls, median of 5 chains), its plain version's time, its library
  call's time where one PyTorch call computes the same function (B4:
  ``torch.bincount`` over the packed keys of the counted pairs, the keys
  built inside the timed call), its bound (``chip_smoke.rad_bound_ms``)
  and the device time of each of its launches (``torch.profiler``, the
  mean over 3 traced calls);
- unless ``--kernels-only``: radiomics extraction img/s of one chunk on the
  kernel and plain paths (median of 3), peak device memory, and one profiled
  chunk on each path: busy share, launches, and the device time and launches
  of each of the four radiomics kernels a chunk;
- a JSON line with the per-type kernel times, for the records.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

# the radiomics kernels' device launches, by the names of both designs
KERNEL_RE = {"connected_components": r"cc_\w+", "glrlm_runs": r"runs_\w+",
             "glcm_matrices": r"glcm\w*", "joint_histogram": r"joint_hist\w*"}


def _events(fn, traces=1):
    """CUDA events of ``traces`` traced calls of ``fn`` (after one call); a
    trace with no device activity at all lost the call (the profiler
    sometimes records nothing) and is taken again, up to 5 times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    out = []
    for _ in range(traces):
        for _ in range(5):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            if ev:
                break
        out.append(ev)
    return out


def launch_ms(fn, pattern, traces=3):
    """Device ms of each launch of ``fn`` whose kernel name matches
    ``pattern``, in launch order, the mean over ``traces`` traced calls."""
    per = []
    for ev in _events(fn, traces):
        per.append([(re.search(pattern, e.name).group(0),
                     e.time_range.elapsed_us() / 1e3)
                    for e in sorted(ev, key=lambda e: e.time_range.start)
                    if re.search(pattern, e.name)])
    n = min(len(p) for p in per)
    return [(per[0][i][0], sum(p[i][1] for p in per) / len(per))
            for i in range(n)]


def glcm_bincount(levels, inside):
    """The GLCM counts as one library call, ``torch.bincount`` over the
    packed (map, angle, centre, neighbour) keys of the counted pairs; the
    yardstick of B4, used nowhere in the port."""
    import torch
    from multimodal_isic_tpu_torch.ops.texture import ANGLES_2D, NG, shift2d
    m = levels.shape[0]
    lv = torch.where(inside, levels, 0)
    base = (torch.arange(m, device=levels.device) * 4 * NG * NG).view(m, 1, 1)
    keys = []
    for a, (dy, dx) in enumerate(ANGLES_2D):
        nbr = shift2d(lv, -dy, -dx, 0)
        ok = (lv > 0) & (nbr > 0)
        keys.append((base + (a * NG + lv - 1) * NG + nbr - 1)[ok])
    p = torch.bincount(torch.cat(keys), minlength=m * 4 * NG * NG)
    p = p.view(m, 4, NG, NG)
    return (p + p.transpose(-1, -2)).float()


def chunk_kernels(fn):
    """Device ms and launches of each radiomics kernel in one traced call."""
    ev = _events(fn)[0]
    out = {}
    for name, pat in KERNEL_RE.items():
        hits = [e for e in ev if re.search(pat, e.name)]
        out[name] = (sum(e.time_range.elapsed_us() for e in hits) / 1e3,
                     len(hits))
    return out, sum(e.time_range.elapsed_us() for e in ev) / 1e3, len(ev)


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = Path(args[0] if args else Path(__file__).resolve().parents[1])
    root = root.resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_radiomics_kernels: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from multimodal_isic_tpu_torch.analysis.radiomics import RadiomicsExtractor
    from multimodal_isic_tpu_torch.ops import connected_components as C
    from multimodal_isic_tpu_torch.ops import glcm as G
    from multimodal_isic_tpu_torch.ops import glrlm_runs as R
    from multimodal_isic_tpu_torch.utils.profiling import timeit_closed
    assert Path(C.__file__).resolve().is_relative_to(root), C.__file__
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(f"{root}: {smi.stdout.strip()}")
    t0 = time.perf_counter()
    C._lib()
    R._lib()
    G._lib()
    print(f"build {time.perf_counter() - t0:.1f} s")

    rgb, masks = cs.radiomics_samples(cs.RAD_CHUNK)
    cases = cs._rad_chunk_levels(device, rgb, masks)
    fns = {"glcm_matrices": (G.glcm_matrices, G.glcm_matrices_reference),
           "connected_components": (C.connected_components,
                                    C.connected_components_reference),
           "glrlm_runs": (R.glrlm_runs, R.glrlm_runs_reference)}
    record = {}
    for label, (levels, m4) in cases.items():
        inside = m4 > 0
        m, h, w = levels.shape
        for name, (kern, ref) in fns.items():
            a = (levels, m4) if name == "glcm_matrices" else (levels, inside)
            same = torch.equal(kern(*a), ref(*a))
            kt = timeit_closed(lambda: kern(*a), iters=20,
                               repeats=5)["median"] * 1e3
            pt = timeit_closed(lambda: ref(*a), iters=3,
                               repeats=3)["median"] * 1e3
            lt = None
            if name == "glcm_matrices":
                lt = timeit_closed(lambda: glcm_bincount(levels, inside),
                                   iters=3, repeats=3)["median"] * 1e3
            b_bytes, b_ops = cs.rad_bound_ms(name, m, h, w)
            bound = max(b_bytes, b_ops)
            launches = launch_ms(lambda: kern(*a), KERNEL_RE[name])
            record.setdefault(name, {})[label] = {
                "ms": kt, "plain_ms": pt, "library_ms": lt, "bound_ms": bound,
                "launches": launches}
            lib = "" if lt is None else f", library {lt:.4f} ms"
            print(f"{name} on {label} M{m} {h}x{w}: equal to plain {same}; "
                  f"kernel {kt:.4f} ms, plain {pt:.4f} ms{lib}, bound "
                  f"{bound:.4f} ms ({bound / kt:.1%} of it); device ms a "
                  "launch: " + ", ".join(f"{k} {v:.4f}" for k, v in launches))
            if not same:
                raise AssertionError(f"{name} != plain on {label}")

    if "--kernels-only" not in sys.argv:
        chunk = (rgb, masks)
        exs = {"kernel": RadiomicsExtractor(device=device),
               "plain": RadiomicsExtractor(use_kernels=False, device=device)}
        for which in ("kernel", "plain"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t = timeit_closed(lambda: exs[which]._extract(*chunk), iters=1,
                              repeats=3)
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"radiomics extraction, {which} path, a chunk of "
                  f"{len(rgb)}: {len(rgb) / t['median']:.2f} img/s (median "
                  f"of 3, best {len(rgb) / t['best']:.2f}); "
                  f"{t['median']:.3f} s a chunk; peak device memory "
                  f"{peak:.2f} GiB")
            cs.profile_steps(lambda: exs[which]._extract(*chunk),
                             f"radiomics chunk of {len(rgb)}, {which} path",
                             steps=1)
            per, dev, n = chunk_kernels(lambda: exs[which]._extract(*chunk))
            print(f"radiomics kernels of a chunk, {which} path (device ms, "
                  f"launches; all kernels {dev:.2f} ms in {n} launches): "
                  + ", ".join(f"{k} {v[0]:.3f} ms / {v[1]}"
                              for k, v in per.items()))
    print("radiomics kernel times: " + json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
