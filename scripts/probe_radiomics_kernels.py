#!/usr/bin/env python3
"""Phase probes of the connected components (B7) and GLRLM run bookkeeping
(B5) kernels on one CUDA card.

    python3 scripts/probe_radiomics_kernels.py [VARIANT,VARIANT,...]

Builds variants of ``csrc/connected_components.cu`` and ``csrc/
glrlm_runs.cu`` (a phase switched off by a patch of the source text) with
the same nvcc flags as the package, each into ``build/kernels/probe/``, and
prints the device time of each launch of both kernels (``torch.profiler``,
the mean over 3 traced calls) on a radiomics chunk's derived images (M = 64
maps of 450×600: ``chip_smoke.RAD_CHECK_TYPES``), each variant twice, in
the order given and then reversed.  A variant's results are wrong by
design: it measures where the time goes, not what is computed.  Variants:

- ``base``: the kernels as they are;
- ``nolinks``: B7's tile kernel makes no links to the row above;
- ``nounite``: B7's tile kernel queues its links but makes none;
- ``noroot``: B7's tile kernel writes each pixel's run start, not its root;
- ``noborder``: B7's border kernel returns at once;
- ``noload``: B5's kernel copies no input to shared memory (the shared
  copy is stale; B7's tile kernel cannot run so: a stale copy sends its
  unions off the map);
- ``nocarry``: B5's band kernel resolves no run that leaves its band (no
  reads of the bands below, no waits);
- ``nomasks``: B5's band kernel builds no run-end masks;
- ``nowords``: B5's band kernel writes no words (and so computes none).

A patch that no longer matches the source fails the run: update it with the
source.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

CC, RUNS, STAGE = "connected_components.cu", "glrlm_runs.cu", "map_stage.cuh"
PATCH = {
    "base": [],
    "nolinks": [(CC, "    if (r == 0) continue;\n", "    continue;\n")],
    "noroot": [(CC, "const int root = find(sp, p);",
                "const int root = sp.load(p);")],
    "nounite": [(CC, "      unite(sp, static_cast<int>(q[i] >> 12), "
                 "static_cast<int>(q[i] & 0xfffu));",
                 "      slv[0] = q[i];")],
    "noborder": [(CC, "  int t = blockIdx.x * BORDER_THREADS + threadIdx.x;",
                  "  if (h > 0) return;\n"
                  "  int t = blockIdx.x * BORDER_THREADS + threadIdx.x;")],
    "noload": [(RUNS, "slv, sin, y0 - 1, rows + 2,", "slv, sin, y0 - 1, 0,")],
    "nocarry": [(RUNS, "if (b + 1 < n_bands && xt >= 0 && xt < w && "
                 "sin[rows * wp + xb] != 0 &&",
                 "if (b < 0 && xt >= 0 && xt < w && sin[rows * wp + xb] != 0 &&")],
    "nomasks": [(RUNS, "masks[a * ml + i] = r0 < rows ? line_ends(slv, sin, "
                 "wp, w, 1, r0, x, dx, rows) : 0u;",
                 "masks[a * ml + i] = 1u + r0;")],
    "nowords": [(RUNS, "      if (x < w) {\n        const size_t g",
                 "      if (x < w && r < 0) {\n        const size_t g")],
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_radiomics_kernels: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from multimodal_isic_tpu_torch.ops import _build
    from multimodal_isic_tpu_torch.ops import connected_components as C
    from multimodal_isic_tpu_torch.ops import glrlm_runs as R
    from time_radiomics_kernels import KERNEL_RE, launch_ms

    variants = sys.argv[1].split(",") if len(sys.argv) > 1 else list(PATCH)
    out = _build.BUILD_DIR / "probe"
    procs = {}
    for v in variants:
        d = out / v
        d.mkdir(parents=True, exist_ok=True)
        srcs = {n: (_build.CSRC / n).read_text() for n in (CC, RUNS, STAGE)}
        for f, a, b in PATCH[v]:
            if a not in srcs[f]:
                raise SystemExit(f"probe {v}: its patch no longer matches "
                                 f"{f}: {a[:60]!r}")
            srcs[f] = srcs[f].replace(a, b)
        for n, s in srcs.items():
            (d / n).write_text(s)
        for n in (CC, RUNS):
            procs[v, n] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                 str(d / n.replace(".cu", ".so")), str(d / n)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (v, n), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"probe {v}: nvcc failed for {n}\n{log}")
        libs[v, n] = ctypes.CDLL(str(out / v / n.replace(".cu", ".so")))

    def use(v):
        load = _build.load
        for mod, n in ((C, CC), (R, RUNS)):
            mod._build.load = lambda name, n=n: libs[v, n]
            mod._lib.cache_clear()
            mod._lib()
        C._build.load = load

    device = torch.device("cuda", 0)
    rgb, masks = cs.radiomics_samples(cs.RAD_CHUNK)
    cases = cs._rad_chunk_levels(device, rgb, masks)
    for order in (variants, variants[::-1]):
        for v in order:
            use(v)
            row = []
            for label, (levels, m4) in cases.items():
                inside = m4 > 0
                for name, fn in (("connected_components", C.connected_components),
                                 ("glrlm_runs", R.glrlm_runs)):
                    ms = launch_ms(lambda: fn(levels, inside), KERNEL_RE[name])
                    row.append(f"{label[:8]} " + " ".join(
                        f"{k} {t:.4f}" for k, t in ms))
            print(f"{v:9s}", "; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
