#!/usr/bin/env python3
"""Phase probes of the GLCM counts (B4) and ShiftScaleRotate warp (B3)
kernels on one CUDA card.

    python3 scripts/probe_glcm_warp.py [VARIANT,VARIANT,...]

Builds variants of ``csrc/glcm.cu`` and ``csrc/affine_warp.cu`` (a phase
switched off by a patch of the source text) with the same nvcc flags as the
package, each into ``build/kernels/probe/``, and prints the device time of
each launch (``torch.profiler``, the mean over 3 traced calls): B4 on a
radiomics chunk's derived images (M = 64 maps of 450×600:
``chip_smoke.RAD_CHECK_TYPES``), B3 at bs 16 and bs 128 (380² × 3, the
policy's draws), each variant twice, in the order given and then reversed.
A variant's results are wrong by design: it measures where the time goes,
not what is computed.  Variants:

- ``base``: the kernels as they are;
- ``noring``: B4 loads its rows cell by cell when it needs them (its path
  for unaligned maps), not through its rings of cp.async row slots;
- ``nocollide``: B4 adds every pair to a word of its lane's own (bank and
  word distinct across the warp): no collisions;
- ``nocount``: B4 loads and walks its maps but counts nothing;
- ``noflush``: B4 neither sums the cluster's histograms nor writes its
  output (its cluster barriers stay);
- ``ahead2``: B4 fetches rows two rows ahead, not three;
- ``notaps``: B3 loads no taps (each output is its weights' sum):
  coordinates and stores only;
- ``nostores``: B3 writes nothing to device memory (the row buffers are
  filled as before).

The base variant also prints how many clusters of B4 the card keeps
resident at once (``cudaOccupancyMaxActiveClusters``).

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

GLCM, WARP = "glcm.cu", "affine_warp.cu"
PATCH = {
    "base": [],
    "noring": [(GLCM, "const bool vec = w % 4 == 0 &&",
                "const bool vec = false && w % 4 == 0 &&")],
    "nocollide": [(GLCM, "atomicAdd(hist + (bin >> 1), 1u << ((bin & 1u) << 4));",
                   "atomicAdd(hist + (((bin >> 6) << 5) | (threadIdx.x & 31)), "
                   "1u);")],
    "nocount": [(GLCM, "if (__any_sync(FULL, c != 0u)) {",
                 "if (__any_sync(FULL, c == ~0u)) {")],
    "noflush": [
        (GLCM, "    if (threadIdx.x < SLICE / 8) {",
         "    if (threadIdx.x < 0) {"),
        (GLCM, "q < OUT_SLICE / 4; q += THREADS", "q < 0; q += THREADS")],
    "ahead2": [(GLCM, "        fetch_row<VEC>(ring + (y % RING) * SLOT, lv, mk, y + RING,",
                "        fetch_row<VEC>(ring + ((y + RING - 1) % RING) * SLOT, lv, "
                "mk, y + RING - 1,"),
               (GLCM, "    for (int k = 0; k < RING; ++k)",
                "    for (int k = 0; k < RING - 1; ++k)"),
               (GLCM, "cp.async.wait_group 3;", "cp.async.wait_group 2;")],
    "notaps": [(WARP, "  return __fmaf_rn(t11, w11,",
                "  return w00 + w01 + w10 + w11;\n  return __fmaf_rn(t11, w11,")],
    "nostores": [(WARP, "  store_row(out, g, buf, n_px * c, lane);",
                  "  if (n_px < 0) store_row(out, g, buf, n_px * c, lane);")],
}
# appended to every variant's glcm.cu: the resident clusters of the kernel
OCCUPANCY = """
extern "C" int glcm_probe_clusters(int* clusters) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, 64);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, glcm_cluster_kernel<true>, &cfg));
}
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_glcm_warp: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from multimodal_isic_tpu_torch.data.augment import ssr_draw, ssr_inverse
    from multimodal_isic_tpu_torch.ops import _build
    from multimodal_isic_tpu_torch.ops import affine_warp as AW
    from multimodal_isic_tpu_torch.ops import glcm as G
    from time_radiomics_kernels import KERNEL_RE, launch_ms

    variants = sys.argv[1].split(",") if len(sys.argv) > 1 else list(PATCH)
    out = _build.BUILD_DIR / "probe"
    procs = {}
    for v in variants:
        d = out / v
        d.mkdir(parents=True, exist_ok=True)
        srcs = {n: (_build.CSRC / n).read_text() for n in (GLCM, WARP)}
        for f, a, b in PATCH[v]:
            if a not in srcs[f]:
                raise SystemExit(f"probe {v}: its patch no longer matches "
                                 f"{f}: {a[:60]!r}")
            srcs[f] = srcs[f].replace(a, b)
        srcs[GLCM] += OCCUPANCY
        for n, s in srcs.items():
            (d / n).write_text(s)
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
        for mod, n in ((G, GLCM), (AW, WARP)):
            mod._build.load = lambda name, n=n: libs[v, n]
            mod._lib.cache_clear()
            mod._lib()
        _build.load = load

    device = torch.device("cuda", 0)
    rgb, masks = cs.radiomics_samples(cs.RAD_CHUNK)
    cases = cs._rad_chunk_levels(device, rgb, masks)
    g = torch.Generator(device=device).manual_seed(cs.SEED + 5)
    warps = {}
    for bsz in (cs.BATCH, cs.LARGE_BATCH):
        imgs = torch.rand(bsz, 380, 380, 3, generator=g, device=device) * 255
        d = ssr_draw(g, bsz, p=1.0)
        warps[bsz] = (imgs, ssr_inverse(380, 380, d["dx"], d["dy"],
                                        d["scale"], d["angle"]))
    n = ctypes.c_int(0)
    rc = libs[variants[0], GLCM].glcm_probe_clusters(ctypes.byref(n))
    print(f"glcm: {n.value} clusters of {G.CLUSTER} blocks resident at once "
          f"(rc {rc}; a chunk has {len(cases['original'][0])})")
    for order in (variants, variants[::-1]):
        for v in order:
            use(v)
            row = []
            for label, (levels, m4) in cases.items():
                ms = launch_ms(lambda: G.glcm_matrices(levels, m4),
                               KERNEL_RE["glcm_matrices"])
                row.append(f"glcm {label[:8]} " + " ".join(
                    f"{t:.4f}" for _, t in ms))
            for bsz, (imgs, inv) in warps.items():
                ms = launch_ms(lambda: AW.affine_warp_batch(imgs, inv,
                                                            (380, 380)),
                               r"affine_warp\w*")
                row.append(f"warp bs{bsz} " + " ".join(
                    f"{t:.4f}" for _, t in ms))
            print(f"{v:9s}", "; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
