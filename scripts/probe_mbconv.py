#!/usr/bin/env python3
"""Phase probes of the fused MBConv kernels on one CUDA card.

    python3 scripts/probe_mbconv.py [VARIANT,VARIANT,...]

Builds variants of ``csrc/fused_dwconv.cu`` (a phase switched off, or a
constant changed, by a patch of the source text) with the same nvcc flags as
the package, each into ``build/kernels/probe/``, and times every distinct
geometry of the B3@380 serving forward at bs 16 and bs 128 in bf16 as
CUDA-graph replays (the device's time), each variant twice, in the order
given and then reversed.  A variant's results are wrong by design: it
measures where the time goes, not what is computed.  Variants:

- ``base``: the kernels as they are (its SASS goes to ``base.sass``);
- ``nodw``: no depthwise phase (no y, no pool sums);
- ``noAload``: the expand's x tiles are not loaded (the ring keeps stale data);
- ``nogemm``: no expand products (the mma.sync instructions skipped);
- ``noepisilu``: the bf16 expand epilogue without its silu;
- ``directpool``: every block writes its pool sums directly, no partials;
- ``nrcp``: silu's reciprocal by Newton steps on the FMA pipe, not rcp.approx;
- ``stages4``: a 4-deep k-slice ring (the plan follows);
- ``depth2``: the dw ring 2 rows ahead, not 3 (the plan follows);
- ``cc64``: the expand plan with 64-channel blocks everywhere;
- ``tall``: 64-channel expand blocks take the tallest tile that fits the
  whole shared memory (one block an SM).

A patch that no longer matches the source fails the run: update it with the
source.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

NRCP = """__device__ __forceinline__ float silu(float v) {
  const float d = fminf(1.0f + __expf(-v), 1e30f);
  float r = __int_as_float(0x7EF311C3 - __float_as_int(d));
  r = r * fmaf(-d, r, 2.0f);
  r = r * fmaf(-d, r, 2.0f);
  r = r * fmaf(-d, r, 2.0f);
  return v * r;
}
__device__ __forceinline__ float silu_unused(float v) {
  float r;"""
EPI = ("                           silu(acc[mt][nt][2 * h] + be_r[nt][0]),\n"
       "                           silu(acc[mt][nt][2 * h + 1] + be_r[nt][1]));")
PATCH = {
    "base": [],
    "nodw": [("  if (on) {\n    for (int it = slot;",
              "  if (false) {\n    for (int it = slot;"),
             ("    if (on) {\n      const T* rowp[K];",
              "    if (false) {\n      const T* rowp[K];")],
    "noAload": [("      cp_async16(dst + r * AS + k - k0,",
                 "      if (false) cp_async16(dst + r * AS + k - k0,")],
    "nogemm": [("for (int nt = 0; nt < 4; ++nt) mma_16816(",
                "for (int nt = 0; nt < 4 && false; ++nt) mma_16816(")],
    "noepisilu": [(EPI, EPI.replace("silu(", "("))],
    "directpool": [("  if (a.n_tiles == 1) {", "  if (true) {")],
    "nrcp": [("__device__ __forceinline__ float silu(float v) {\n  float r;",
              NRCP)],
    "stages4": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    "depth2": [("constexpr int DEPTH = 3;", "constexpr int DEPTH = 2;")],
    "cc64": [],
    "tall": [],
}
GEOS = [("dw", 190, 40, 40, 3), ("dw", 190, 24, 24, 3),
        ("expand", 95, 32, 192, 3), ("expand", 48, 48, 288, 5),
        ("expand", 24, 96, 576, 3), ("expand", 24, 136, 816, 5),
        ("expand", 12, 232, 1392, 5), ("expand", 12, 384, 2304, 3)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_mbconv: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from multimodal_isic_tpu_torch.ops import _build
    from multimodal_isic_tpu_torch.ops import fused_dwconv as fd
    from time_mbconv import graph_ms

    variants = sys.argv[1].split(",") if len(sys.argv) > 1 else list(PATCH)
    default = {k: getattr(fd, k) for k in ("_STAGES", "_DEPTH", "mbconv_plan")}

    @functools.cache
    def plan_cc64(b, h, w, cin, cmid, k, dtype, expand=True):
        if not expand:
            return default["mbconv_plan"](b, h, w, cin, cmid, k, dtype, expand)
        return fd._expand_plan(h, w, cin, cmid, k,
                               torch.finfo(dtype).bits // 8, 64)

    @functools.cache
    def plan_tall(b, h, w, cin, cmid, k, dtype, expand=True):
        plan = default["mbconv_plan"](b, h, w, cin, cmid, k, dtype, expand)
        if not expand or plan["cc"] != 64:
            return plan
        esz = torch.finfo(dtype).bits // 8

        def size(t):
            return fd.expand_smem_bytes(t, w, k, cin, esz, 64)
        rows = max(t for t in range(1, h + 1) if size(t) <= fd.MAX_SMEM)
        return fd._finish_plan(h, cmid, 64, rows, size)

    python_side = {"stages4": {"_STAGES": 4}, "depth2": {"_DEPTH": 2},
                   "cc64": {"mbconv_plan": plan_cc64},
                   "tall": {"mbconv_plan": plan_tall}}

    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "fused_dwconv.cu").read_text()
    procs = {}
    for v in variants:
        s = src
        for a, b in PATCH[v]:
            if a not in s:
                raise SystemExit(f"probe {v}: its patch no longer matches "
                                 f"the source: {a[:60]!r}")
            s = s.replace(a, b)
        (out / f"{v}.cu").write_text(s)
        procs[v] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{v}.so"),
             str(out / f"{v}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for v, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"probe {v}: nvcc failed\n{log}")
        libs[v] = ctypes.CDLL(str(out / f"{v}.so"))
    if "base" in libs:
        sass = subprocess.run(
            [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
             str(out / "base.so")], capture_output=True, text=True).stdout
        (out / "base.sass").write_text(sass)

    def use(v):
        for k, val in {**default, **python_side.get(v, {})}.items():
            setattr(fd, k, val)
        default["mbconv_plan"].cache_clear()
        load = _build.load
        fd._build.load = lambda name: libs[v]
        fd._lib.cache_clear()
        fd._entry.cache_clear()
        fd._lib()
        fd._build.load = load

    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(cs.SEED)
    args = {(geo, b): cs._kernel_inputs(geo[0], b, *geo[1:], torch.bfloat16,
                                        device, g)
            for geo in GEOS for b in (cs.BATCH, cs.LARGE_BATCH)}
    with torch.inference_mode():
        for order in (variants, variants[::-1]):
            for v in order:
                use(v)
                row = []
                for (geo, b), a in args.items():
                    fn = (fd.dw_silu_pool if geo[0] == "dw"
                          else fd.expand_dw_silu_pool)
                    ms = graph_ms(cs._graphed(lambda: fn(*a), 20), 20)
                    row.append(f"{geo[1]}²·{geo[2]}→{geo[3]} k{geo[4]} "
                               f"bs{b} {ms:.4f}")
                print(f"{v:10s}", "; ".join(row), flush=True)
    for k, val in default.items():
        setattr(fd, k, val)
    return 0


if __name__ == "__main__":
    sys.exit(main())
