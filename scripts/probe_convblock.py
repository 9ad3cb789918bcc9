#!/usr/bin/env python3
"""Phase probes of ConvMAE's conv-stage kernels on one CUDA card.

    python3 scripts/probe_convblock.py [VARIANT,VARIANT,...]

Builds variants of ``csrc/fused_ln_mlp.cu`` (B9) and ``csrc/fused_front.cu``
(B12), a phase switched off by a patch of the source text, with the same nvcc
flags as the package, each into ``build/kernels/probe/``, and times both
kernels at the latent path's geometries (bs 128 bf16) and the validation
forward's (bs 16 float32, B12 with ``keep``) as CUDA-graph replays (the
device's time), each variant twice, in the order given and then reversed.
A variant's results are wrong by design: it measures where the time goes,
not what is computed.  Variants:

- ``base``: the kernels as they are;
- ``nogelu``: B9's epilogue of the first product without its GELU;
- ``nop1`` / ``nop2``: B9 without the first / second product's products;
- ``nocopy``: neither kernel copies its weight tiles (the ring keeps stale
  data; the waits and barriers stay);
- ``noln``: neither kernel loads and normalises its rows (zeros instead);
- ``notaps``: B12 without its depthwise taps (the g tile keeps y);
- ``nogemm``: B12 without the products of its two GEMMs.

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

MLP, FRONT = "fused_ln_mlp", "fused_front"
PATCH = {
    "base": [],
    "nogelu": [(MLP, "const float v0 = gelu(round_to<T>(h[0][j][hf * 2] + b1k[col]));",
                "const float v0 = round_to<T>(h[0][j][hf * 2] + b1k[col]);"),
               (MLP, "const float v1 = gelu(round_to<T>(h[0][j][hf * 2 + 1] + b1k[col + 1]));",
                "const float v1 = round_to<T>(h[0][j][hf * 2 + 1] + b1k[col + 1]);"),
               (MLP, "af[i * L::LDA + col] = gelu(hv[q] + b1k[col]);",
                "af[i * L::LDA + col] = hv[q] + b1k[col];")],
    "nop1": [(MLP, "      warp_gemm_bf16<1, NT1, C>(h, ya,", "      if (false) warp_gemm_bf16<1, NT1, C>(h, ya,"),
             (MLP, "      thread_gemm_f32<RW, TN1, C, 1, 8, 16>(",
              "      if (false) thread_gemm_f32<RW, TN1, C, 1, 8, 16>(")],
    "nop2": [(MLP, "      warp_gemm_bf16<2, NT2, FC>(acc,", "      if (false) warp_gemm_bf16<2, NT2, FC>(acc,"),
             (MLP, "      thread_gemm_f32<RW, TN2, FC, 1, 32>(acc,",
              "      if (false) thread_gemm_f32<RW, TN2, FC, 1, 32>(acc,")],
    "nocopy": [(MLP, "    if (k < nch) {\n      copy_tile", "    if (false) {\n      copy_tile"),
               (FRONT, "      copy_tile<T, C, KC, L::NTH>(slot(issued),",
                "      if (false) copy_tile<T, C, KC, L::NTH>(slot(issued),")],
    "noln": [(MLP, "const T* src[1] = {r0 + r < M ? x + size_t(r0 + r) * C : nullptr};",
              "const T* src[1] = {nullptr};"),
             (FRONT, "      src[j] = unsigned(r) < unsigned(H) && p < L::MP && row_px(p)",
              "      src[j] = false")],
    "notaps": [(FRONT, "      for (int it = tid; it < NP * nruns; it += L::NTH) {",
                "      for (int it = tid; it < 0; it += L::NTH) {")],
    "nogemm": [(FRONT, "      for (int kt = 0; kt < NK; ++kt) gemm(take(), kt);",
                "      for (int kt = 0; kt < NK; ++kt) take();"),
               (FRONT, "    for (int kt = 0; kt < NK; ++kt) gemm(take(), kt);",
                "    for (int kt = 0; kt < NK; ++kt) take();")],
}
GEOS = (("fused_ln_mlp", "bf16", (128, 56, 256)), ("fused_ln_mlp", "bf16", (128, 28, 384)),
        ("fused_ln_mlp", "f32", (16, 56, 256)), ("fused_ln_mlp", "f32", (16, 28, 384)),
        ("fused_front", "bf16", (128, 56, 256, False)),
        ("fused_front", "bf16", (128, 28, 384, False)),
        ("fused_front", "f32", (16, 56, 256, True)),
        ("fused_front", "f32", (16, 28, 384, True)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_convblock: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from multimodal_isic_tpu_torch.ops import _build
    from multimodal_isic_tpu_torch.ops import fused_convblock as fcb
    from multimodal_isic_tpu_torch.ops import fused_mlp as fm
    from time_convblock import graph_ms

    variants = sys.argv[1].split(",") if len(sys.argv) > 1 else list(PATCH)
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    sources = {}
    for v in variants:
        for name in (MLP, FRONT):
            s = (_build.CSRC / f"{name}.cu").read_text()
            for target, a, b in PATCH[v]:
                if target != name:
                    continue
                if a not in s:
                    raise SystemExit(f"probe {v}: its patch no longer matches "
                                     f"{name}.cu: {a[:60]!r}")
                s = s.replace(a, b)
            sources[v, name] = s
    procs = {}
    for (v, name), s in sources.items():
        src = out / f"{v}-{name}.cu"
        src.write_text(s)
        procs[v, name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out / f"{v}-{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {k: proc.communicate()[0] for k, proc in procs.items()}
    for (v, name), proc in procs.items():
        if proc.returncode != 0:
            raise SystemExit(f"probe {v}: nvcc failed for {name}\n"
                             f"{logs[v, name]}")
    libs = {k: ctypes.CDLL(str(out / f"{k[0]}-{k[1]}.so")) for k in procs}

    def use(v):
        load = _build.load
        for mod in (fm, fcb):
            mod._build.load = lambda name: libs[v, name]
            mod._lib.cache_clear()
            mod._lib()
        _build.load = load

    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(cs.SEED)
    mods = {MLP: fm, FRONT: fcb}
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    args = [(name, dt, geo, cs._mae_inputs(name, geo, dts[dt], device, g))
            for name, dt, geo in GEOS]
    with torch.inference_mode():
        for order in (variants, variants[::-1]):
            for v in order:
                use(v)
                row = []
                for name, dt, geo, a in args:
                    fn = getattr(mods[name], name)
                    ms = graph_ms(cs, lambda: fn(*a), 10)
                    row.append(f"{'B9' if name == MLP else 'B12'} {dt} "
                               f"{geo[1]}²·{geo[2]} {ms:.4f}")
                print(f"{v:8s}", "; ".join(row), flush=True)
    use("base")
    return 0


if __name__ == "__main__":
    sys.exit(main())
