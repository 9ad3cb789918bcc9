#!/usr/bin/env python3
"""Phase probes of first-order accumulation (B8) and the bare fused MLP (B13)
on one CUDA card.

    python3 scripts/probe_fo_mlp.py [VARIANT,VARIANT,...]

Builds variants of ``csrc/firstorder.cu`` and ``csrc/fused_mlp.cu``, a phase
switched off by a patch of the source text, with the same nvcc flags as the
package, each into ``build/kernels/probe/``, and times them through the
entry points (``histogram.firstorder_accumulate`` on 64 maps of 450×600,
the radiomics chunk's call, ~60% of the pixels valid; ``fused_mlp.fused_mlp``
at ConvViT-Base's two conv stages, bs 128 bf16) as CUDA-graph replays (the
device's time), each variant twice, in the order given and then reversed.
A variant's results are wrong by design: it measures where the time goes,
not what is computed.  Variants:

- ``base``: the kernels as they are;
- ``loadonly``: B8's walk loads both arrays and adds x of the valid pixels,
  nothing else (no compaction, no histogram, no stores to shared memory);
- ``nop1b8``: B8 without phase 1's float64 loop;
- ``nohist``: B8 without its histogram atomics;
- ``nogelu``: B13 bf16 packs h + b1 without its rounding and GELU;
- ``p1only``: B13 bf16 without the GELU and without the second product;
- ``p2only``: B13 bf16 without the GELU and without the first product.

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

FO, MLP = "firstorder", "fused_mlp"
GELU = ("""gelu(round_to<__nv_bfloat16>(h[4 * j + 2 * hf] + bias.x)),
                gelu(round_to<__nv_bfloat16>(h[4 * j + 2 * hf + 1] + bias.y)));""",
        """h[4 * j + 2 * hf] + bias.x, h[4 * j + 2 * hf + 1] + bias.y);""")
P1 = ("mma_ss<FC>(h, kmajor_sw128(", "if (kk < 0) mma_ss<FC>(h, kmajor_sw128(")
P2 = ("for (int kk = 0; kk < FC / 16; ++kk) {\n          const int sd",
      "for (int kk = 0; kk < 0; ++kk) {\n          const int sd")
PATCH = {
    "base": [],
    "loadonly": [(FO, """    const bool ok = has && l > 0;
    const unsigned m = __ballot_sync(FULL, ok);
    if (ok) {""", """    const bool ok = has && l > 0;
    const unsigned m = 0u;
    if (ok) sx += v;
    if (false) {""")],
    "nop1b8": [(FO, "  for (int i = lane; i < cnt; i += 32) {",
                "  for (int i = lane; i < 0; i += 32) {")],
    "nohist": [(FO, "      if (l <= NG) atomicAdd(&h[l - 1], 1);\n", "")],
    "nogelu": [(MLP, *GELU)],
    "p1only": [(MLP, *GELU), (MLP, *P2)],
    "p2only": [(MLP, *GELU), (MLP, *P1)],
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_fo_mlp: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from multimodal_isic_tpu_torch.ops import _build
    from multimodal_isic_tpu_torch.ops import fused_mlp as fm
    from multimodal_isic_tpu_torch.ops import histogram as hm
    from time_convblock import graph_ms

    variants = sys.argv[1].split(",") if len(sys.argv) > 1 else list(PATCH)
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs, logs = {}, {}
    for v in variants:
        for name in (FO, MLP):
            s = (_build.CSRC / f"{name}.cu").read_text()
            for target, a, b in PATCH[v]:
                if target != name:
                    continue
                if a not in s:
                    raise SystemExit(f"probe {v}: its patch no longer matches "
                                     f"{name}.cu: {a[:60]!r}")
                s = s.replace(a, b)
            src = out / f"{v}-{name}.cu"
            src.write_text(s)
            procs[v, name] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                 "-o", str(out / f"{v}-{name}.so"), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for k, proc in procs.items():
        logs[k] = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"probe {k[0]}: nvcc failed for {k[1]}\n{logs[k]}")
    libs = {k: ctypes.CDLL(str(out / f"{k[0]}-{k[1]}.so")) for k in procs}

    def use(v):
        load = _build.load
        for name, getter in ((FO, hm._fo_lib), (MLP, fm._mlp_lib)):
            _build.load = lambda _n, lib=libs[v, name]: lib
            getter.cache_clear()
            getter()
        _build.load = load

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(cs.SEED)
    x = torch.randn(64, 450 * 600, generator=g, device=device) * 40 + 90
    lv = torch.randint(-3, 200, x.shape, generator=g, device=device,
                       dtype=torch.int32)
    lv = torch.where(torch.rand(x.shape, generator=g, device=device) < 0.6,
                     lv, 0)
    mlp = [(geo, cs._mlp_args(geo, device, g))
           for geo in cs.mlp_geometries()[2:4]]
    with torch.inference_mode():
        for order in (variants, variants[::-1]):
            for v in order:
                use(v)
                row = [f"B8 64x450x600 "
                       f"{graph_ms(cs, lambda: hm.firstorder_accumulate(x, lv), 10):.4f}"]
                for geo, a in mlp:
                    ms = graph_ms(cs, lambda: fm.fused_mlp(*a), 5)
                    row.append(f"B13 bf16 C {geo[2]} {ms:.4f}")
                print(f"{v:9s}", "; ".join(row), flush=True)
    use("base")
    return 0


if __name__ == "__main__":
    sys.exit(main())
