"""LayerNorm → 1×1 C→F → GELU → 1×1 F→C → residual, in one kernel.

Counterpart of ``multimodal_isic_tpu/ops/fused_mlp.py::fused_ln_mlp``
(forward, :162-213): the second half of ConvMAE's ``ConvBlock`` over rows
``x [M, C]``.  The public function keeps the JAX layouts: ``w1 [C, F]``,
``w2 [F, C]`` (the model passes views of its ``[out, in, 1, 1]`` conv
weights, which the kernel reads in place when they already are in the
compute dtype).

Rounding points, those of the TPU kernel (and, in the plain version, made
explicitly): LayerNorm with float32 fast-variance statistics
(``E[x²] − mean²`` clipped at 0, eps 1e-6), rounded to x.dtype; ``y·w1``
accumulated in float32 plus ``b1``, rounded; exact-erf GELU in float32,
rounded; ``a·w2`` in float32 plus ``b2``, rounded; the residual added in
x.dtype.  The biases and the LayerNorm scale and shift are read as float32
values (the model hands over ``b1``/``b2`` already rounded to its dtype, as
the JAX model does).

- On a CUDA tensor :func:`fused_ln_mlp` launches the hand-written kernel of
  ``csrc/fused_ln_mlp.cu`` (built with nvcc at first use), or raises.
- On a CPU tensor it runs :func:`fused_ln_mlp_reference`.

The backward (``fused_mlp.py:312``) comes with ConvMAE training.  Launches
are counted in ``fused_ln_mlp.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
CHANNELS = (256, 384)  # C the kernel is built for: ConvViT-Base's conv stages
F_STEP = 32                 # F must be a multiple of the kernel's chunk
# Kernel vs plain version, |err| <= atol + rtol·|plain|, (atol, rtol):
# float32 is the same arithmetic in another summation order; bf16 may flip
# one rounding of an intermediate or of the output (2^-8 relative of O(1)
# values).  The fused front (``fused_convblock``) is held to the same.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


def ln_rows(xf: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """flax ``nn.LayerNorm`` over the last dim in float32: fast variance
    ``E[x²] − mean²`` clipped at 0, ``(x − mean)·(rsqrt(var + eps)·scale) +
    shift`` (``fused_mlp.py:151-159``)."""
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (xf - mean) * (torch.rsqrt(var + eps) * scale) + shift


def gelu_f32(h: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU taken in float32, rounded back to h.dtype."""
    return F.gelu(h.float(), approximate="none").to(h.dtype)


def fused_ln_mlp_reference(x, ls, lb, w1, b1, w2, b2, eps: float = 1e-6):
    """Plain version of :func:`fused_ln_mlp`, with the kernel's rounding
    points (matmuls on float32 copies of the x.dtype operands: products of
    bf16 values are exact in float32)."""
    dt = x.dtype
    y = ln_rows(x.float(), ls.float(), lb.float(), eps).to(dt)
    h = (y.float() @ w1.to(dt).float() + b1.float()).to(dt)
    a = gelu_f32(h)
    out = (a.float() @ w2.to(dt).float() + b2.float()).to(dt)
    return x + out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_ln_mlp")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fused_ln_mlp_{sfx}")
        fn.argtypes = [vp] * 8 + [i32] * 3 + [ctypes.c_float, vp]
        fn.restype = i32
    lib.fused_ln_mlp_error_string.argtypes = [i32]
    lib.fused_ln_mlp_error_string.restype = ctypes.c_char_p
    return lib


def fused_ln_mlp(x: torch.Tensor, ls: torch.Tensor, lb: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x + mlp(layernorm(x))``: x [M, C] (float32 or bfloat16), ls/lb [C],
    w1 [C, F], b1 [F], w2 [F, C], b2 [C] → [M, C] in x.dtype.  The [M, F]
    intermediate exists only inside the kernel."""
    if x.dim() != 2:
        raise ValueError(f"x must be [M, C], got shape {tuple(x.shape)}")
    m, c = x.shape
    f = w1.shape[-1]
    if tuple(w1.shape) != (c, f) or tuple(w2.shape) != (f, c):
        raise ValueError(f"w1 must be [{c}, F] and w2 [F, {c}], got "
                         f"{tuple(w1.shape)} and {tuple(w2.shape)}")
    for name, t, n in (("ls", ls, c), ("lb", lb, c), ("b1", b1, f),
                       ("b2", b2, c)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be [{n}], got {tuple(t.shape)}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return fused_ln_mlp_reference(x, ls, lb, w1, b1, w2, b2, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_mlp: tensors must be on the CPU or a "
                         f"CUDA device, got {x.device}")
    if c not in CHANNELS or f % F_STEP:
        raise ValueError(f"fused_ln_mlp: the kernel takes C in {CHANNELS} and "
                         f"F a multiple of {F_STEP}, got C={c}, F={f}")
    x = x.contiguous()
    # [F, C] and [C, F]: each output's weights contiguous (the conv
    # parameters themselves when the model passes their transposed views)
    w1k = w1.t().to(x.dtype).contiguous()
    w2k = w2.t().to(x.dtype).contiguous()
    vecs = [t.float().contiguous() for t in (ls, lb, b1, b2)]
    for t in (w1k, w2k, *vecs):
        if t.device != x.device:
            raise ValueError(f"fused_ln_mlp: all tensors must be on {x.device}")
    out = torch.empty_like(x)
    if m == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"fused_ln_mlp_{_SUFFIX[x.dtype]}")(
            x.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
            w1k.data_ptr(), vecs[2].data_ptr(), w2k.data_ptr(),
            vecs[3].data_ptr(), out.data_ptr(), m, c, f, eps, stream)
    if rc != 0:
        raise RuntimeError("fused_ln_mlp launch failed: "
                           f"{lib.fused_ln_mlp_error_string(rc).decode()}")
    fused_ln_mlp.launches += 1
    return out


fused_ln_mlp.launches = 0
