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

The backward is the counterpart of the TPU kernel's (``fused_mlp.py:239-347``):
:func:`fused_ln_mlp_backward` launches ``csrc/fused_ln_mlp_bwd.cu`` on the
card and runs :func:`fused_ln_mlp_backward_reference` on the CPU.  Both
recompute the forward from x; neither is autograd through the plain forward.
The public :func:`fused_ln_mlp` goes through a ``torch.autograd.Function``
that pairs the two, so a result on the card stays on the autograd graph.
Launches are counted in ``fused_ln_mlp.launches`` and
``fused_ln_mlp_backward.launches``.
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
# Backward kernel vs its plain version.  dx elementwise under ``"dx"``
# (atol, rtol), as the forward: the same arithmetic in another order, and in
# bf16 a flipped rounding of dh or of dx_ln.  The parameter gradients are
# sums over all M rows in another order (row blocks, then a fixed-order sum
# of the blocks' partials), so they are held by the relative Frobenius error
# ||kernel - plain|| / ||plain||: float32 a few ulps of accumulated
# rounding; bf16 a fraction of a bf16 ulp (2^-8) where dh flips.
BWD_TOL = {torch.float32: {"dx": (1e-4, 1e-4), "rel_fro": 1e-4},
           torch.bfloat16: {"dx": (2e-2, 2e-2), "rel_fro": 1e-2}}


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


def gelu_grad_f32(h: torch.Tensor) -> torch.Tensor:
    """d/dh [h·Φ(h)] = Φ(h) + h·φ(h) in float32 (``fused_mlp.py:229-233``,
    with the exact erf)."""
    cdf = 0.5 * (1.0 + torch.erf(h * 0.7071067811865476))
    return cdf + h * (torch.exp(-0.5 * h * h) * 0.3989422804014327)


def fused_ln_mlp_backward_reference(x, g, ls, lb, w1, b1, w2, b2,
                                    eps: float = 1e-6):
    """Plain version of :func:`fused_ln_mlp_backward`, the TPU kernel's
    rounding points made step by step (``fused_mlp.py:258-298``): the
    forward recomputed from x (``h1`` rounded to x.dtype and widened,
    ``a = gelu(h1)`` in x.dtype), ``dh = (g·w2ᵀ)·gelu'(h1)`` rounded to
    x.dtype before both ``yᵀ·dh`` and ``dh·w1ᵀ``, ``db1`` summed from the
    rounded ``dh``, the LayerNorm backward in float32 from the per-row
    statistics, ``dx = g + round(dx_ln)``.  Weight, bias and LayerNorm
    gradients are float32 sums, returned in each parameter's dtype."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    r = torch.rsqrt(var + eps)
    xhat = (xf - mean) * r
    lsf = ls.float()
    y = (xhat * lsf + lb.float()).to(dt)
    h1 = (y.float() @ w1.to(dt).float() + b1.float()).to(dt).float()
    a = gelu_f32(h1.to(dt))
    gd = g.to(dt)
    gf = gd.float()
    dw2 = a.float().t() @ gf
    db2 = gf.sum(dim=0)
    dh = ((gf @ w2.to(dt).float().t()) * gelu_grad_f32(h1)).to(dt).float()
    dw1 = y.float().t() @ dh
    db1 = dh.sum(dim=0)
    dy = dh @ w1.to(dt).float().t()
    dls = (dy * xhat).sum(dim=0)
    dlb = dy.sum(dim=0)
    dxhat = dy * lsf
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = gd + (r * (dxhat - m1 - xhat * m2)).to(dt)
    return (dx, dls.to(ls.dtype), dlb.to(lb.dtype), dw1.to(w1.dtype),
            db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype))


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


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("fused_ln_mlp_bwd")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fused_ln_mlp_bwd_{sfx}")
        fn.argtypes = [vp] * 10 + [i32] * 3 + [ctypes.c_float, vp, vp]
        fn.restype = i32
    lib.fused_ln_mlp_bwd_workspace.argtypes = [i32] * 4
    lib.fused_ln_mlp_bwd_workspace.restype = ctypes.c_longlong
    lib.fused_ln_mlp_bwd_error_string.argtypes = [i32]
    lib.fused_ln_mlp_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, ls, lb, w1, b1, w2, b2):
    if x.dim() != 2:
        raise ValueError(f"x must be [M, C], got shape {tuple(x.shape)}")
    c = x.shape[1]
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_ln_mlp: tensors must be on the CPU or a "
                         f"CUDA device, got {x.device}")
    if x.device.type == "cuda" and (c not in CHANNELS or f % F_STEP):
        raise ValueError(f"fused_ln_mlp: the kernel takes C in {CHANNELS} and "
                         f"F a multiple of {F_STEP}, got C={c}, F={f}")


def _on(device, *tensors):
    for t in tensors:
        if t.device != device:
            raise ValueError(f"fused_ln_mlp: all tensors must be on {device}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with its data 16-byte aligned (the kernels move 16
    bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward_kernel(x, ls, lb, w1, b1, w2, b2, eps):
    m, c = x.shape
    f = w1.shape[-1]
    x = _aligned(x)
    # [F, C] and [C, F]: each output's weights contiguous (the conv
    # parameters themselves when the model passes their transposed views)
    w1k = w1.t().to(x.dtype).contiguous()
    w2k = w2.t().to(x.dtype).contiguous()
    vecs = [t.float().contiguous() for t in (ls, lb, b1, b2)]
    _on(x.device, w1k, w2k, *vecs)
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


def fused_ln_mlp_backward(x: torch.Tensor, g: torch.Tensor, ls: torch.Tensor,
                          lb: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, eps: float = 1e-6):
    """Gradients of :func:`fused_ln_mlp` at x [M, C] for the output
    cotangent g [M, C] → (dx [M, C] in x.dtype, dls, dlb, dw1 [C, F],
    db1, dw2 [F, C], db2), the parameter gradients summed in float32 and
    returned in each parameter's dtype.  The [M, F] intermediate is
    recomputed inside the kernel and never stored."""
    _check(x, ls, lb, w1, b1, w2, b2)
    if tuple(g.shape) != tuple(x.shape):
        raise ValueError(f"g must be {tuple(x.shape)}, got {tuple(g.shape)}")
    if x.device.type == "cpu":
        return fused_ln_mlp_backward_reference(x, g, ls, lb, w1, b1, w2, b2,
                                               eps)
    dt = x.dtype
    m, c = x.shape
    f = w1.shape[-1]
    x, g = _aligned(x), _aligned(g.to(dt))
    w1k = w1.t().to(dt).contiguous()   # [F, C]: fc1's conv weight
    w2k = w2.to(dt).contiguous()       # [F, C]: the JAX layout
    vecs = [t.float().contiguous() for t in (ls, lb, b1)]
    _on(x.device, g, w1k, w2k, *vecs)
    dx = torch.empty_like(x)
    # float32 sums: [dw1ᵀ (F×C) | dw2 (F×C) | db1 (F)] and [dls | dlb | db2]
    new = torch.empty if m > 0 else torch.zeros
    ow = new(2 * f * c + f, dtype=torch.float32, device=x.device)
    ov = new(3 * c, dtype=torch.float32, device=x.device)
    if m > 0:
        lib = _bwd_lib()
        bf16 = int(dt == torch.bfloat16)
        ws = torch.empty(lib.fused_ln_mlp_bwd_workspace(m, c, f, bf16),
                         dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = getattr(lib, f"fused_ln_mlp_bwd_{_SUFFIX[dt]}")(
                x.data_ptr(), g.data_ptr(), vecs[0].data_ptr(),
                vecs[1].data_ptr(), w1k.data_ptr(), vecs[2].data_ptr(),
                w2k.data_ptr(), dx.data_ptr(), ow.data_ptr(), ov.data_ptr(),
                m, c, f, eps, ws.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(
                "fused_ln_mlp_backward launch failed: "
                f"{lib.fused_ln_mlp_bwd_error_string(rc).decode()}")
        fused_ln_mlp_backward.launches += 1
    dw1 = ow[:f * c].view(f, c).t()
    dw2 = ow[f * c:2 * f * c].view(f, c)
    dls, dlb, db2 = ov.view(3, c)
    return (dx, dls.to(ls.dtype), dlb.to(lb.dtype), dw1.to(w1.dtype),
            ow[2 * f * c:].to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype))


class _FusedLnMlp(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain version) forward and
    :func:`fused_ln_mlp_backward` backward.  Only the inputs are kept for
    the backward, as the JAX ``custom_vjp`` keeps them."""

    @staticmethod
    def forward(ctx, x, ls, lb, w1, b1, w2, b2, eps):
        ctx.save_for_backward(x, ls, lb, w1, b1, w2, b2)
        ctx.eps = eps
        if x.device.type == "cpu":
            return fused_ln_mlp_reference(x, ls, lb, w1, b1, w2, b2, eps)
        return _forward_kernel(x, ls, lb, w1, b1, w2, b2, eps)

    @staticmethod
    def backward(ctx, g):
        x, ls, lb, w1, b1, w2, b2 = ctx.saved_tensors
        return (*fused_ln_mlp_backward(x, g, ls, lb, w1, b1, w2, b2,
                                       ctx.eps), None)


def fused_ln_mlp(x: torch.Tensor, ls: torch.Tensor, lb: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x + mlp(layernorm(x))``: x [M, C] (float32 or bfloat16), ls/lb [C],
    w1 [C, F], b1 [F], w2 [F, C], b2 [C] → [M, C] in x.dtype.  The [M, F]
    intermediate exists only inside the kernel.  Differentiable: the
    backward is :func:`fused_ln_mlp_backward`."""
    _check(x, ls, lb, w1, b1, w2, b2)
    return _FusedLnMlp.apply(x, ls, lb, w1, b1, w2, b2, eps)


fused_ln_mlp.launches = 0
fused_ln_mlp_backward.launches = 0
