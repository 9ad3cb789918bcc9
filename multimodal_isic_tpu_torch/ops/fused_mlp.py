"""The conv-stage MLPs of ConvMAE's ``ConvBlock``, each in one kernel:
LayerNorm → 1×1 C→F → GELU → 1×1 F→C → residual (:func:`fused_ln_mlp`), and
the bare 1×1 C→F → GELU → 1×1 F→C2 (:func:`fused_mlp`).

The LayerNorm MLP is the counterpart of ``multimodal_isic_tpu/ops/
fused_mlp.py::fused_ln_mlp`` (forward, :162-213): the second half of
ConvMAE's ``ConvBlock`` over rows ``x [M, C]``.  The public function keeps
the JAX layouts: ``w1 [C, F]``, ``w2 [F, C]`` (the model passes views of its
``[out, in, 1, 1]`` conv weights, which the kernel reads in place when they
already are in the compute dtype).

Rounding points, those of the TPU kernel (and, in the plain version, made
explicitly): LayerNorm with float32 fast-variance statistics
(``E[x²] − mean²`` clipped at 0, eps 1e-6), rounded to x.dtype; ``y·w1``
accumulated in float32 plus ``b1``, rounded; exact-erf GELU in float32,
rounded; ``a·w2`` in float32 plus ``b2``, rounded; the residual added in
x.dtype.  The biases and the LayerNorm scale and shift are read as float32
values (the model hands over ``b1``/``b2`` already rounded to its dtype, as
the JAX model does).

- On a CUDA tensor :func:`fused_ln_mlp` launches the hand-written kernel of
  ``csrc/fused_ln_mlp.cu`` (built with nvcc at first use), or raises.  The
  wrapper owns the launch plan (:func:`ln_mlp_plan`: rows a block, F chunk,
  ring stages, shared-memory bytes); the library refuses any plan it was
  not built for.
- On a CPU tensor it runs :func:`fused_ln_mlp_reference`.

The bare MLP is the counterpart of ``fused_mlp.py::fused_mlp`` (:116, the
Pallas kernel at :98): x [M, C], w1 [C, F], b1 [F], w2 [F, C2], b2 [C2], C,
F and C2 multiples of 128 (``ValueError`` otherwise).  Rounding points:
``x·w1`` accumulated in float32 plus ``b1``, rounded to x.dtype; exact-erf
GELU in float32 (:func:`gelu_f32`; the TPU kernel took the A&S 7.1.26 erf,
|err| 1.5e-7, for want of a Mosaic erf lowering; the card's kernel takes
``erff`` through ``csrc/convmae_common.cuh``), rounded; ``a·w2`` in float32
plus ``b2``, rounded.  The weights are read in x.dtype.  On a CUDA tensor
:func:`fused_mlp` launches ``csrc/fused_mlp.cu`` or raises; on a CPU tensor
it runs :func:`fused_mlp_reference`.  The wrapper owns the launch plan
(:func:`mlp_plan`: rows a tile, F chunk, ring stages, shared-memory bytes),
which the library holds it to.  bf16 runs on wgmma with the weight chunks
brought in by TMA (``csrc/wgmma_chain.cuh``) and reads w1 [C, F] and
w2 [F, C2] as they are; float32 runs on the cp.async FMA core of
``csrc/chained_gemm.cuh``, which reads K-contiguous rows, so its wrapper
passes w1ᵀ and w2ᵀ.  Its backward recomputes the plain
version under autograd, as the JAX ``_bwd`` recomputes ``_reference_mlp``
(:128-135): it has no kernel, in JAX either.  Launches are counted in
``fused_mlp.launches``.  No caller in the JAX package: it is an entry point
of its own.

The LayerNorm MLP's backward is the counterpart of the TPU kernel's
(``fused_mlp.py:239-347``): :func:`fused_ln_mlp_backward` launches
``csrc/fused_ln_mlp_bwd.cu`` on the card and runs
:func:`fused_ln_mlp_backward_reference` on the CPU.  Both recompute the
forward from x; neither is autograd through the plain forward.  On the card
the kernels write round(a) and round(dh) ([M, F] in x.dtype), y, dy and the
partial sums to a workspace laid out by :func:`ln_mlp_bwd_workspace`;
:func:`ln_mlp_bwd_plan` chooses the kernels' grids, and the library refuses
a plan that does not cover the rows.
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


SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)
# The forward kernel's instantiations, (rows a block, F chunk, ring stages)
# for each (dtype, C), the plan's first choice first: bf16 keeps a [rows, C]
# f32 accumulator in registers (C/4 a thread over 4·rows threads), float32
# two stages of [FC, C] and [C, FC] weight chunks in shared memory; bf16 at
# C 256 takes 64-row blocks of 32-wide chunks where 64 does not divide F.
# The library takes these and no other (``csrc/fused_ln_mlp.cu``).
_LN_MLP_TILES = {(torch.bfloat16, 256): ((128, 64, 2), (64, 32, 3)),
                 (torch.bfloat16, 384): ((96, 32, 2),),
                 (torch.float32, 256): ((64, 32, 2),),
                 (torch.float32, 384): ((64, 16, 2),)}
_PAD = {torch.float32: 4, torch.bfloat16: 8}  # elements a shared row


def _a16(n: int) -> int:
    return (n + 15) & ~15


def ln_mlp_smem_bytes(c: int, bm: int, fc: int, stages: int,
                      dtype: torch.dtype) -> int:
    """Shared memory of one forward block (``csrc/fused_ln_mlp.cu``'s
    ``LnMlp``): y [bm, C + pad], ``stages`` × (w1 chunk [fc, C + pad], w2
    chunk [C, fc + pad]) and the a tile [bm, fc + pad], each 16-byte
    aligned."""
    esz, pad = torch.finfo(dtype).bits // 8, _PAD[dtype]
    stage = _a16(fc * (c + pad) * esz) + _a16(c * (fc + pad) * esz)
    return (_a16(bm * (c + pad) * esz) + stages * stage
            + _a16(bm * (fc + pad) * esz))


def ln_mlp_plan(m: int, c: int, f: int, dtype: torch.dtype) -> dict:
    """The forward kernel's launch plan for x [M, C], F: ``bm`` rows a
    block, F chunk ``fc``, ring ``stages``, ``blocks`` (the last one
    ragged) and ``smem`` (bytes; the kernel refuses any other size): the
    first tile of :data:`_LN_MLP_TILES` whose chunk divides F.
    (Measured on the card, the largest row blocks win at every slice
    geometry, even where they leave most of a last wave empty.)"""
    if (dtype, c) not in _LN_MLP_TILES or m <= 0 or f <= 0:
        raise ValueError(f"fused_ln_mlp: no kernel plan for M={m}, C={c}, "
                         f"F={f}, {dtype}")
    fits = [t for t in _LN_MLP_TILES[(dtype, c)] if f % t[1] == 0]
    if not fits:
        raise ValueError(f"fused_ln_mlp: F={f} is not a multiple of the "
                         f"kernel's chunks")
    bm, fc, stages = fits[0]
    return {"bm": bm, "fc": fc, "stages": stages, "blocks": -(-m // bm),
            "smem": ln_mlp_smem_bytes(c, bm, fc, stages, dtype)}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_ln_mlp")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fused_ln_mlp_{sfx}")
        fn.argtypes = ([vp] * 8 + [i32] * 3 + [ctypes.c_float] + [i32] * 3
                       + [ctypes.c_longlong, vp])
        fn.restype = i32
    lib.fused_ln_mlp_error_string.argtypes = [i32]
    lib.fused_ln_mlp_error_string.restype = ctypes.c_char_p
    return lib


# The backward's launch plan, which the kernels' library checks:
# LayerNorm-backward blocks (8 rows a block, a persistent grid of at most
# 264), and the weight GEMMs' split of the M rows into ranges of whole
# 32-row units so that their [F/128 × C/128 × 2] tiles times the splits
# stay at most 264 blocks (two an SM).
_BWD_LN_GRID, _BWD_W_TARGET, _BWD_ALIGN, _BWD_SPLIT_ROWS = 264, 264, 256, 32


def ln_mlp_bwd_plan(m: int, c: int, f: int) -> dict:
    """The backward kernels' grid choices for x [M, C], F: ``norm_blocks``
    (LayerNorm-backward blocks), ``nsplit`` and ``rows_per`` (the weight
    GEMMs' row splits, each a whole number of 32-row units, none empty)."""
    tiles = 2 * -(-f // 128) * -(-c // 128)
    units = -(-m // _BWD_SPLIT_ROWS)
    s = min(max(_BWD_W_TARGET // tiles, 1), units)
    rows_per = -(-units // s) * _BWD_SPLIT_ROWS
    return {"norm_blocks": min(-(-m // 8), _BWD_LN_GRID),
            "nsplit": -(-m // rows_per), "rows_per": rows_per}


def ln_mlp_bwd_workspace(m: int, c: int, f: int,
                         dtype: torch.dtype) -> tuple[list[int], int]:
    """(byte offsets of the seven segments, bytes in all) of the backward's
    workspace: y [M, C], round(a) and round(dh) [M, F] in ``dtype``; dy
    [M, C] and the row statistics [M, 2] in float32; the LayerNorm-backward
    partials [blocks, 3, C] and the weight partials [nsplit, 2·F·C + F] in
    float32; each segment 256-byte aligned."""
    p = ln_mlp_bwd_plan(m, c, f)
    esz = torch.finfo(dtype).bits // 8
    sizes = (m * c * esz, m * f * esz, m * f * esz, m * c * 4, m * 8,
             p["norm_blocks"] * 3 * c * 4, p["nsplit"] * (2 * f * c + f) * 4)
    offs, o = [], 0
    for n in sizes:
        offs.append(o)
        o += -(-n // _BWD_ALIGN) * _BWD_ALIGN
    return offs, o


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("fused_ln_mlp_bwd")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fused_ln_mlp_bwd_{sfx}")
        fn.argtypes = ([vp] * 11 + [i32] * 3 + [ctypes.c_float,
                       ctypes.POINTER(vp)] + [i32] * 3 + [vp])
        fn.restype = i32
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
    if x.device.type == "cuda":
        check_ln_mlp_kernel_shape(c, f)


def check_ln_mlp_kernel_shape(c: int, f: int) -> None:
    """Raise ``ValueError`` where the card's LN-MLP kernels (forward and
    backward) cannot take C, F: C is a template argument (ConvViT-Base's
    conv-stage widths) and F is walked in 32-wide chunks and 16-byte
    copies."""
    if c not in CHANNELS or f % F_STEP:
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
    plan = ln_mlp_plan(m, c, f, x.dtype)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"fused_ln_mlp_{_SUFFIX[x.dtype]}")(
            x.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
            w1k.data_ptr(), vecs[2].data_ptr(), w2k.data_ptr(),
            vecs[3].data_ptr(), out.data_ptr(), m, c, f, eps, plan["bm"],
            plan["fc"], plan["stages"], plan["smem"], stream)
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
    returned in each parameter's dtype.  On the card the [M, F]
    intermediates round(a) and round(dh) go to a workspace
    (:func:`ln_mlp_bwd_workspace`) that lives for the call."""
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
    w1c = w1.to(dt).contiguous()       # [C, F]: the JAX layout
    w1k = w1.t().to(dt).contiguous()   # [F, C]: fc1's conv weight
    w2t = w2.t().to(dt).contiguous()   # [C, F]: fc2's conv weight
    vecs = [t.float().contiguous() for t in (ls, lb, b1)]
    _on(x.device, g, w1c, w1k, w2t, *vecs)
    dx = torch.empty_like(x)
    # float32 sums: [dw1ᵀ (F×C) | dw2 (F×C) | db1 (F)] and [dls | dlb | db2]
    new = torch.empty if m > 0 else torch.zeros
    ow = new(2 * f * c + f, dtype=torch.float32, device=x.device)
    ov = new(3 * c, dtype=torch.float32, device=x.device)
    if m > 0:
        lib = _bwd_lib()
        plan = ln_mlp_bwd_plan(m, c, f)
        offs, nbytes = ln_mlp_bwd_workspace(m, c, f, dt)
        ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        segs = (ctypes.c_void_p * len(offs))(*(ws.data_ptr() + o
                                               for o in offs))
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = getattr(lib, f"fused_ln_mlp_bwd_{_SUFFIX[dt]}")(
                x.data_ptr(), g.data_ptr(), vecs[0].data_ptr(),
                vecs[1].data_ptr(), w1c.data_ptr(), w1k.data_ptr(),
                w2t.data_ptr(), vecs[2].data_ptr(), dx.data_ptr(),
                ow.data_ptr(), ov.data_ptr(), m, c, f, eps, segs,
                plan["norm_blocks"], plan["nsplit"], plan["rows_per"],
                stream)
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


# ------------------------------------------------------------- the bare MLP

# C2 the kernels are built for (their accumulators live in registers), and
# the largest C at each (dtype, C2): the widths the library's configurations
# cover within one block's shared memory (the first-cut kernel's limits,
# kept: ``tests/test_torch_fused_mlp.py::test_kernel_shape_limits``).
MLP_C2 = (128, 256, 384, 512)
MLP_C_MAX = {(torch.bfloat16, 128): 1024, (torch.bfloat16, 256): 1024,
             (torch.bfloat16, 384): 896, (torch.bfloat16, 512): 896,
             (torch.float32, 128): 768, (torch.float32, 256): 640,
             (torch.float32, 384): 640, (torch.float32, 512): 512}
# The kernels' configurations, (rows a tile, F chunk, ring stages), the
# plan's first choice first (``csrc/fused_mlp.cu``, which takes these and no
# other).  bf16 (wgmma + TMA): 128-row tiles (a warpgroup's 64 rows each)
# where the accumulator [64, C2] fits a warpgroup's registers (C2 <= 256),
# else 64-row tiles whose C2 the two warpgroups split; F chunks of 64 in two
# stages where they fit beside the x tile (the first product's m64 x 64
# tiles read half the shared memory a product of m64 x 32 ones; two stages
# of 64 hold as many weights in flight as four of 32, in as much shared
# memory), else the deepest ring of 32-wide chunks, 16 where C is large.  float32 (the cp.async FMA core):
# 64-row blocks, 32 rows where C is large, two stages.
_MLP_TILES = {
    torch.bfloat16: {c2: (((128, 64, 2), (128, 32, 3)) if c2 <= 256 else ())
                     + ((64, 32, 3), (64, 32, 2), (64, 16, 3), (64, 16, 2))
                     for c2 in MLP_C2},
    torch.float32: {c2: ((64, 32, 2), (64, 16, 2), (32, 16, 2))
                    for c2 in MLP_C2}}
WG_CONSUMER_REGS = 232  # registers a consumer thread of the bf16 kernel
F32_MAX_REGS = 255
REG_MARGIN = 48  # a thread's registers besides its sums: addresses, loop state


def fused_mlp_reference(x, w1, b1, w2, b2):
    """Plain version of :func:`fused_mlp`, with the kernel's rounding points
    (matmuls on float32 copies of the x.dtype operands: products of bf16
    values are exact in float32)."""
    dt = x.dtype
    h = (x.float() @ w1.to(dt).float() + b1.float()).to(dt)
    a = gelu_f32(h)
    return (a.float() @ w2.to(dt).float() + b2.float()).to(dt)


def mlp_smem_bytes(c: int, c2: int, bm: int, fc: int, stages: int,
                   dtype: torch.dtype) -> int:
    """Shared memory of one block of ``csrc/fused_mlp.cu``.  bf16 (its
    ``wg_smem``): 1024 bytes to align the swizzled tiles, x [bm, C], each
    stage a w1 chunk [C, fc] and a w2 chunk [fc, C2], 256 bytes of
    mbarriers.  float32 (``f32_smem``): x [bm, C + 4], two stages of
    w1ᵀ [fc, C + 4] and w2ᵀ [C2, fc + 4], the a tile [bm, fc + 4], each
    16-byte aligned."""
    if dtype == torch.bfloat16:
        return 1024 + bm * c * 2 + stages * (c * fc + fc * c2) * 2 + 256
    return (_a16(bm * (c + 4) * 4) + stages * (_a16(fc * (c + 4) * 4)
            + _a16(c2 * (fc + 4) * 4)) + _a16(bm * (fc + 4) * 4))


def mlp_regs(c2: int, bm: int, fc: int, dtype: torch.dtype) -> int:
    """Registers a thread holds for its sums across an F chunk: bf16, a
    consumer's accumulator (64 rows × its C2 columns / 128 threads), h
    (64 × fc / 128) and a's A fragments (bf16 pairs); float32, the
    accumulator (bm/8 rows × C2/32) and h (bm/8 × fc/8)."""
    if dtype == torch.bfloat16:
        c2w = c2 if bm == 128 else c2 // 2
        return c2w // 2 + fc // 2 + fc // 4
    return bm // 8 * (c2 // 32) + bm // 8 * (fc // 8)


def _mlp_fits(cfg, c, c2, dtype) -> bool:
    bm, fc, stages = cfg
    budget = (WG_CONSUMER_REGS if dtype == torch.bfloat16
              else F32_MAX_REGS) - REG_MARGIN
    return (mlp_smem_bytes(c, c2, bm, fc, stages, dtype) <= SMEM_LIMIT
            and mlp_regs(c2, bm, fc, dtype) <= budget)


def check_mlp_kernel_shape(c: int, c2: int, dtype: torch.dtype) -> None:
    """Raise ``ValueError`` where the card's kernels cannot take C, C2."""
    if c2 not in MLP_C2:
        raise ValueError(f"fused_mlp: the kernel takes C2 in {MLP_C2} (its "
                         f"accumulator lives in registers), got C2={c2}")
    cmax = MLP_C_MAX.get((dtype, c2), 0)
    if c > cmax or not any(_mlp_fits(t, c, c2, dtype)
                           for t in _MLP_TILES.get(dtype, {}).get(c2, ())):
        raise ValueError(f"fused_mlp: C={c}, C2={c2} in {dtype}: no kernel "
                         f"configuration within one block's {SMEM_LIMIT} B of "
                         f"shared memory (C up to {cmax} at this C2)")


def fused_mlp_smem_bytes(c: int, c2: int, dtype: torch.dtype) -> int:
    """Shared memory of one block of the configuration :func:`mlp_plan`
    picks at C, C2 (any M)."""
    return mlp_plan(1, c, 128, c2, dtype)["smem"]


def mlp_plan(m: int, c: int, f: int, c2: int, dtype: torch.dtype) -> dict:
    """The bare MLP's launch plan for x [M, C], F, C2: ``bm`` rows a tile,
    F chunk ``fc``, ring ``stages``, ``smem`` (bytes a block; the library
    refuses any other), ``tiles`` (row tiles, the last one ragged) and, in
    bf16, ``split``: 1 where each consumer warpgroup owns 64 rows of a
    128-row tile, 2 where both own the tile's 64 rows and half of C2 each.
    The first configuration of ``_MLP_TILES`` whose chunk divides F and
    that fits shared memory and the register budget."""
    check_mlp_kernel_shape(c, c2, dtype)
    if m < 0 or f <= 0:
        raise ValueError(f"fused_mlp: no kernel plan for M={m}, F={f}")
    for cfg in _MLP_TILES[dtype][c2]:
        bm, fc, stages = cfg
        if f % fc == 0 and _mlp_fits(cfg, c, c2, dtype):
            return {"bm": bm, "fc": fc, "stages": stages,
                    "smem": mlp_smem_bytes(c, c2, bm, fc, stages, dtype),
                    "tiles": -(-m // bm),
                    "split": 128 // bm if dtype == torch.bfloat16 else None,
                    "regs": mlp_regs(c2, bm, fc, dtype)}
    raise ValueError(f"fused_mlp: F={f} is not a multiple of the kernel's "
                     f"chunks")


@functools.cache
def _mlp_lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fused_mlp_{sfx}")
        fn.argtypes = [vp] * 6 + [i32] * 7 + [ctypes.c_longlong, vp]
        fn.restype = i32
    lib.fused_mlp_error_string.argtypes = [i32]
    lib.fused_mlp_error_string.restype = ctypes.c_char_p
    return lib


def _check_mlp(x, w1, b1, w2, b2):
    if x.dim() != 2:
        raise ValueError(f"fused_mlp: x must be [M, C], got shape "
                         f"{tuple(x.shape)}")
    c = x.shape[1]
    if w1.dim() != 2 or w2.dim() != 2 or w1.shape[0] != c \
            or w2.shape[0] != w1.shape[1]:
        raise ValueError(f"fused_mlp: w1 must be [{c}, F] and w2 [F, C2], "
                         f"got {tuple(w1.shape)} and {tuple(w2.shape)}")
    f, c2 = w2.shape
    if tuple(b1.shape) != (f,) or tuple(b2.shape) != (c2,):
        raise ValueError(f"fused_mlp: b1 must be [{f}] and b2 [{c2}], got "
                         f"{tuple(b1.shape)} and {tuple(b2.shape)}")
    if c % 128 or f % 128 or c2 % 128:
        raise ValueError(f"fused_mlp needs lane-aligned dims (multiples of "
                         f"128), got C={c}, F={f}, C2={c2}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mlp: tensors must be on the CPU or a CUDA "
                         f"device, got {x.device}")
    if x.device.type == "cuda":
        check_mlp_kernel_shape(c, c2, x.dtype)


def _mlp_kernel(x, w1, b1, w2, b2):
    m, c = x.shape
    f, c2 = w2.shape
    x = _aligned(x)
    if x.dtype == torch.bfloat16:  # the weights as they are: [C, F], [F, C2]
        w1k, w2k = _aligned(w1.to(x.dtype)), _aligned(w2.to(x.dtype))
    else:  # the FMA core reads K-contiguous rows: [F, C] and [C2, F]
        w1k = w1.t().to(x.dtype).contiguous()
        w2k = w2.t().to(x.dtype).contiguous()
    b1f, b2f = b1.float().contiguous(), b2.float().contiguous()
    _on(x.device, w1k, w2k, b1f, b2f)
    out = torch.empty((m, c2), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    plan = mlp_plan(m, c, f, c2, x.dtype)
    lib = _mlp_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"fused_mlp_{_SUFFIX[x.dtype]}")(
            x.data_ptr(), w1k.data_ptr(), b1f.data_ptr(), w2k.data_ptr(),
            b2f.data_ptr(), out.data_ptr(), m, c, f, c2, plan["bm"],
            plan["fc"], plan["stages"], plan["smem"], stream)
    if rc != 0:
        raise RuntimeError("fused_mlp launch failed: "
                           f"{lib.fused_mlp_error_string(rc).decode()}")
    fused_mlp.launches += 1
    return out


class _FusedMlp(torch.autograd.Function):
    """Forward: the kernel, or the plain version on the CPU.  Backward:
    :func:`fused_mlp_reference` recomputed from the saved inputs under
    autograd (the JAX ``_bwd``)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        if x.device.type == "cpu":
            return fused_mlp_reference(x, w1, b1, w2, b2)
        return _mlp_kernel(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = fused_mlp_reference(*leaves)
            return torch.autograd.grad(out, leaves, g)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``gelu(x·w1 + b1)·w2 + b2`` over rows: x [M, C] (float32 or
    bfloat16), w1 [C, F], b1 [F], w2 [F, C2], b2 [C2] → [M, C2] in x.dtype;
    the [M, F] intermediate exists only inside the kernel.  Differentiable
    (module docstring)."""
    _check_mlp(x, w1, b1, w2, b2)
    return _FusedMlp.apply(x, w1, b1, w2, b2)


fused_mlp.launches = 0
