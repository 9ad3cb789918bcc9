"""ConvBlock's first half in one kernel: LayerNorm → 1×1 → keep mask →
depthwise 5×5 SAME → GELU → 1×1 → residual.

Counterpart of ``multimodal_isic_tpu/ops/fused_convblock.py::fused_front``
(forward, :57-146).  The public function keeps the JAX layouts: x
[B, H, W, C] NHWC, ``w1``/``w2`` [C, C] (in → out), ``wd`` [5, 5, C],
``keep`` optional [B, H, W, 1] (1 = visible).

Rounding points, those of the TPU kernel: LayerNorm statistics in float32,
output rounded to x.dtype; ``y·w1`` in float32 plus ``b1``, rounded; times
``keep``; zero outside the image (the SAME padding of the unfused depthwise
sees zeros there, not ``LN(0)·w1 + b1``, ``fused_convblock.py:81-85``); the
25 taps multiplied in float32 on x.dtype values and summed in float32,
rounded; ``bd`` added in x.dtype; exact-erf GELU in float32, rounded;
``g·w2`` in float32 plus ``b2``, rounded; the residual added in x.dtype.
Vectors (LayerNorm scale and shift, biases) are read as float32 values: the
model hands them over rounded to its dtype, as the JAX model does.

- On a CUDA tensor :func:`fused_front` launches the hand-written kernel of
  ``csrc/fused_front.cu`` (built with nvcc at first use), or raises.  The
  wrapper owns the launch plan (:func:`front_plan`: column bands, rows a
  block, K chunk, ring stages, shared-memory bytes); the library refuses any
  plan it was not built for or that does not cover the image once.
- On a CPU tensor it runs :func:`fused_front_reference`.

The backward is the JAX one (:189-196): a recompute through the plain
version.  The public function goes through a ``torch.autograd.Function`` that
keeps only its inputs and, in the backward, runs
:func:`fused_front_reference` again under autograd (``keep`` takes no
gradient), so no [B·H·W, C] intermediate lives between the forward and the
backward.  Launches are counted in ``fused_front.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build, fused_mlp
from .depthwise import depthwise_conv2d
from .fused_mlp import gelu_f32, ln_rows

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
CHANNELS = (256, 384)  # C the kernel is built for: ConvViT-Base's conv stages
_MAX_BATCH = 65535          # gridDim.y
# The kernel's instantiations, (output columns a band at most, K chunk,
# ring stages) for each (dtype, C): the widest band whose ring of 5 h1 rows,
# y/g tile and weight ring fit one block's shared memory (bf16: the whole
# 56-wide stage-1 and 28-wide stage-2 rows).  The library takes these and
# no other (``csrc/fused_front.cu``).
_FRONT_TILES = {(torch.bfloat16, 256): (56, 32, 2),
                (torch.bfloat16, 384): (28, 32, 2),
                (torch.float32, 256): (14, 32, 3),
                (torch.float32, 384): (14, 16, 2)}
_NUM_SMS = 132  # the H100's SMs: row bands fill them once
_MIN_ROWS = 4  # output rows a block at least: its 4 halo rows stay <= 2x
# Kernel vs plain version, (atol, rtol): the fused LN-MLP's table, for the
# same kinds of rounding flips.
TOL = fused_mlp.TOL


def fused_front_reference(x, ls, lb, w1, b1, wd, bd, w2, b2,
                          keep: Optional[torch.Tensor] = None,
                          eps: float = 1e-6) -> torch.Tensor:
    """Plain version of :func:`fused_front`, with the kernel's rounding
    points (matmuls and the depthwise on float32 copies of x.dtype
    operands)."""
    dt = x.dtype
    c = x.shape[-1]
    y = ln_rows(x.float(), ls.float(), lb.float(), eps).to(dt)
    h1 = (y.float() @ w1.to(dt).float() + b1.float()).to(dt)
    if keep is not None:
        h1 = h1 * keep.to(dt)
    taps = wd.to(dt).float().reshape(5, 5, 1, c)
    d = depthwise_conv2d(h1.float(), taps).to(dt) + bd.to(dt)
    g = gelu_f32(d)
    out = (g.float() @ w2.to(dt).float() + b2.float()).to(dt)
    return x + out


def front_smem_bytes(c: int, band: int, kc: int, stages: int,
                     dtype: torch.dtype) -> int:
    """Shared memory of one block of ``csrc/fused_front.cu`` (its
    ``Front``): the ring of 5 h1 rows [5, band + 4, C], the y/g tile [mp,
    C + pad] (mp: band + 4 rounded up to 16 in bf16, to 4 in float32), the
    keep factors [mp] in float32 and ``stages`` weight tiles [C, kc + pad],
    each 16-byte aligned."""
    esz, pad = torch.finfo(dtype).bits // 8, fused_mlp._PAD[dtype]
    step = 16 if dtype == torch.bfloat16 else 4
    mp = -(-(band + 4) // step) * step
    a16 = fused_mlp._a16
    return (a16(5 * (band + 4) * c * esz) + a16(mp * (c + pad) * esz)
            + a16(mp * 4) + stages * a16(c * (kc + pad) * esz))


def front_plan(b: int, h: int, w: int, c: int, dtype: torch.dtype) -> dict:
    """The kernel's launch plan for x [B, H, W, C]: ``band_w`` output
    columns a band in ``n_bx`` bands (W evened out over the fewest bands of
    at most the tile's width), ``rows`` output rows a block in ``n_by`` row
    bands (enough blocks to fill the card's SMs once, one block an SM, but at
    least ``_MIN_ROWS`` rows a block), the K chunk ``kc``, ring ``stages``,
    ``blocks`` and ``smem`` (bytes; the kernel refuses any other size)."""
    if (dtype, c) not in _FRONT_TILES or min(b, h, w) <= 0:
        raise ValueError(f"fused_front: no kernel plan for [{b}, {h}, {w}, "
                         f"{c}] {dtype}")
    bw, kc, stages = _FRONT_TILES[(dtype, c)]
    n_bx = -(-w // bw)
    band_w = -(-w // n_bx)
    want_by = max(1, _NUM_SMS // (b * n_bx))
    rows = max(min(_MIN_ROWS, h), -(-h // want_by))
    n_by = -(-h // rows)
    return {"band_w": band_w, "n_bx": n_bx, "rows": rows, "n_by": n_by,
            "kc": kc, "stages": stages, "blocks": b * n_bx * n_by,
            "smem": front_smem_bytes(c, bw, kc, stages, dtype)}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_front")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fused_front_{sfx}")
        fn.argtypes = ([vp] * 11 + [i32] * 4 + [ctypes.c_float] + [i32] * 6
                       + [ctypes.c_longlong, vp])
        fn.restype = i32
    lib.fused_front_error_string.argtypes = [i32]
    lib.fused_front_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, ls, lb, w1, b1, wd, bd, w2, b2, keep):
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got shape {tuple(x.shape)}")
    bsz, h, w, c = x.shape
    if tuple(w1.shape) != (c, c) or tuple(w2.shape) != (c, c):
        raise ValueError(f"w1 and w2 must be [{c}, {c}], got "
                         f"{tuple(w1.shape)} and {tuple(w2.shape)}")
    if tuple(wd.shape) != (5, 5, c):
        raise ValueError(f"wd must be [5, 5, {c}], got {tuple(wd.shape)}")
    for name, t in (("ls", ls), ("lb", lb), ("b1", b1), ("bd", bd),
                    ("b2", b2)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be [{c}], got {tuple(t.shape)}")
    if keep is not None and tuple(keep.shape) != (bsz, h, w, 1):
        raise ValueError(f"keep must be [{bsz}, {h}, {w}, 1], got "
                         f"{tuple(keep.shape)}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_front: tensors must be on the CPU or a CUDA "
                         f"device, got {x.device}")
    if x.device.type == "cuda" and c not in CHANNELS:
        raise ValueError(f"fused_front: the kernel takes C in {CHANNELS}, "
                         f"got {c}")
    if x.device.type == "cuda" and bsz > _MAX_BATCH:
        raise ValueError(f"fused_front: batch {bsz} > {_MAX_BATCH}")


def _kernel(x, ls, lb, w1, b1, wd, bd, w2, b2, keep, eps):
    bsz, h, w, c = x.shape
    dt = x.dtype
    x = fused_mlp._aligned(x)
    # [C_out, C_in]: the conv parameters themselves when the model passes
    # their transposed views in the compute dtype
    w1k = w1.t().to(dt).contiguous()
    w2k = w2.t().to(dt).contiguous()
    taps = wd.to(dt).float().reshape(25, c).contiguous()
    vecs = [t.float().contiguous() for t in (ls, lb, b1, bd, b2)]
    keepk = (keep.to(dt).float().reshape(bsz, h, w).contiguous()
             if keep is not None else None)
    for t in (w1k, w2k, taps, *vecs) + ((keepk,) if keepk is not None else ()):
        if t.device != x.device:
            raise ValueError(f"fused_front: all tensors must be on {x.device}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    p = front_plan(bsz, h, w, c, dt)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"fused_front_{_SUFFIX[dt]}")(
            x.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
            w1k.data_ptr(), vecs[2].data_ptr(), taps.data_ptr(),
            vecs[3].data_ptr(), w2k.data_ptr(), vecs[4].data_ptr(),
            keepk.data_ptr() if keepk is not None else None, out.data_ptr(),
            bsz, h, w, c, eps, p["band_w"], p["n_bx"], p["rows"], p["n_by"],
            p["kc"], p["stages"], p["smem"], stream)
    if rc != 0:
        raise RuntimeError("fused_front launch failed: "
                           f"{lib.fused_front_error_string(rc).decode()}")
    fused_front.launches += 1
    return out


class _FusedFront(torch.autograd.Function):
    """Forward: the kernel, or the plain version on the CPU.  Backward:
    :func:`fused_front_reference` recomputed from the saved inputs under
    autograd, as the JAX ``_bwd`` runs ``jax.vjp`` of its XLA twin."""

    @staticmethod
    def forward(ctx, x, ls, lb, w1, b1, wd, bd, w2, b2, keep, eps):
        ctx.save_for_backward(x, ls, lb, w1, b1, wd, bd, w2, b2, keep)
        ctx.eps = eps
        if x.device.type == "cpu":
            return fused_front_reference(x, ls, lb, w1, b1, wd, bd, w2, b2,
                                         keep, eps)
        return _kernel(x, ls, lb, w1, b1, wd, bd, w2, b2, keep, eps)

    @staticmethod
    def backward(ctx, g):
        *inputs, keep = ctx.saved_tensors
        need = ctx.needs_input_grad[:9]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, need)]
            out = fused_front_reference(
                *leaves, keep=None if keep is None else keep.detach(),
                eps=ctx.eps)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(leaves, need) if n], g))
        return (*[next(grads) if n else None for n in need], None, None)


def fused_front(x: torch.Tensor, ls: torch.Tensor, lb: torch.Tensor,
                w1: torch.Tensor, b1: torch.Tensor, wd: torch.Tensor,
                bd: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                keep: Optional[torch.Tensor] = None,
                eps: float = 1e-6) -> torch.Tensor:
    """``x + conv1x1(gelu(dw5x5(keep * conv1x1(layernorm(x)))))``:
    x [B, H, W, C] (float32 or bfloat16) → [B, H, W, C] in x.dtype.
    Differentiable in everything but ``keep`` (the backward recomputes the
    plain version)."""
    _check(x, ls, lb, w1, b1, wd, bd, w2, b2, keep)
    return _FusedFront.apply(x, ls, lb, w1, b1, wd, bd, w2, b2, keep, eps)


fused_front.launches = 0
