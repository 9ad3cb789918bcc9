"""Fused MBConv serving kernels: [expand 1×1 → silu →] depthwise K×K → silu,
plus the squeeze-excite global mean pool from the same pass.

Counterpart of ``multimodal_isic_tpu/ops/fused_dwconv.py``.  The two public
functions keep its layouts (NHWC activations, depthwise weights
``[K, K, 1, C]``, expand weights ``[Cin, Cmid]`` or ``[1, 1, Cin, Cmid]``) and
return ``(y in x.dtype, pool [B, C] float32)``; there is no row-tile or
interpret argument.  The kernels read weights in PyTorch's conv layouts, so
the model's views of its OIHW parameters reach them without a copy.

- On a CUDA tensor each launches its hand-written kernel from
  ``csrc/fused_dwconv.cu`` (built with nvcc at first use, see ``_build``), or
  raises: there is no fallback.
- On a CPU tensor each runs its plain PyTorch version
  (``*_reference``), which the tests hold against the JAX package and which
  the card's smoke run holds the kernels against.

The TPU VMEM fit model (``pick_row_tile_*``, ``fits_pallas_*``) has no
counterpart: the CUDA kernel tiles rows to its shared-memory budget itself,
so every stride-1 block of the serving forward takes a kernel.

Neither kernel has a backward, as the JAX kernels have no VJP: each wrapper
raises when grad mode is on and an input requires grad, on every device, and
returns a result off the autograd graph only under ``torch.no_grad`` /
``torch.inference_mode`` or when no input requires grad.  (The serving path
runs under inference mode; training takes the unfused blocks.)

Each wrapper counts its kernel launches in ``<function>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .depthwise import depthwise_conv2d

KERNEL_SIZES = (3, 5)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_BATCH = 65535  # gridDim.z


# ----------------------------------------------------------- plain versions

def dw_silu_pool_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Plain version of :func:`dw_silu_pool`, with the kernel's casts: taps
    multiply in f32 on values read in x.dtype, bias and silu in f32, y cast
    to x.dtype, pool from the f32 activations."""
    h, ww = x.shape[1], x.shape[2]
    act = F.silu(depthwise_conv2d(x.float(), w.float(), bias=b.float()))
    return (act.to(x.dtype).contiguous(),
            act.sum(dim=(1, 2)) * (1.0 / (h * ww)))


def expand_dw_silu_pool_reference(x: torch.Tensor, we: torch.Tensor,
                                  be: torch.Tensor, wd: torch.Tensor,
                                  bd: torch.Tensor):
    """Plain version of :func:`expand_dw_silu_pool`: the expand product in
    f32, + be, silu, rounded to x.dtype, then :func:`dw_silu_pool_reference`
    (whose SAME zero padding applies after the expand, as in the unfused
    graph)."""
    we2 = we.reshape(x.shape[-1], -1)
    e = torch.einsum("bhwc,cd->bhwd", x.float(), we2.float()) + be.float()
    return dw_silu_pool_reference(F.silu(e).to(x.dtype), wd, bd)


# ------------------------------------------------------------- the kernels

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_dwconv")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"dw_silu_pool_{sfx}")
        fn.argtypes, fn.restype = [vp] * 5 + [i32] * 6 + [vp], i32
        fn = getattr(lib, f"expand_dw_silu_pool_{sfx}")
        fn.argtypes, fn.restype = [vp] * 7 + [i32] * 7 + [vp], i32
    lib.fused_dwconv_error_string.argtypes = [i32]
    lib.fused_dwconv_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor, c: int):
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got shape {tuple(x.shape)}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    k = wd.shape[0]
    if k not in KERNEL_SIZES or tuple(wd.shape) != (k, k, 1, c):
        raise ValueError(f"depthwise weight must be [K, K, 1, {c}] with K in "
                         f"{KERNEL_SIZES}, got {tuple(wd.shape)}")
    if tuple(bd.shape) != (c,):
        raise ValueError(f"depthwise bias must be [{c}], got {tuple(bd.shape)}")


def _no_backward(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (neither has the JAX kernel): call it "
            "under torch.no_grad() or torch.inference_mode(), or with inputs "
            "that do not require grad")


def _kernel_weights(x: torch.Tensor, wd: torch.Tensor, biases):
    """The kernel's operand layouts: depthwise [C, K*K] in x.dtype (the
    OIHW parameter itself when ``wd`` is its ``permute(2, 3, 1, 0)`` view, as
    in the model: no copy) and the biases as they are when both are f32 or
    both bf16 (else f32), with the flag that tells the kernel which."""
    k, c = wd.shape[0], wd.shape[-1]
    wk = wd.permute(3, 2, 0, 1).reshape(c, k * k).to(x.dtype).contiguous()
    dt = biases[0].dtype
    if dt not in _SUFFIX or any(b.dtype != dt for b in biases):
        dt = torch.float32
    return wk, [b.to(dt).contiguous() for b in biases], int(dt == torch.bfloat16)


def _launch(name: str, x: torch.Tensor, tensors, ints, c: int):
    """Allocate y and the zeroed pool, launch ``<name>_<dtype>`` on the
    current stream, raise on a refused launch."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA "
                         f"device, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous NHWC (an NCHW tensor "
                         "needs torch.channels_last and a permute)")
    if x.shape[0] > _MAX_BATCH:
        raise ValueError(f"{name}: batch {x.shape[0]} > {_MAX_BATCH}")
    vec = 16 // x.element_size()  # the kernel moves 16 bytes at a time
    if x.shape[-1] % vec or c % vec or x.data_ptr() % 16:
        raise ValueError(f"{name}: channel counts must be multiples of {vec} "
                         f"for {x.dtype} and x 16-byte aligned, got "
                         f"{x.shape[-1]} -> {c}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on {x.device}")
    bsz, h, w = x.shape[:3]
    y = torch.empty((bsz, h, w, c), dtype=x.dtype, device=x.device)
    pool = torch.zeros((bsz, c), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"{name}_{_SUFFIX[x.dtype]}")(
            *(t.data_ptr() for t in (x, *tensors, y, pool)), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.fused_dwconv_error_string(rc).decode()}")
    return y, pool


def dw_silu_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Stride-1 SAME depthwise conv + bias + silu + global mean.

    x [B, H, W, C] (float32 or bfloat16), w [K, K, 1, C], b [C] →
    (y [B, H, W, C] in x.dtype, pool [B, C] float32), ``pool`` being the mean
    of the f32 activations before their cast.
    """
    c = x.shape[-1]
    _check(x, w, b, c)
    _no_backward("dw_silu_pool", x, w, b)
    if x.device.type == "cpu":
        return dw_silu_pool_reference(x, w, b)
    bsz, h, ww = x.shape[:3]
    wk, (bk,), bias_bf16 = _kernel_weights(x, w, [b])
    out = _launch("dw_silu_pool", x, (wk, bk),
                  (bsz, h, ww, c, w.shape[0], bias_bf16), c)
    dw_silu_pool.launches += 1
    return out


def expand_dw_silu_pool(x: torch.Tensor, we: torch.Tensor, be: torch.Tensor,
                        wd: torch.Tensor, bd: torch.Tensor):
    """silu(x @ we + be) → stride-1 SAME depthwise(wd) + bd → silu → pool.

    x [B, H, W, Cin], we [1, 1, Cin, Cmid] or [Cin, Cmid], be [Cmid],
    wd [K, K, 1, Cmid], bd [Cmid] → (y [B, H, W, Cmid] in x.dtype,
    pool [B, Cmid] float32).  The [H, W, Cmid] expand output exists only in
    the kernel's shared memory.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got shape {tuple(x.shape)}")
    cin = x.shape[-1]
    if tuple(we.shape[:-1]) not in ((cin,), (1, 1, cin)):
        raise ValueError(f"expand weight must be [{cin}, Cmid] or "
                         f"[1, 1, {cin}, Cmid], got {tuple(we.shape)}")
    we2 = we.reshape(cin, -1)
    cmid = we2.shape[1]
    _check(x, wd, bd, cmid)
    if tuple(be.shape) != (cmid,):
        raise ValueError(f"expand bias must be [{cmid}], got {tuple(be.shape)}")
    _no_backward("expand_dw_silu_pool", x, we, be, wd, bd)
    if x.device.type == "cpu":
        return expand_dw_silu_pool_reference(x, we2, be, wd, bd)
    bsz, h, ww = x.shape[:3]
    wk, (bek, bdk), bias_bf16 = _kernel_weights(x, wd, [be, bd])
    # [Cmid, Cin]: the conv parameter itself when ``we`` is its transpose
    wek = we2.t().to(x.dtype).contiguous()
    out = _launch("expand_dw_silu_pool", x, (wek, bek, wk, bdk),
                  (bsz, h, ww, cin, cmid, wd.shape[0], bias_bf16), cmid)
    expand_dw_silu_pool.launches += 1
    return out


dw_silu_pool.launches = 0
expand_dw_silu_pool.launches = 0
