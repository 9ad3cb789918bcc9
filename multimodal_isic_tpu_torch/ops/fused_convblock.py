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
  ``csrc/fused_front.cu`` (built with nvcc at first use), or raises.
- On a CPU tensor it runs :func:`fused_front_reference`.

The JAX backward is a recompute (:189-196); it comes with ConvMAE training.
Launches are counted in ``fused_front.launches``.
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


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_front")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fused_front_{sfx}")
        fn.argtypes = [vp] * 11 + [i32] * 4 + [ctypes.c_float, vp]
        fn.restype = i32
    lib.fused_front_error_string.argtypes = [i32]
    lib.fused_front_error_string.restype = ctypes.c_char_p
    return lib


def fused_front(x: torch.Tensor, ls: torch.Tensor, lb: torch.Tensor,
                w1: torch.Tensor, b1: torch.Tensor, wd: torch.Tensor,
                bd: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                keep: Optional[torch.Tensor] = None,
                eps: float = 1e-6) -> torch.Tensor:
    """``x + conv1x1(gelu(dw5x5(keep * conv1x1(layernorm(x)))))``:
    x [B, H, W, C] (float32 or bfloat16) → [B, H, W, C] in x.dtype."""
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
    if x.device.type == "cpu":
        return fused_front_reference(x, ls, lb, w1, b1, wd, bd, w2, b2,
                                     keep, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_front: tensors must be on the CPU or a CUDA "
                         f"device, got {x.device}")
    if c not in CHANNELS:
        raise ValueError(f"fused_front: the kernel takes C in {CHANNELS}, "
                         f"got {c}")
    if bsz > _MAX_BATCH:
        raise ValueError(f"fused_front: batch {bsz} > {_MAX_BATCH}")
    dt = x.dtype
    x = x.contiguous()
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
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"fused_front_{_SUFFIX[dt]}")(
            x.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
            w1k.data_ptr(), vecs[2].data_ptr(), taps.data_ptr(),
            vecs[3].data_ptr(), w2k.data_ptr(), vecs[4].data_ptr(),
            keepk.data_ptr() if keepk is not None else None, out.data_ptr(),
            bsz, h, w, c, eps, stream)
    if rc != 0:
        raise RuntimeError("fused_front launch failed: "
                           f"{lib.fused_front_error_string(rc).decode()}")
    fused_front.launches += 1
    return out


fused_front.launches = 0
