"""Non-causal softmax attention in float32, one kernel.

Counterpart of ``multimodal_isic_tpu/ops/attention.py::flash_attention``
(forward, :26-93): ``softmax(q·kᵀ/√D)·v`` over [B, H, N, D], computed in
float32 whatever the operands' dtype (the JAX model casts q, k and v to
float32 before its kernel, ``models/convmae.py:76-80``; bf16 → float32 is
exact, so the kernel reads the operands as they are and widens them in
registers).  The result is rounded to the operands' dtype, as the JAX model
rounds the kernel's float32 output.

The operands may be strided views: the model hands over q, k and v as
views of its ``[B, N, 3, H, D]`` qkv projection, and the kernel reads them
there, with no transpose or copy.  The result is a [B, H, N, D] view of a
contiguous [B, N, H, D] tensor, so ``out.transpose(1, 2).reshape(B, N,
H·D)`` is free.

- On a CUDA tensor :func:`flash_attention` launches the hand-written kernel
  of ``csrc/flash_attention.cu`` (built with nvcc at first use), or raises.
- On a CPU tensor it runs :func:`flash_attention_reference`.

The backward is the JAX one (:120-124): a recompute through the plain
version.  The public function goes through a ``torch.autograd.Function`` that
keeps only q, k and v and, in the backward, runs
:func:`flash_attention_reference` again under autograd, so no [N, N] tensor
lives between the forward and the backward.  Launches are counted in
``flash_attention.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
HEAD_DIMS = (32, 64)
_MAX_GRID_Y = 65535
# Kernel vs plain version, (atol, rtol): float32 arithmetic in another
# order; the bf16 output may flip one rounding.
TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Plain version: float32 scores of q scaled by 1/√D, softmax, float32
    product with v, rounded to q.dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q.float() * scale) @ k.float().transpose(-1, -2)
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"flash_attention_{sfx}")
        fn.argtypes = [vp] * 4 + [i32] * 13 + [vp]
        fn.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be [B, H, N, D] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: tensors must be on the CPU or a "
                         f"CUDA device, got {q.device}")
    if q.device.type == "cpu":
        return
    b, h, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim must be in {HEAD_DIMS}, "
                         f"got {d}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: B·H {b * h} > {_MAX_GRID_Y}")
    vec = 16 // q.element_size()  # the kernel moves 16 bytes at a time
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"flash_attention: all tensors must be on "
                             f"{q.device}")
        st = t.stride()
        if st[3] != 1 or any(s % vec for s in st[:3]) or t.data_ptr() % 16:
            raise ValueError("flash_attention: the D axis must be contiguous, "
                             f"the other strides multiples of {vec} and the "
                             f"data 16-byte aligned, got strides {st}")


def _kernel(q, k, v) -> torch.Tensor:
    """The kernel's result, [B, N, H, D] contiguous."""
    b, h, n, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, f"flash_attention_{_SUFFIX[q.dtype]}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, n, d, *strides, stream)
    if rc != 0:
        raise RuntimeError("flash_attention launch failed: "
                           f"{lib.flash_attention_error_string(rc).decode()}")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel ([B, N, H, D] out), or the plain version on the
    CPU.  Backward: :func:`flash_attention_reference` recomputed from the
    saved q, k, v under autograd; the gradients come back in q's, k's and
    v's shapes (strided views of the qkv projection in the model)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return flash_attention_reference(q, k, v).transpose(1, 2).contiguous()
        return _kernel(q, k, v)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = flash_attention_reference(*leaves)
            return torch.autograd.grad(out, leaves, g.transpose(1, 2))


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Softmax attention, q/k/v [B, H, N, D] (float32 or bfloat16, any
    strides with the D axis contiguous) → [B, H, N, D] in q.dtype.
    Differentiable (the backward recomputes the plain version)."""
    _check(q, k, v)
    return _FlashAttention.apply(q, k, v).transpose(1, 2)


flash_attention.launches = 0
