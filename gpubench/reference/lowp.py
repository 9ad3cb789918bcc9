"""The lower precisions the controls compute in.

- ``fp8``: each operand of a product rounded to float8 e4m3 with one scale
  a tensor (its largest magnitude at 448, e4m3's largest finite value), the
  product accumulated in float32: the step below bfloat16.
- ``tf32``: float32 products on the tensor cores in TF32 (10-bit
  mantissa), the step below float32 with TF32 off.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    t = t.float()
    scale = t.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


@contextlib.contextmanager
def tf32(on: bool = True):
    """TF32 for cuBLAS and cuDNN inside the block (off again after)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
