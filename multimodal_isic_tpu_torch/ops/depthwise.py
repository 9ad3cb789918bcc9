"""TF-SAME padding and a plain depthwise convolution.

Counterpart of ``multimodal_isic_tpu/ops/depthwise.py`` (``same_pads`` :43,
``depthwise_conv2d`` :97).  The JAX module's custom VJP works around XLA:CPU's
dense grouped-conv gradient; PyTorch has no such problem, so only the forward
is ported.  The depthwise conv serves the stride-2 MBConv blocks and the plain
versions of the fused kernels (``ops/fused_dwconv.py``).

Layout follows the JAX package: activations NHWC, depthwise weights
``[K, K, 1, C]``.  Inside, the NHWC tensor is handed to ``F.conv2d`` as an NCHW
view in ``torch.channels_last`` memory format, so cuDNN reads it in place and
writes a channels-last result whose NHWC view is contiguous again.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """TF-style SAME padding (lo, hi) for one spatial dim.  For a stride-2
    conv on an odd size the pads are asymmetric, which ``padding=`` of
    ``F.conv2d`` cannot express."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    lo = total // 2
    return lo, total - lo


def pad_same_nhwc(x: torch.Tensor, kh: int, kw: int, stride: int) -> torch.Tensor:
    """Zero-pad the H and W dims of an NHWC tensor for a SAME conv."""
    top, bottom = same_pads(x.shape[1], kh, stride)
    left, right = same_pads(x.shape[2], kw, stride)
    return F.pad(x, (0, 0, left, right, top, bottom))


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride: int = 1,
                groups: int = 1) -> torch.Tensor:
    """SAME conv of an NHWC tensor with an OIHW weight → NHWC output."""
    xp = pad_same_nhwc(x, weight.shape[2], weight.shape[3], stride)
    y = F.conv2d(xp.permute(0, 3, 1, 2), weight, bias, stride=stride,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME-padded NHWC depthwise conv, ``w: [K, K, 1, C]``, optional bias
    ``[C]``."""
    weight = w.permute(3, 2, 0, 1)  # [K, K, 1, C] -> [C, 1, K, K]
    return conv2d_nhwc(x, weight, bias, stride=stride, groups=x.shape[-1])
