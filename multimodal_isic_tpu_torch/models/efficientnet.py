"""EfficientNet (B0-B7) for serving, NHWC.

Counterpart of ``multimodal_isic_tpu/models/efficientnet.py`` (eval side):
MBConv with expand/depthwise/SE/project, swish, TF-SAME padding, BN with
eps 1e-3, compound width/depth scaling, the BN-folded serving variant
(``bn_folded``, weights from :func:`fold_batchnorm`) and the fused serving
kernels (``pallas_serving``, the JAX flag's name kept).  Training parts
(running-statistics update, drop-connect, remat, conv fission) are not here.

Layout: activations are contiguous NHWC tensors, as in the JAX package and
the fused kernels.  1×1 convs are ``F.linear`` over the channel dim; the stem
and depthwise convs hand cuDNN an NCHW view of the same memory in
``torch.channels_last`` format (``ops/depthwise.py``), so no layout copies
are made.  Conv weights are stored OIHW (``nn.Conv2d`` parameter holders), so
the state dict reads like PyTorch's.

The compute dtype is the dtype of the parameters (``model.to(torch.bfloat16)``
for the bf16 serving backbone); BatchNorm computes in float32 and casts back,
like the JAX ``TorchBatchNorm``.  Pooled features are returned in float32.

With ``bn_folded=True`` and ``pallas_serving=True`` every stride-1 MBConv
block runs one fused kernel (``ops/fused_dwconv.py``):
``expand_ratio != 1`` → ``expand_dw_silu_pool``, ``== 1`` → ``dw_silu_pool``.
The JAX VMEM fit condition has no counterpart, so at B3@380 the 190² blocks
0-1 take a kernel too.  Stride-2 blocks, the stem, SE, project and head stay
plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import fused_dwconv
from ..ops.depthwise import conv2d_nhwc, depthwise_conv2d

# (expand_ratio, kernel, stride, in_filters, out_filters, num_repeat) — B0 base
_BASE_BLOCKS = [
    (1, 3, 1, 32, 16, 1),
    (6, 3, 2, 16, 24, 2),
    (6, 5, 2, 24, 40, 2),
    (6, 3, 2, 40, 80, 3),
    (6, 5, 1, 80, 112, 3),
    (6, 5, 2, 112, 192, 4),
    (6, 3, 1, 192, 320, 1),
]

# name: (width_coefficient, depth_coefficient, resolution, dropout)
PARAMS = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
}

BN_EPS = 1e-3
SE_RATIO = 0.25


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def block_args(name: str) -> List[Tuple[int, int, int, int, int]]:
    """Expanded per-block (expand, kernel, stride, in, out) list."""
    width, depth, _, _ = PARAMS[name]
    blocks = []
    for expand, kernel, stride, cin, cout, repeat in _BASE_BLOCKS:
        cin = round_filters(cin, width)
        cout = round_filters(cout, width)
        for i in range(round_repeats(repeat, depth)):
            blocks.append((expand, kernel, stride if i == 0 else 1,
                           cin if i == 0 else cout, cout))
    return blocks


def feature_dim(model_name: str = "efficientnet-b3") -> int:
    return round_filters(1280, PARAMS[model_name][0])


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last (channel) dim, computed in float32
    whatever the input dtype and cast back (JAX ``TorchBatchNorm`` with
    ``use_running_average=True``)."""

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight.float() * torch.rsqrt(self.running_var.float()
                                                  + self.eps)
        y = (x.float() - self.running_mean.float()) * scale + self.bias.float()
        return y.to(x.dtype)


def _conv1x1(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """1×1 conv of an NHWC tensor: a matmul over the channel dim."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


class MBConv(nn.Module):
    def __init__(self, expand_ratio: int, kernel: int, stride: int,
                 in_filters: int, out_filters: int, bn_folded: bool = False,
                 pallas_serving: bool = False):
        super().__init__()
        self.expand_ratio, self.kernel, self.stride = expand_ratio, kernel, stride
        self.in_filters, self.out_filters = in_filters, out_filters
        self.bn_folded, self.pallas_serving = bn_folded, pallas_serving
        mid = in_filters * expand_ratio
        bn = (lambda c: nn.Identity()) if bn_folded else BatchNorm
        if expand_ratio != 1:
            self.expand_conv = nn.Conv2d(in_filters, mid, 1, bias=bn_folded)
            self.bn0 = bn(mid)
        self.depthwise_conv = nn.Conv2d(mid, mid, kernel, stride, groups=mid,
                                        bias=bn_folded)
        self.bn1 = bn(mid)
        se_ch = max(1, int(in_filters * SE_RATIO))
        self.se_reduce = nn.Conv2d(mid, se_ch, 1)
        self.se_expand = nn.Conv2d(se_ch, mid, 1)
        self.project_conv = nn.Conv2d(mid, out_filters, 1, bias=bn_folded)
        self.bn2 = bn(out_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        wd = self.depthwise_conv.weight.permute(2, 3, 1, 0)  # [K, K, 1, C]
        if self.bn_folded and self.pallas_serving and self.stride == 1:
            xk = x.contiguous()
            if self.expand_ratio != 1:
                we = self.expand_conv.weight.flatten(1).t()  # [Cin, Cmid]
                x, pool = fused_dwconv.expand_dw_silu_pool(
                    xk, we, self.expand_conv.bias, wd, self.depthwise_conv.bias)
            else:
                x, pool = fused_dwconv.dw_silu_pool(xk, wd,
                                                    self.depthwise_conv.bias)
            se = pool.to(x.dtype)
        else:
            if self.expand_ratio != 1:
                x = F.silu(self.bn0(_conv1x1(x, self.expand_conv)))
            x = depthwise_conv2d(x, wd, stride=self.stride,
                                 bias=self.depthwise_conv.bias)
            x = F.silu(self.bn1(x))
            se = x.mean(dim=(1, 2))
        se = F.silu(F.linear(se, self.se_reduce.weight.flatten(1),
                             self.se_reduce.bias))
        se = F.linear(se, self.se_expand.weight.flatten(1), self.se_expand.bias)
        x = x * torch.sigmoid(se)[:, None, None, :]
        x = self.bn2(_conv1x1(x, self.project_conv))
        if self.stride == 1 and self.in_filters == self.out_filters:
            x = x + inputs
        return x


class EfficientNet(nn.Module):
    """Feature extractor: NHWC image [B, H, W, 3] → pooled features
    [B, feature_dim] in float32 (eval mode; feature dropout is inactive)."""

    def __init__(self, model_name: str = "efficientnet-b3",
                 bn_folded: bool = False, pallas_serving: bool = False):
        super().__init__()
        if pallas_serving and not bn_folded:
            raise ValueError("pallas_serving requires bn_folded=True")
        self.model_name = model_name
        width = PARAMS[model_name][0]
        bn = (lambda c: nn.Identity()) if bn_folded else BatchNorm
        stem = round_filters(32, width)
        self.stem_conv = nn.Conv2d(3, stem, 3, 2, bias=bn_folded)
        self.stem_bn = bn(stem)
        self.blocks = nn.ModuleList(
            MBConv(*args, bn_folded=bn_folded, pallas_serving=pallas_serving)
            for args in block_args(model_name))
        head = feature_dim(model_name)
        self.head_conv = nn.Conv2d(self.blocks[-1].out_filters, head, 1,
                                   bias=bn_folded)
        self.head_bn = bn(head)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.stem_conv.weight.dtype)
        x = conv2d_nhwc(x, self.stem_conv.weight, self.stem_conv.bias, stride=2)
        x = F.silu(self.stem_bn(x))
        for block in self.blocks:
            x = block(x)
        x = F.silu(self.head_bn(_conv1x1(x, self.head_conv)))
        return x.mean(dim=(1, 2)).float()


# ------------------------------------------------ inference BN folding

def _fold_pair(sd: Dict[str, torch.Tensor], conv: str, bn: str,
               out: Dict[str, torch.Tensor]) -> None:
    """Fold eval BN into a bias-free conv, in float64:
    y = scale*(conv(x)-mean)*rsqrt(var+eps) + bias
      = conv_{w*s}(x) + (bias - mean*s),  s = scale*rsqrt(var+eps).
    Output channels sit on dim 0 of OIHW, for dense and depthwise alike."""
    f64 = lambda k: np.asarray(sd[k].detach().cpu().double())
    s = f64(f"{bn}.weight") / np.sqrt(f64(f"{bn}.running_var") + BN_EPS)
    w = f64(f"{conv}.weight") * s[:, None, None, None]
    b = f64(f"{bn}.bias") - f64(f"{bn}.running_mean") * s
    out[f"{conv}.weight"] = torch.from_numpy(w.astype(np.float32))
    out[f"{conv}.bias"] = torch.from_numpy(b.astype(np.float32))


def fold_batchnorm(state_dict: Dict[str, torch.Tensor],
                   model_name: str = "efficientnet-b3",
                   prefix: str = "") -> Dict[str, torch.Tensor]:
    """State dict of a standard :class:`EfficientNet` → the state dict of
    ``EfficientNet(bn_folded=True)`` (float32 CPU tensors).  Every conv→BN
    pair collapses to one conv with bias; SE convs pass through.  ``prefix``
    selects the backbone inside a larger state dict (e.g. ``"image_model."``)
    and is kept on the output keys."""
    sd, p = state_dict, prefix
    out: Dict[str, torch.Tensor] = {}
    _fold_pair(sd, f"{p}stem_conv", f"{p}stem_bn", out)
    for i in range(len(block_args(model_name))):
        b = f"{p}blocks.{i}"
        if f"{b}.expand_conv.weight" in sd:
            _fold_pair(sd, f"{b}.expand_conv", f"{b}.bn0", out)
        _fold_pair(sd, f"{b}.depthwise_conv", f"{b}.bn1", out)
        _fold_pair(sd, f"{b}.project_conv", f"{b}.bn2", out)
        for se in ("se_reduce", "se_expand"):
            for leaf in ("weight", "bias"):
                out[f"{b}.{se}.{leaf}"] = sd[f"{b}.{se}.{leaf}"].detach().cpu().float()
    _fold_pair(sd, f"{p}head_conv", f"{p}head_bn", out)
    return out
