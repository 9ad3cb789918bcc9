"""EfficientNet (B0-B7), NHWC, for training and serving.

Counterpart of ``multimodal_isic_tpu/models/efficientnet.py``: MBConv with
expand/depthwise/SE/project, swish, TF-SAME padding, BN with eps 1e-3,
compound width/depth scaling, drop-connect (rates ``drop_connect_rate·i/n``,
:346) and feature dropout (``PARAMS[name][3]``, :358) in training, the
BN-folded serving variant (``bn_folded``, weights from
:func:`fold_batchnorm`) and the fused serving kernels (``pallas_serving``,
the JAX flag's name kept).  ``remat`` (``'none' | 'conv' | 'block'``,
JAX :268) recomputes each MBConv block in the backward pass with
``torch.utils.checkpoint``: ``'block'`` keeps only the block's input,
``'conv'`` also keeps the outputs of its convolutions and matmuls and
recomputes the BatchNorm, SiLU and SE chains (a selective-checkpoint
policy).  A recomputed block draws its drop-connect mask again from the
generator state it began with, and its BatchNorms leave the running
statistics alone, so loss, gradients and statistics equal ``'none'``'s; the
state dict is unchanged.  ``conv_fission`` has no counterpart: it places an
XLA fusion barrier, which has no PyTorch meaning.

Train and eval follow ``nn.Module.train()``/``eval()``.  BatchNorm in train
mode normalizes with the biased batch variance and moves the running
statistics with the unbiased one at flax momentum 0.99 (torch's 0.01), in
float32 (the JAX ``TorchBatchNorm``).  The stochastic layers draw from the
``rng`` generator the caller passes to ``forward`` (a
``core.rng.ShardedGenerator`` under data parallelism: the masks of the
global batch, the rank's rows kept); a training forward that needs one and
gets none raises (nothing reads torch's global RNG).  The
BN-folded variant is inference-only: it starts in eval mode and its forward
raises in train mode, as the JAX module does with ``train=True``.

Layout: activations are contiguous NHWC tensors, as in the JAX package and
the fused kernels.  1×1 convs are ``F.linear`` over the channel dim; the stem
and depthwise convs and BatchNorm hand cuDNN an NCHW view of the same memory
in ``torch.channels_last`` format (``ops/depthwise.py``), so no layout copies
are made.  Conv weights are stored OIHW (``nn.Conv2d`` parameter holders), so
the state dict reads like PyTorch's.

``dtype`` is the compute dtype, as flax's ``dtype``: weights are cast to it
where they are used (a no-op when they already are), so a bf16 backbone
trains on float32 master parameters.  The serving variant may store its
parameters in ``dtype`` itself (``model.to(torch.bfloat16)``).  BatchNorm
computes in float32 and casts back; pooled features are returned in float32.

With ``bn_folded=True`` and ``pallas_serving=True`` every stride-1 MBConv
block runs one fused kernel (``ops/fused_dwconv.py``):
``expand_ratio != 1`` → ``expand_dw_silu_pool``, ``== 1`` → ``dw_silu_pool``.
The JAX VMEM fit condition has no counterpart, so at B3@380 the 190² blocks
0-1 take a kernel too.  Stride-2 blocks, the stem, SE, project and head stay
plain PyTorch.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.rng import Rng, at_state, batch_rand
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
    """BatchNorm over the last (channel) dim of an NHWC tensor, with torch's
    running-statistics rule (JAX ``TorchBatchNorm``): train mode normalizes
    with the biased batch variance and moves the running mean and the
    UNBIASED running variance with flax momentum 0.99; eval mode uses the
    running statistics.  Statistics and arithmetic are float32 (float64 for
    float64 inputs) whatever the input dtype; the output is cast back."""

    MOMENTUM = 1.0 - 0.99  # flax decay 0.99 in torch's convention

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        # inside a remat block: the update goes to copies, kept in
        # ``updated`` until the block writes the first run's back
        self.on_copies = False
        self.updated: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = self.running_mean, self.running_var
        if self.on_copies:
            mean, var = mean.clone(), var.clone()
            self.updated = (mean, var)
        y = F.batch_norm(x.permute(0, 3, 1, 2), mean, var, self.weight,
                         self.bias, self.training, self.MOMENTUM, self.eps)
        return y.permute(0, 2, 3, 1)


def dropout(x: torch.Tensor, rate: float, training: bool,
            rng: Optional[Rng]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale it by 1/keep, in train mode only; the mask comes from ``rng``."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = batch_rand(_need(rng), x.shape, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def drop_connect(x: torch.Tensor, rate: float, training: bool,
                 rng: Optional[Rng]) -> torch.Tensor:
    """Per-sample stochastic depth on the residual branch: one Bernoulli
    keep flag per sample, scaled by 1/keep (JAX ``drop_connect``)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = batch_rand(_need(rng), (x.shape[0],) + (1,) * (x.dim() - 1),
                      x.device) < keep
    return x / keep * mask.to(x.dtype)


def _need(rng: Optional[Rng]) -> Rng:
    if rng is None:
        raise ValueError("a training forward with dropout or drop-connect "
                         "needs a torch.Generator: pass rng=")
    return rng


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype):
    return None if t is None else t.to(dtype)


def _conv1x1(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """1×1 conv of an NHWC tensor in x.dtype: a matmul over the channel
    dim."""
    return F.linear(x, conv.weight.flatten(1).to(x.dtype),
                    _cast(conv.bias, x.dtype))


class MBConv(nn.Module):
    def __init__(self, expand_ratio: int, kernel: int, stride: int,
                 in_filters: int, out_filters: int, drop_rate: float = 0.0,
                 bn_folded: bool = False, pallas_serving: bool = False):
        super().__init__()
        self.expand_ratio, self.kernel, self.stride = expand_ratio, kernel, stride
        self.in_filters, self.out_filters = in_filters, out_filters
        self.drop_rate = drop_rate
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

    def forward(self, x: torch.Tensor,
                rng: Optional[Rng] = None) -> torch.Tensor:
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
            x = depthwise_conv2d(x, wd.to(x.dtype), stride=self.stride,
                                 bias=_cast(self.depthwise_conv.bias, x.dtype))
            x = F.silu(self.bn1(x))
            se = x.mean(dim=(1, 2))
        se = F.silu(_conv1x1(se, self.se_reduce))
        se = _conv1x1(se, self.se_expand)
        x = x * torch.sigmoid(se)[:, None, None, :]
        x = self.bn2(_conv1x1(x, self.project_conv))
        if self.stride == 1 and self.in_filters == self.out_filters:
            x = drop_connect(x, self.drop_rate, self.training, rng) + inputs
        return x


REMAT = ("none", "conv", "block")
_SAVED_BY_CONV_REMAT = (torch.ops.aten.convolution.default,
                        torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_conv_outputs(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat='conv'``."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_CONV_REMAT
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_block(block: nn.Module, x: torch.Tensor,
                rng: Optional[Rng], remat: str) -> torch.Tensor:
    """``block(x, rng)`` in train mode, recomputed in the backward pass
    (``remat`` 'conv' or 'block').  Every run of the block, the recompute
    too, draws from a copy of ``rng`` at the state it had on entry, and its
    BatchNorms update copies of their running statistics; after the first
    run ``rng`` moves on as if the block had drawn from it and the copies
    that run updated become the running statistics.  The recompute makes
    the same ops as the first run, as the selective checkpoint requires."""
    start = rng.get_state() if rng is not None else None
    bns = [m for m in block.modules() if isinstance(m, BatchNorm)]
    runs = []

    def run(h):
        first = not runs
        runs.append(first)
        g = at_state(rng, start) if start is not None else None
        for m in bns:
            m.on_copies = True
        try:
            out = block(h, g)
        finally:
            for m in bns:
                m.on_copies = False
        if first and g is not None:
            rng.set_state(g.get_state())
        return out

    ctx = ({"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_conv_outputs)}
        if remat == "conv" else {})
    out = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False,
                     **ctx)
    with torch.no_grad():
        for m in bns:
            m.running_mean.copy_(m.updated[0])
            m.running_var.copy_(m.updated[1])
            m.updated = None
    return out


class EfficientNet(nn.Module):
    """Feature extractor: NHWC image [B, H, W, 3] → pooled features
    [B, feature_dim] in float32, feature dropout applied in train mode."""

    def __init__(self, model_name: str = "efficientnet-b3",
                 drop_connect_rate: float = 0.2, feature_dropout: bool = True,
                 dtype: torch.dtype = torch.float32,
                 bn_folded: bool = False, pallas_serving: bool = False,
                 remat: str = "none"):
        super().__init__()
        if pallas_serving and not bn_folded:
            raise ValueError("pallas_serving requires bn_folded=True")
        if remat not in REMAT:
            raise ValueError(f"remat must be none|conv|block, got {remat!r}")
        self.model_name, self.dtype, self.bn_folded = model_name, dtype, bn_folded
        self.remat = remat
        width, _, _, dropout_rate = PARAMS[model_name]
        self.dropout_rate = dropout_rate if feature_dropout else 0.0
        bn = (lambda c: nn.Identity()) if bn_folded else BatchNorm
        stem = round_filters(32, width)
        self.stem_conv = nn.Conv2d(3, stem, 3, 2, bias=bn_folded)
        self.stem_bn = bn(stem)
        args = block_args(model_name)
        self.blocks = nn.ModuleList(
            MBConv(*a, drop_rate=drop_connect_rate * i / len(args),
                   bn_folded=bn_folded, pallas_serving=pallas_serving)
            for i, a in enumerate(args))
        head = feature_dim(model_name)
        self.head_conv = nn.Conv2d(self.blocks[-1].out_filters, head, 1,
                                   bias=bn_folded)
        self.head_bn = bn(head)
        if bn_folded:
            self.eval()  # inference-only variant

    def forward(self, x: torch.Tensor,
                rng: Optional[Rng] = None) -> torch.Tensor:
        if self.bn_folded and self.training:
            raise ValueError("bn_folded is an inference-only variant: call "
                             ".eval() on it")
        x = x.to(self.dtype)
        x = conv2d_nhwc(x, self.stem_conv.weight.to(x.dtype),
                        _cast(self.stem_conv.bias, x.dtype), stride=2)
        x = F.silu(self.stem_bn(x))
        remat = self.training and torch.is_grad_enabled() and \
            self.remat != "none"
        for block in self.blocks:
            x = remat_block(block, x, rng, self.remat) if remat else block(x, rng)
        x = F.silu(self.head_bn(_conv1x1(x, self.head_conv)))
        x = x.mean(dim=(1, 2)).float()
        return dropout(x, self.dropout_rate, self.training, rng)


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
