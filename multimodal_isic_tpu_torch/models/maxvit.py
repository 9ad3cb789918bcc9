"""MaxViT (Tu et al., *MaxViT: Multi-Axis Vision Transformer*, ECCV 2022,
arXiv:2204.01697), NHWC, as the fusion classifier's image branch.

No counterpart in the JAX package.  The backbone is the paper's: a stem of
two 3×3 convolutions (the first with stride 2), then stages of MaxViT
blocks, the first block of each stage halving the resolution.  A block is

1. a pre-norm MBConv, ``x + Proj(SE(GELU(BN(DW3x3(GELU(BN(Conv1x1(BN(x))))))))``,
   expansion 4 over the block's output width, squeeze-excitation of width
   ``int(0.25·C_out)`` with SiLU; in a stage's first block the depthwise
   conv has stride 2 and the shortcut is ``Proj1x1(AvgPool2×2(x))``;
2. block attention: pre-LayerNorm multi-head self-attention inside
   non-overlapping ``p×p`` windows (:func:`block_partition`);
3. an MLP (LayerNorm → C→4C → GELU → 4C→C);
4. grid attention: the same inside groups of ``p×p`` tokens spaced
   ``H/p`` apart, a dilated global mix (:func:`grid_partition`);
5. a second MLP.

Both attentions compute ``softmax(QKᵀ/√d + B)·V`` with ``B`` gathered from
a learned ``(2p−1)²`` table a head by relative position
(:func:`relpos_attention`).  The features are the global mean of the last
stage followed by LayerNorm: where the published head's pre-logits layer
begins; that layer and the classifier are left out, as the fusion net
drops EfficientNet's ``_fc``.

Choices the paper leaves open (``gpubench/configs/maxvit_base_fusion.json``
lists them under ``assumed``): exact-erf GELU; BatchNorm eps 1e-3 with the
port's running-statistics rule (``efficientnet.BatchNorm``, so the
data-parallel global-batch BatchNorm covers it); LayerNorm eps 1e-5;
TF-SAME padding; biases on the stem convs, the projection, the shortcut
and the SE convs and none before a BatchNorm; stochastic depth on each of
the five residual branches at ``Preset.drop_path_rate·i/n`` for block ``i``
of ``n``, one draw a sample from the ``rng`` the caller passes, in module
order.

The MLPs whose widths ``ops.fused_mlp.check_ln_mlp_kernel_shape`` admits
(C 384, F 1536: MaxViT-B's third stage) run on ``fused_ln_mlp``, the
ConvMAE conv-stage kernels (forward and backward) with this model's eps;
the others run on plain ops (``Mlp.use_fused_mlp``).  Under stochastic
depth the kernel's residual output ``x + m`` gives the branch as
``(x + m) − x``.

Each block's MBConv, block attention and grid attention is one span
(``maxvit.mbconv``, ``maxvit.block_attn``, ``maxvit.grid_attn``;
``utils/trace.py``), from its pre-norm to its residual add, the partition
and un-partition inside.  :func:`relpos_attention` counts its calls in
``relpos_attention.calls`` and the groups (windows or grid groups times the
batch) it attended in ``relpos_attention.groups``.  ``remat`` recomputes
each block in the backward pass as ``efficientnet.remat_block`` does; the
recomputed forward records no spans.

Parameters are float32 and the model computes in float32.
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.rng import Rng
from ..ops.depthwise import conv2d_nhwc, depthwise_conv2d
from ..ops.fused_mlp import check_ln_mlp_kernel_shape, fused_ln_mlp
from ..utils import trace
from .efficientnet import REMAT, BatchNorm, drop_connect, remat_block

LN_EPS = 1e-5


@dataclass(frozen=True)
class Preset:
    """A MaxViT variant: its stage widths and depths, the image size (and
    window, equal to the grid) it runs at, and its stochastic-depth rate
    (the fusion net's drop-connect rate, kept for fine-tuning)."""

    image_size: int
    stem: int
    widths: Tuple[int, ...]
    depths: Tuple[int, ...]
    window: int = 12
    head_dim: int = 32
    expansion: int = 4
    se_ratio: float = 0.25
    mlp_ratio: int = 4
    drop_path_rate: float = 0.2


# the paper's Table 1 widths and depths, at its 384² fine-tuning resolution
PARAMS = {
    "maxvit-base": Preset(image_size=384, stem=64, widths=(96, 192, 384, 768),
                          depths=(2, 6, 14, 2)),
}


def feature_dim(model_name: str = "maxvit-base") -> int:
    return PARAMS[model_name].widths[-1]


def _dense(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor]) -> torch.Tensor:
    """A Linear's or a 1×1 conv's weights over the last dim."""
    return F.linear(x, weight.flatten(1), bias)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 average pooling with stride 2 of an NHWC tensor of even H, W."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


# ------------------------------------------------------------- partitions

def block_partition(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] → [B·(H/p)·(W/p), p·p, C]: non-overlapping p×p
    windows, each window's tokens in row-major order."""
    b, h, w, c = x.shape
    x = x.view(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, p * p, c)


def block_unpartition(t: torch.Tensor, p: int, b: int, h: int,
                      w: int) -> torch.Tensor:
    """The inverse of :func:`block_partition`."""
    t = t.view(b, h // p, w // p, p, p, t.shape[-1]).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, h, w, -1)


def grid_partition(x: torch.Tensor, g: int) -> torch.Tensor:
    """[B, H, W, C] → [B·(H/g)·(W/g), g·g, C]: group (a, b) holds the
    tokens at rows a + i·H/g and columns b + j·W/g, i, j < g."""
    b, h, w, c = x.shape
    x = x.view(b, g, h // g, g, w // g, c).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(-1, g * g, c)


def grid_unpartition(t: torch.Tensor, g: int, b: int, h: int,
                     w: int) -> torch.Tensor:
    """The inverse of :func:`grid_partition`."""
    t = t.view(b, h // g, w // g, g, g, t.shape[-1]).permute(0, 3, 1, 4, 2, 5)
    return t.reshape(b, h, w, -1)


@functools.lru_cache(maxsize=None)
def relative_index(p: int, device: torch.device) -> torch.Tensor:
    """[p², p²] positions in a flattened (2p−1)² table: for tokens
    (r1, c1) and (r2, c2) of a p×p group, (r1 − r2 + p − 1)·(2p − 1) +
    c1 − c2 + p − 1."""
    r, c = torch.meshgrid(torch.arange(p), torch.arange(p), indexing="ij")
    r, c = r.flatten(), c.flatten()
    dr = r[:, None] - r[None, :] + p - 1
    dc = c[:, None] - c[None, :] + p - 1
    return (dr * (2 * p - 1) + dc).to(device)


def relpos_attention(qkv: torch.Tensor, table: torch.Tensor,
                     heads: int) -> torch.Tensor:
    """Multi-head self-attention inside each group with a relative-position
    bias: qkv [G, N, 3·C] (q, k, v, each head-major) of groups of N = p²
    tokens, table [heads, 2p−1, 2p−1] → [G, N, C] of
    ``softmax(QKᵀ/√d + B)·V``, B gathered from the table."""
    g, n, c3 = qkv.shape
    d = c3 // (3 * heads)
    p = math.isqrt(n)
    q, k, v = qkv.view(g, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    bias = table.flatten(1)[:, relative_index(p, table.device)]
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias.to(q.dtype))
    relpos_attention.calls += 1
    relpos_attention.groups += g
    return o.transpose(1, 2).reshape(g, n, heads * d)


relpos_attention.calls = 0
relpos_attention.groups = 0


# ----------------------------------------------------------------- blocks

class MBConv(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, preset: Preset,
                 drop_rate: float):
        super().__init__()
        mid = cout * preset.expansion
        se = max(1, int(cout * preset.se_ratio))
        self.stride, self.drop_rate = stride, drop_rate
        self.pre_bn = BatchNorm(cin)
        self.expand_conv = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = BatchNorm(mid)
        self.dw_conv = nn.Conv2d(mid, mid, 3, stride, groups=mid, bias=False)
        self.bn2 = BatchNorm(mid)
        self.se_reduce = nn.Conv2d(mid, se, 1)
        self.se_expand = nn.Conv2d(se, mid, 1)
        self.project_conv = nn.Conv2d(mid, cout, 1)
        self.shortcut_conv = (nn.Conv2d(cin, cout, 1) if cin != cout
                              else None)

    def forward(self, x: torch.Tensor, rng: Optional[Rng]) -> torch.Tensor:
        shortcut = avg_pool2(x) if self.stride == 2 else x
        if self.shortcut_conv is not None:
            shortcut = _dense(shortcut, self.shortcut_conv.weight,
                              self.shortcut_conv.bias)
        h = _dense(self.pre_bn(x), self.expand_conv.weight, None)
        h = F.gelu(self.bn1(h))
        h = depthwise_conv2d(h, self.dw_conv.weight.permute(2, 3, 1, 0),
                             stride=self.stride)
        h = F.gelu(self.bn2(h))
        se = _dense(h.mean(dim=(1, 2)), self.se_reduce.weight,
                    self.se_reduce.bias)
        se = _dense(F.silu(se), self.se_expand.weight, self.se_expand.bias)
        h = _dense(h * torch.sigmoid(se)[:, None, None, :],
                   self.project_conv.weight, self.project_conv.bias)
        return shortcut + drop_connect(h, self.drop_rate, self.training, rng)


class RelPosAttention(nn.Module):
    """Pre-LN attention inside p×p windows (``grid=False``) or a p×p grid
    (``grid=True``) with its relative-position table, and the residual
    add.  The q, k, v projection runs before the partition and the output
    projection after the un-partition: both act token by token."""

    def __init__(self, dim: int, preset: Preset, grid: bool,
                 drop_rate: float):
        super().__init__()
        p = preset.window
        self.p, self.grid, self.drop_rate = p, grid, drop_rate
        self.heads = dim // preset.head_dim
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_bias = nn.Parameter(torch.zeros(self.heads, 2 * p - 1,
                                                 2 * p - 1))

    def forward(self, x: torch.Tensor, rng: Optional[Rng]) -> torch.Tensor:
        b, h, w, _ = x.shape
        qkv = self.qkv(self.norm(x))
        if self.grid:
            o = relpos_attention(grid_partition(qkv, self.p), self.rel_bias,
                                 self.heads)
            o = grid_unpartition(o, self.p, b, h, w)
        else:
            o = relpos_attention(block_partition(qkv, self.p), self.rel_bias,
                                 self.heads)
            o = block_unpartition(o, self.p, b, h, w)
        return x + drop_connect(self.proj(o), self.drop_rate, self.training,
                                rng)


def _kernel_takes(c: int, f: int) -> bool:
    try:
        check_ln_mlp_kernel_shape(c, f)
    except ValueError:
        return False
    return True


class Mlp(nn.Module):
    """LayerNorm → C→F → GELU → F→C and the residual add; on
    ``fused_ln_mlp`` where the kernel takes C and F (``use_fused_mlp``)."""

    def __init__(self, dim: int, preset: Preset, drop_rate: float):
        super().__init__()
        hidden = dim * preset.mlp_ratio
        self.drop_rate = drop_rate
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.use_fused_mlp = _kernel_takes(dim, hidden)

    def forward(self, x: torch.Tensor, rng: Optional[Rng]) -> torch.Tensor:
        if self.use_fused_mlp:
            out = fused_ln_mlp(
                x.reshape(-1, x.shape[-1]), self.norm.weight, self.norm.bias,
                self.fc1.weight.t(), self.fc1.bias, self.fc2.weight.t(),
                self.fc2.bias, LN_EPS).view(x.shape)
            if not (self.training and self.drop_rate > 0.0):
                return out
            branch = out - x
        else:
            branch = self.fc2(F.gelu(self.fc1(self.norm(x))))
        return x + drop_connect(branch, self.drop_rate, self.training, rng)


_QUIET = contextlib.nullcontext()


class MaxViTBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, preset: Preset,
                 drop_rate: float):
        super().__init__()
        self.mbconv = MBConv(cin, cout, stride, preset, drop_rate)
        self.block_attn = RelPosAttention(cout, preset, False, drop_rate)
        self.block_mlp = Mlp(cout, preset, drop_rate)
        self.grid_attn = RelPosAttention(cout, preset, True, drop_rate)
        self.grid_mlp = Mlp(cout, preset, drop_rate)
        # forwards left that record spans; -1: every one (a remat block is
        # given 1, so its recompute in the backward pass records none)
        self.spans_left = -1

    def forward(self, x: torch.Tensor,
                rng: Optional[Rng] = None) -> torch.Tensor:
        on = self.spans_left != 0
        if self.spans_left > 0:
            self.spans_left -= 1
        span = trace.span if on else (lambda name: _QUIET)
        with span("maxvit.mbconv"):
            x = self.mbconv(x, rng)
        with span("maxvit.block_attn"):
            x = self.block_attn(x, rng)
        x = self.block_mlp(x, rng)
        with span("maxvit.grid_attn"):
            x = self.grid_attn(x, rng)
        return self.grid_mlp(x, rng)


class MaxViT(nn.Module):
    """Feature extractor: NHWC image [B, H, W, 3] → the LayerNorm of the
    last stage's global mean [B, feature_dim] in float32.  H and W must be
    multiples of ``window · 2^(stages + 1)`` (384 for MaxViT-B)."""

    def __init__(self, model_name: str = "maxvit-base",
                 dtype: torch.dtype = torch.float32, remat: str = "none"):
        super().__init__()
        if dtype != torch.float32:
            raise ValueError(f"MaxViT computes in float32, got {dtype}")
        if remat not in REMAT:
            raise ValueError(f"remat must be none|conv|block, got {remat!r}")
        preset = PARAMS[model_name]
        self.model_name, self.preset, self.remat = model_name, preset, remat
        self.stem_conv1 = nn.Conv2d(3, preset.stem, 3, 2)
        self.stem_bn = BatchNorm(preset.stem)
        self.stem_conv2 = nn.Conv2d(preset.stem, preset.stem, 3)
        n = sum(preset.depths)
        blocks, cin = [], preset.stem
        for width, depth in zip(preset.widths, preset.depths):
            for j in range(depth):
                blocks.append(MaxViTBlock(
                    cin, width, 2 if j == 0 else 1, preset,
                    preset.drop_path_rate * len(blocks) / n))
                cin = width
        self.blocks = nn.ModuleList(blocks)
        self.norm = nn.LayerNorm(preset.widths[-1], eps=LN_EPS)

    def forward(self, x: torch.Tensor,
                rng: Optional[Rng] = None) -> torch.Tensor:
        tile = self.preset.window * 2 ** (len(self.preset.widths) + 1)
        if x.shape[1] % tile or x.shape[2] % tile:
            raise ValueError(f"{self.model_name} takes H and W multiples of "
                             f"{tile}, got {tuple(x.shape[1:3])}")
        x = x.float()
        x = conv2d_nhwc(x, self.stem_conv1.weight, self.stem_conv1.bias,
                        stride=2)
        x = conv2d_nhwc(F.gelu(self.stem_bn(x)), self.stem_conv2.weight,
                        self.stem_conv2.bias)
        remat = self.training and torch.is_grad_enabled() and \
            self.remat != "none"
        for block in self.blocks:
            block.spans_left = 1 if remat else -1
            x = remat_block(block, x, rng, self.remat) if remat else \
                block(x, rng)
        return self.norm(x.mean(dim=(1, 2)))
