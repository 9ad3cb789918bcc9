"""Plain float32 forward of the multimodal fusion classifier with a MaxViT
image branch (Tu et al., *MaxViT: Multi-Axis Vision Transformer*, ECCV
2022, arXiv:2204.01697), the branches and head of ``effnet_fusion.Net``.

The backbone: a stem of two 3×3 convs (the first with stride 2), then
blocks of a pre-norm MBConv, block attention, an MLP, grid attention and an
MLP, each a residual branch; attention is ``softmax(QKᵀ/√d + B)·V`` with
``B`` a learned (2p−1)² table a head, indexed by relative position.  A
group's tokens are gathered by flat indices (a p×p window, or p×p tokens
spaced H/p apart), not by the port's reshapes.  The features are the last
stage's global mean and a LayerNorm.  Choices the paper leaves open are the
configuration's ``assumed`` (exact-erf GELU, SE of int(0.25·C_out) with
SiLU, BatchNorm eps 1e-3, LayerNorm eps 1e-5, TF-SAME padding, a 2×2
average pool and a 1×1 conv as the downsampling shortcut, stochastic depth
``drop_path_rate·i/n`` on every branch of block i).

Functional, as ``effnet_fusion.Net``: the parameters are a dict keyed as
the port's state dict; ``train`` uses batch statistics and draws stochastic
depth and dropout from ``rng`` in the port's module order; ``lowp`` rounds
both operands of every convolution and product of the backbone (the lower
precision control).  Imports nothing of the port.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from .effnet_fusion import Net as FusionNet
from .effnet_fusion import Params

LN_EPS = 1e-5


def group_tokens(h: int, w: int, p: int, grid: bool, device) -> torch.Tensor:
    """[groups, p²] flat positions (row·W + col) of each group's tokens in
    row-major order: the p×p windows, or the grid's groups (group (a, b)
    holds rows a + i·H/p and columns b + j·W/p)."""
    a = torch.arange(h // p, device=device)[:, None, None, None]
    b = torch.arange(w // p, device=device)[None, :, None, None]
    i = torch.arange(p, device=device)[None, None, :, None]
    j = torch.arange(p, device=device)[None, None, None, :]
    if grid:
        rows, cols = a + i * (h // p), b + j * (w // p)
    else:
        rows, cols = a * p + i, b * p + j
    return (rows * w + cols).reshape(-1, p * p)


def relative_bias(table: torch.Tensor, p: int) -> torch.Tensor:
    """[heads, p², p²]: B[h, n, m] = table[h, r_n − r_m + p − 1,
    c_n − c_m + p − 1] for tokens n = r_n·p + c_n of a p×p group."""
    idx = torch.arange(p * p, device=table.device)
    r, c = idx // p, idx % p
    return table[:, r[:, None] - r[None, :] + p - 1,
                 c[:, None] - c[None, :] + p - 1]


class Net(FusionNet):
    def __init__(self, cfg: Dict, params: Params,
                 lowp: Optional[Callable] = None):
        self.cfg, self.p = cfg, params
        self.q = lowp or (lambda t: t)

    def nchw(self, x):
        return x.permute(0, 3, 1, 2)

    def nhwc(self, x):
        return x.permute(0, 2, 3, 1)

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"],
                            self.p[f"{name}.bias"], LN_EPS)

    def dense(self, x, name):
        """A Linear on the last dim, both operands through ``lowp``."""
        return F.linear(self.q(x), self.q(self.p[f"{name}.weight"]),
                        self.p[f"{name}.bias"])

    def drop_path(self, x, rate, train, rng):
        if not train or rate == 0.0:
            return x
        keep = 1.0 - rate
        m = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=rng,
                       device=x.device) < keep
        return x / keep * m.to(x.dtype)

    def mbconv(self, x, name, stride, rate, train, rng):
        """x NCHW → NCHW."""
        shortcut = F.avg_pool2d(x, 2) if stride == 2 else x
        if f"{name}.shortcut_conv.weight" in self.p:
            shortcut = self.conv(shortcut, f"{name}.shortcut_conv", bias=True)
        y = self.conv(self.bn(x, f"{name}.pre_bn", train),
                      f"{name}.expand_conv")
        y = F.gelu(self.bn(y, f"{name}.bn1", train))
        y = self.conv(y, f"{name}.dw_conv", stride, groups=y.shape[1])
        y = F.gelu(self.bn(y, f"{name}.bn2", train))
        se = F.silu(self.linear(y.mean(dim=(2, 3)), f"{name}.se_reduce"))
        se = self.linear(se, f"{name}.se_expand")
        y = self.conv(y * torch.sigmoid(se)[:, :, None, None],
                      f"{name}.project_conv", bias=True)
        return shortcut + self.drop_path(y, rate, train, rng)

    def attention(self, x, name, grid, rate, train, rng):
        """x NHWC → NHWC: a block- or grid-attention branch."""
        b, h, w, c = x.shape
        win = self.cfg["window"]
        heads = c // self.cfg["head_dim"]
        d = c // heads
        idx = group_tokens(h, w, win, grid, x.device)
        t = self.ln(x, f"{name}.norm").reshape(b, h * w, c)[:, idx]
        qkv = self.dense(t, f"{name}.qkv")                 # [B, G, N, 3C]
        q, k, v = qkv.unflatten(-1, (3, heads, d)).permute(3, 0, 1, 4, 2, 5)
        s = self.q(q) @ self.q(k).transpose(-1, -2) / math.sqrt(d)
        s = s + relative_bias(self.p[f"{name}.rel_bias"], win)
        o = self.q(torch.softmax(s, dim=-1)) @ self.q(v)   # [B, G, h, N, d]
        o = o.permute(0, 1, 3, 2, 4).reshape(b, -1, c)
        out = torch.zeros(b, h * w, c, dtype=x.dtype, device=x.device)
        out[:, idx.flatten()] = o
        out = self.dense(out, f"{name}.proj").reshape(b, h, w, c)
        return x + self.drop_path(out, rate, train, rng)

    def mlp(self, x, name, rate, train, rng):
        y = F.gelu(self.dense(self.ln(x, f"{name}.norm"), f"{name}.fc1"))
        return x + self.drop_path(self.dense(y, f"{name}.fc2"), rate, train,
                                  rng)

    def backbone(self, img_nhwc, train, rng):
        pre = "image_model."
        cfg = self.cfg
        x = self.conv(self.nchw(img_nhwc), pre + "stem_conv1", 2, bias=True)
        x = F.gelu(self.bn(x, pre + "stem_bn", train))
        x = self.conv(x, pre + "stem_conv2", bias=True)
        n = sum(cfg["depths"])
        i = 0
        for depth in cfg["depths"]:
            for j in range(depth):
                name = f"{pre}blocks.{i}"
                rate = cfg["drop_path_rate"] * i / n
                x = self.mbconv(x, f"{name}.mbconv", 2 if j == 0 else 1,
                                rate, train, rng)
                x = self.nhwc(x)
                x = self.attention(x, f"{name}.block_attn", False, rate,
                                   train, rng)
                x = self.mlp(x, f"{name}.block_mlp", rate, train, rng)
                x = self.attention(x, f"{name}.grid_attn", True, rate, train,
                                   rng)
                x = self.mlp(x, f"{name}.grid_mlp", rate, train, rng)
                x = self.nchw(x)
                i += 1
        return self.ln(x.mean(dim=(2, 3)), pre + "norm")
