"""Plain float32 reference of MaxViT (Tu et al., *MaxViT: Multi-Axis Vision
Transformer*, ECCV 2022, arXiv:2204.01697) as the image branch of the
multimodal fusion classifier, and its cross-entropy loss.

Functional, in plain ``torch`` operations: the parameters are a dict keyed
as the port's ``MultiModalFusionNet`` state dict (``image_model.*``,
``image_proj.*``, ...), so one seeded dict feeds both; the architecture is
a dict (``stem``, ``widths``, ``depths``, ``window``, ``head_dim``,
``expansion``, ``se_ratio``, ``mlp_ratio``).  Imports nothing of the port
and no JAX.  ``train`` normalises with batch statistics and draws
stochastic depth and dropout from ``rng`` in module order (one
``rand((B, 1, 1, 1))`` a residual branch whose rate is above 0, then the
branches' dropouts); eval uses the running statistics and draws nothing.

The paper's block: MBConv → block attention → MLP → grid attention → MLP,
each a pre-norm residual branch; attention is ``softmax(QKᵀ/√d + B)·V``
with ``B`` a learned (2p−1)² table a head indexed by relative position.
Groups are gathered here by flat token indices (a window: rows
``r·p .. r·p + p − 1``; a grid group: rows ``a, a + H/p, ...``), not by
reshapes.  Departures from the paper and its code, each a choice it leaves
open or a cut of the fusion net:

- GELU is the exact erf form; SE's inner activation is SiLU, its width
  ``int(0.25·C_out)``;
- BatchNorm eps 1e-3, LayerNorm eps 1e-5; TF-SAME zero padding;
- the shortcut of a stage's first block is a 2×2 average pool, stride 2,
  then a 1×1 conv with bias;
- stochastic depth on every residual branch at ``rate·i/n`` for block
  ``i`` of ``n`` (the same rate on a block's five branches);
- the features are the last stage's global mean and a LayerNorm; the
  pre-logits layer and the classifier are not used (the fusion net's
  branches take the features);
- the fusion head is the intermediate concat one: image, radiomics,
  clinical and artifact MLPs (Linear → LayerNorm eps 1e-6 → ReLU →
  dropout, twice), concatenation, ``fusion_fc1`` → ReLU → dropout 0.4 →
  ``fusion_fc2``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
LN_EPS = 1e-5
FUSION_LN_EPS = 1e-6
Params = Dict[str, torch.Tensor]


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """TF-SAME zero padding of an NCHW tensor."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def conv(p: Params, name: str, x: torch.Tensor, stride: int = 1,
         groups: int = 1) -> torch.Tensor:
    """An NHWC convolution with the OIHW weight ``name.weight`` (and its
    bias where the dict has one)."""
    w = p[f"{name}.weight"]
    y = F.conv2d(same_pad(x.permute(0, 3, 1, 2), w.shape[-1], stride), w,
                 p.get(f"{name}.bias"), stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def bn(p: Params, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    """BatchNorm over the channels of an NHWC tensor."""
    mean = var = None
    if not train:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    y = F.batch_norm(x.permute(0, 3, 1, 2), mean, var, p[f"{name}.weight"],
                     p[f"{name}.bias"], train, 0.0, BN_EPS)
    return y.permute(0, 2, 3, 1)


def ln(p: Params, name: str, x: torch.Tensor, eps: float = LN_EPS):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], eps)


def linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    w = p[f"{name}.weight"]
    return F.linear(x, w.reshape(w.shape[0], -1), p[f"{name}.bias"])


def drop_path(x: torch.Tensor, rate: float, train: bool,
              rng: Optional[torch.Generator]) -> torch.Tensor:
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    m = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=rng,
                   device=x.device) < keep
    return x / keep * m.to(x.dtype)


def dropout(x: torch.Tensor, rate: float, train: bool,
            rng: Optional[torch.Generator]) -> torch.Tensor:
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    m = torch.rand(x.shape, generator=rng, device=x.device) < keep
    return torch.where(m, x / keep, torch.zeros_like(x))


def group_tokens(h: int, w: int, p: int, grid: bool,
                 device) -> torch.Tensor:
    """[groups, p²] flat positions (row·W + col) of each group's tokens in
    row-major order: the p×p windows, or the p×p grid's groups (group
    (a, b) holds rows a + i·H/p and columns b + j·W/p)."""
    out = []
    for a in range(h // p):
        for b in range(w // p):
            if grid:
                rows = [a + i * (h // p) for i in range(p)]
                cols = [b + j * (w // p) for j in range(p)]
            else:
                rows = [a * p + i for i in range(p)]
                cols = [b * p + j for j in range(p)]
            out.append([r * w + c for r in rows for c in cols])
    return torch.tensor(out, device=device)


def relative_bias(table: torch.Tensor, p: int) -> torch.Tensor:
    """[heads, p², p²]: B[h, n, m] = table[h, r_n − r_m + p − 1,
    c_n − c_m + p − 1] for tokens n = r_n·p + c_n of a p×p group."""
    idx = torch.arange(p * p, device=table.device)
    r, c = idx // p, idx % p
    return table[:, r[:, None] - r[None, :] + p - 1,
                 c[:, None] - c[None, :] + p - 1]


def attention(p: Params, name: str, x: torch.Tensor, arch: Dict,
              grid: bool, rate: float, train: bool, rng) -> torch.Tensor:
    """A block- or grid-attention branch and its residual add."""
    b, h, w, c = x.shape
    win = arch["window"]
    heads = c // arch["head_dim"]
    d = c // heads
    idx = group_tokens(h, w, win, grid, x.device)
    t = ln(p, f"{name}.norm", x).reshape(b, h * w, c)[:, idx]  # [B, G, N, C]
    qkv = linear(p, f"{name}.qkv", t)
    qq, kk, vv = qkv.unflatten(-1, (3, heads, d)).permute(3, 0, 1, 4, 2, 5)
    s = qq @ kk.transpose(-1, -2) / math.sqrt(d)           # [B, G, h, N, N]
    s = s + relative_bias(p[f"{name}.rel_bias"], win)
    o = torch.softmax(s, dim=-1) @ vv                      # [B, G, h, N, d]
    o = o.permute(0, 1, 3, 2, 4).reshape(b, -1, c)
    out = torch.zeros(b, h * w, c, dtype=x.dtype, device=x.device)
    out[:, idx.flatten()] = o
    out = linear(p, f"{name}.proj", out).reshape(b, h, w, c)
    return x + drop_path(out, rate, train, rng)


def mlp(p: Params, name: str, x: torch.Tensor, rate: float, train: bool,
        rng) -> torch.Tensor:
    y = F.gelu(linear(p, f"{name}.fc1", ln(p, f"{name}.norm", x)))
    return x + drop_path(linear(p, f"{name}.fc2", y), rate, train, rng)


def mbconv(p: Params, name: str, x: torch.Tensor, stride: int, rate: float,
           train: bool, rng) -> torch.Tensor:
    shortcut = x
    if stride == 2:
        shortcut = F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    if f"{name}.shortcut_conv.weight" in p:
        shortcut = conv(p, f"{name}.shortcut_conv", shortcut)
    y = conv(p, f"{name}.expand_conv", bn(p, f"{name}.pre_bn", x, train))
    y = F.gelu(bn(p, f"{name}.bn1", y, train))
    y = conv(p, f"{name}.dw_conv", y, stride, y.shape[-1])
    y = F.gelu(bn(p, f"{name}.bn2", y, train))
    se = F.silu(linear(p, f"{name}.se_reduce", y.mean(dim=(1, 2))))
    se = linear(p, f"{name}.se_expand", se)
    y = conv(p, f"{name}.project_conv", y * torch.sigmoid(se)[:, None, None, :])
    return shortcut + drop_path(y, rate, train, rng)


def backbone(p: Params, arch: Dict, img: torch.Tensor, train: bool = False,
             rng: Optional[torch.Generator] = None,
             drop_path_rate: float = 0.2, prefix: str = "image_model."
             ) -> torch.Tensor:
    """img [B, H, W, 3] → [B, widths[-1]] features."""
    x = conv(p, prefix + "stem_conv1", img, 2)
    x = conv(p, prefix + "stem_conv2", F.gelu(bn(p, prefix + "stem_bn", x,
                                                 train)))
    n = sum(arch["depths"])
    i = 0
    for depth in arch["depths"]:
        for j in range(depth):
            name = f"{prefix}blocks.{i}"
            rate = drop_path_rate * i / n
            x = mbconv(p, f"{name}.mbconv", x, 2 if j == 0 else 1, rate,
                       train, rng)
            x = attention(p, f"{name}.block_attn", x, arch, False, rate,
                          train, rng)
            x = mlp(p, f"{name}.block_mlp", x, rate, train, rng)
            x = attention(p, f"{name}.grid_attn", x, arch, True, rate, train,
                          rng)
            x = mlp(p, f"{name}.grid_mlp", x, rate, train, rng)
            i += 1
    return ln(p, prefix + "norm", x.mean(dim=(1, 2)))


def proj(p: Params, name: str, x: torch.Tensor, drop1: float, drop2: float,
         train: bool, rng) -> torch.Tensor:
    for i, rate in ((1, drop1), (2, drop2)):
        x = ln(p, f"{name}.ln{i}", linear(p, f"{name}.fc{i}", x),
               FUSION_LN_EPS)
        x = dropout(F.relu(x), rate, train, rng)
    return x


def fusion_logits(p: Params, arch: Dict, batch: Dict[str, torch.Tensor],
                  train: bool = False, rng: Optional[torch.Generator] = None,
                  num_artifact_classes: int = 6) -> torch.Tensor:
    """batch: ``image`` [B, H, W, 3] float32 (preprocessed), ``radiomics``,
    ``age``, ``sex``, ``loc``, ``artifacts`` → logits [B, classes]."""
    feats = [proj(p, "image_proj", backbone(p, arch, batch["image"], train,
                                            rng), 0.3, 0.2, train, rng),
             proj(p, "radiomics_mlp", batch["radiomics"], 0.4, 0.3, train,
                  rng)]
    clin = torch.cat([batch["age"][:, None].float(),
                      p["sex_emb.weight"][batch["sex"].long()],
                      p["loc_emb.weight"][batch["loc"].long()]], dim=1)
    feats.append(proj(p, "clinical_mlp", clin, 0.2, 0.2, train, rng))
    arts = torch.cat([p[f"artifact_emb_{i}.weight"][batch["artifacts"][:, i]
                                                    .long()]
                      for i in range(num_artifact_classes)], dim=1)
    feats.append(proj(p, "artifact_mlp", arts, 0.2, 0.2, train, rng))
    x = F.relu(linear(p, "fusion_fc1", torch.cat(feats, dim=1)))
    return linear(p, "fusion_fc2", dropout(x, 0.4, train, rng))


def loss(p: Params, arch: Dict, batch: Dict[str, torch.Tensor],
         train: bool = True, rng: Optional[torch.Generator] = None
         ) -> torch.Tensor:
    return F.cross_entropy(fusion_logits(p, arch, batch, train, rng),
                           batch["target"].long())
