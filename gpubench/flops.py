"""The yardstick's arithmetic: the H100's peaks, the least time of each
hand-written kernel's call (its roofline bound), and the operations of a
forward pass counted from a configuration's shapes.

The bound functions are frozen copies of ``chip_smoke.py``'s
``ops_ms``, ``fused_bound_ms``, ``warp_bound_ms``, ``mae_bound_ms`` and
``b10_bound_ms`` (a test holds them to its numbers).  A bound counts the work
the function needs for the call's shapes: each input byte read once, each
output byte written once, each product at the rate of its operands' type.

The FLOP counts take 2 operations a multiply-add of every convolution and
product of the model's forward pass at the configuration's shapes, without
recompute, and leave out elementwise work (norms, activations, pooling);
:func:`train_flops` is three forwards (forward, and the two products of the
backward pass).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# and float32 CUDA-core FLOP/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
PEAK_FLOPS = {"bfloat16": BF16_FLOPS, "float32": F32_FLOPS}


def ops_ms(bf16: float = 0.0, f32: float = 0.0) -> float:
    """Least time of a call's operations: ``bf16`` FLOP of products of bf16
    operands (tensor cores) and ``f32`` FLOP of float32 work (CUDA cores).
    The two pipes run side by side, so the slower one bounds the call."""
    return max(bf16 / BF16_FLOPS, f32 / F32_FLOPS) * 1e3


def fused_bound_ms(geo, bsz=16, esz=2):
    """(bytes ms, operations ms) of one fused-kernel call: x, y, weights and
    pool moved once; the expand on the bf16 tensor cores, the depthwise
    taps as float32 FMAs on the CUDA cores."""
    kind, h, cin, cmid, k = geo
    px = bsz * h * h
    we = cin * cmid if kind == "expand" else 0
    n_bias = 2 * cmid if kind == "expand" else cmid
    nbytes = ((px * (cin + cmid) + we + k * k * cmid) * esz
              + n_bias * 4 + bsz * cmid * 4)
    expand = 2 * px * cin * cmid if kind == "expand" else 0
    taps = 2 * k * k * px * cmid
    return nbytes / HBM_BPS * 1e3, ops_ms(bf16=expand, f32=taps)


def warp_bound_ms(bsz, h, w, c, out_hw):
    """(bytes ms, operations ms) of one warp call: the batch read once, the
    output written once, the affines and flags; about 20 + 7·C float32
    operations per output pixel (coordinates, reflection, blend)."""
    px = bsz * out_hw[0] * out_hw[1]
    nbytes = (bsz * h * w * c + px * c) * 4 + bsz * 25
    return nbytes / HBM_BPS * 1e3, px * (20 + 7 * c) / F32_FLOPS * 1e3


def mae_bound_ms(name, dtype, geo):
    """(bytes ms, operations ms) of one call of a ConvMAE kernel: inputs
    read once, outputs written once; each product at the card's rate for
    its operands' type.  Attention's p·v in bf16 is counted as the two
    tensor-core products the kernel carries it as."""
    bf = dtype == torch.bfloat16
    esz = 2 if bf else 4
    if name == "flash_attention":
        b, h, n, d = geo
        qk = pv = 2 * b * h * n * n * d
        return (4 * b * h * n * d * esz / HBM_BPS * 1e3,
                ops_ms(bf16=qk + 2 * pv) if bf else ops_ms(f32=qk + pv))
    b, hw, c = geo[:3]
    m = b * hw * hw
    if name == "fused_ln_mlp":
        f = 4 * c
        nbytes = 2 * m * c * esz + 2 * c * f * esz + (3 * c + f) * 4
        mm = 4 * m * c * f
        return (nbytes / HBM_BPS * 1e3,
                ops_ms(bf16=mm) if bf else ops_ms(f32=mm))
    nbytes = (2 * m * c * esz + 2 * c * c * esz + 30 * c * 4
              + (m * 4 if geo[3] else 0))
    mm, taps = 4 * m * c * c, 2 * 25 * m * c
    return (nbytes / HBM_BPS * 1e3,
            ops_ms(bf16=mm, f32=taps) if bf else ops_ms(f32=mm + taps))


def b10_bound_ms(dtype, m, c):
    """(bytes ms, operations ms) of one call of the LN-MLP backward: x, g
    read and dx written once, both weights read and their float32 gradients
    written once, the vectors; 10·M·C·F operations (the h recompute, g·w2ᵀ,
    aᵀg, yᵀdh, dh·w1ᵀ) at the rate of their operands' type."""
    esz = 2 if dtype == torch.bfloat16 else 4
    f = 4 * c
    nbytes = (3 * m * c * esz + 2 * c * f * esz + 2 * c * f * 4
              + (6 * c + 2 * f) * 4)
    ops = 10 * m * c * f
    return (nbytes / HBM_BPS * 1e3,
            ops_ms(bf16=ops) if dtype == torch.bfloat16 else ops_ms(f32=ops))


def bound(pair: Tuple[float, float]) -> float:
    """The least time of a call: the larger of its bytes and operations
    times (ms)."""
    return max(pair)


# ------------------------------------------------ EfficientNet-B* fusion

# (expand_ratio, kernel, stride, in_filters, out_filters, num_repeat): the
# B0 base of Tan & Le 2019, Table 1
BASE_BLOCKS = [
    (1, 3, 1, 32, 16, 1),
    (6, 3, 2, 16, 24, 2),
    (6, 5, 2, 24, 40, 2),
    (6, 3, 2, 40, 80, 3),
    (6, 5, 1, 80, 112, 3),
    (6, 5, 2, 112, 192, 4),
    (6, 3, 1, 192, 320, 1),
]


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def effnet_blocks(width: float, depth: float
                  ) -> List[Tuple[int, int, int, int, int]]:
    """Every block's (expand, kernel, stride, in, out) after compound
    scaling."""
    blocks = []
    for expand, kernel, stride, cin, cout, repeat in BASE_BLOCKS:
        cin, cout = round_filters(cin, width), round_filters(cout, width)
        for i in range(int(math.ceil(depth * repeat))):
            blocks.append((expand, kernel, stride if i == 0 else 1,
                           cin if i == 0 else cout, cout))
    return blocks


def serving_geometries(cfg: Dict) -> List[Tuple[str, int, int, int, int]]:
    """(kind, H, Cin, Cmid, K) of every stride-1 MBConv block (the fused
    kernels' calls of one serving forward), in block order."""
    h = -(-cfg["image_size"] // 2)
    out = []
    for expand, k, stride, cin, _ in effnet_blocks(cfg["width_coefficient"],
                                                   cfg["depth_coefficient"]):
        if stride == 1:
            out.append(("dw" if expand == 1 else "expand", h, cin,
                        cin * expand, k))
        else:
            h = -(-h // stride)
    return out


def _mlp_flops(dims: Sequence[int]) -> int:
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def effnet_fusion_flops(cfg: Dict) -> float:
    """Forward FLOPs of one image through the fusion net: the backbone at
    ``image_size``, the four branch MLPs and the fusion head."""
    width = cfg["width_coefficient"]
    h = -(-cfg["image_size"] // 2)
    stem = round_filters(32, width)
    total = 2 * h * h * 9 * 3 * stem
    cout = stem
    for expand, k, stride, cin, cout in effnet_blocks(
            width, cfg["depth_coefficient"]):
        mid = cin * expand
        se = max(1, int(cin * 0.25))
        if expand != 1:
            total += 2 * h * h * cin * mid
        h = -(-h // stride)
        total += 2 * h * h * k * k * mid + 4 * mid * se + 2 * h * h * mid * cout
    head = round_filters(1280, width)
    total += 2 * h * h * cout * head
    shared = cfg["shared_dim"]
    total += _mlp_flops([head, 256, shared])
    total += _mlp_flops([cfg["radiomics_dim"], 256, shared])
    total += _mlp_flops([13, 64, shared])
    total += _mlp_flops([2 * cfg["num_artifact_classes"], 64, shared])
    total += _mlp_flops([4 * shared, 256, cfg["num_classes"]])
    return float(total)


# ---------------------------------------------------------------- ConvMAE

def _conv_block_flops(hw: int, d: int, mlp_ratio: float) -> int:
    f = int(d * mlp_ratio)
    return 2 * hw * hw * (2 * d * d + 25 * d + 2 * d * f)


def _vit_block_flops(n: int, d: int, mlp_ratio: float) -> int:
    f = int(d * mlp_ratio)
    return 2 * n * (4 * d * d + 2 * d * f) + 4 * n * n * d


def convmae_flops(cfg: Dict, mask_ratio: float, decoder: bool) -> float:
    """Forward FLOPs of one image through ConvMAE: the patch embeddings and
    conv stages over every position, the transformer stage over the kept
    tokens, and (``decoder``) the decoder over every token."""
    s = cfg["img_size"]
    d0, d1, d2 = cfg["embed_dims"]
    r = cfg["mlp_ratio"]
    g1, g2, g3 = s // 4, s // 8, s // 16
    n = g3 * g3
    keep = int(round(n * (1.0 - mask_ratio)))
    total = 2 * g1 * g1 * 16 * 3 * d0
    total += cfg["depths"][0] * _conv_block_flops(g1, d0, r)
    total += 2 * g2 * g2 * 4 * d0 * d1
    total += cfg["depths"][1] * _conv_block_flops(g2, d1, r)
    total += 2 * n * 4 * d1 * d2
    total += cfg["depths"][2] * _vit_block_flops(keep, d2, r)
    if decoder:
        dd = cfg["decoder_dim"]
        total += 2 * keep * d2 * dd
        total += cfg["decoder_depth"] * _vit_block_flops(n, dd, r)
        total += 2 * n * dd * 16 * 16 * 3
    return float(total)


def train_flops(forward: float) -> float:
    """A trained image: the forward and a backward of twice its products."""
    return 3.0 * forward
