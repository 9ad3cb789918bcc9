"""GLSZM / GLDM / NGTDM / shape2D feature classes, batched over maps.

Counterpart of ``multimodal_isic_tpu/ops/texture_extra.py``: 16 GLSZM, 14
GLDM and 5 NGTDM features per map (``[M, H, W]`` in, ``[M]`` out) and the 9
shape2D features per mask.  The JAX one-hot reductions become counts with a
per-map key offset (``texture.bincount``); GLSZM keeps the JAX sort-based
zone table, batched along the last dim.  GLSZM's zones come from
``ops.connected_components`` (the kernel wrapper with ``use_kernels``, else
the plain hooking loop).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .connected_components import (NEIGH8, connected_components,
                                   connected_components_reference)
from .texture import EPS, NG, _f32, bincount, map_offsets, shift2d


def _seg_bounds(start: torch.Tensor, is_end: torch.Tensor):
    """Per sorted position, the index of its segment's first and last
    element (forward cummax of starts, reverse cummin of ends)."""
    n = start.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=start.device).expand_as(start)
    first = torch.cummax(torch.where(start, idx, -1), dim=-1).values
    last = torch.cummin(torch.where(is_end, idx, n).flip(-1), dim=-1).values.flip(-1)
    return first, last


def _edges(keys: torch.Tensor, valid: torch.Tensor):
    """Start and end flags of runs of equal keys along the last dim."""
    ones = torch.ones_like(keys[..., :1], dtype=torch.bool)
    start = torch.cat([ones, keys[..., 1:] != keys[..., :-1]], -1) & valid
    is_end = torch.cat([keys[..., :-1] != keys[..., 1:], ones], -1) & valid
    return start, is_end


# ==================================================================== GLSZM

def glszm_features(levels: torch.Tensor, mask: torch.Tensor,
                   n_levels: torch.Tensor,
                   use_kernels: bool = False) -> Dict[str, torch.Tensor]:
    """16 pyradiomics GLSZM features of each map from same-level
    8-connected zones (texture_extra.py:88-195)."""
    inside = mask > 0
    m, h, w = levels.shape
    # the sort-based zone grouping packs (label, gray) into one int32 key:
    # label·(NG+1)+gray must stay below 2³¹ or zones silently scramble
    if h * w * (NG + 1) >= 2 ** 31:
        raise ValueError(f"glszm key packing overflows int32 for {h}x{w} "
                         f"images (h*w*(NG+1) = {h * w * (NG + 1)} >= 2^31)")
    dims = (-2, -1)
    n_p = torch.clamp(inside.sum(dim=dims).float(), min=1.0)
    cc = connected_components if use_kernels else connected_components_reference
    label = cc(levels, inside)
    big = n = h * w

    # zone table: sort the packed (label, gray) key of every pixel; a zone
    # is a run of equal keys, its size the run's length, its gray the residue
    key = torch.where(inside, label * (NG + 1) + levels, big * (NG + 1))
    sk = torch.sort(key.view(m, n), dim=-1).values
    gray_i = sk % (NG + 1)
    gray_s = gray_i.float()
    valid = sk < big * (NG + 1)
    start, is_end = _edges(sk, valid)
    first, last = _seg_bounds(start, is_end)
    size_s = (last - first + 1).float()    # zone size at each of its positions

    zval = start.float()                    # one entry per zone (its start)
    nz = torch.clamp(zval.sum(-1), min=1.0)
    g, s = gray_s, size_s

    sae = (zval / torch.clamp(s, min=1.0) ** 2).sum(-1) / nz
    lae = (zval * s ** 2).sum(-1) / nz
    # per-gray zone counts
    gkey = torch.where(start & (gray_i >= 1),
                       gray_i - 1 + map_offsets(m, NG, sk.device)[:, :, 0],
                       m * NG)
    pg = bincount(gkey, m * NG).view(m, NG)
    gln = (pg ** 2).sum(-1) / nz
    glnn = (pg ** 2).sum(-1) / nz ** 2
    # per-(size, gray) and per-size zone counts from one more sort of the
    # zones' (size, gray) keys
    zkey = torch.where(start, size_s.to(torch.int32) * (NG + 1) + gray_i,
                       (big + 2) * (NG + 1))
    zs = torch.sort(zkey, dim=-1).values
    zvalid = zs < (big + 2) * (NG + 1)
    gs_start, gs_end = _edges(zs, zvalid)
    gs_s, gs_e = _seg_bounds(gs_start, gs_end)
    n_gs = (gs_e - gs_s + 1).float()        # N(gray, size) per run
    zsize = torch.div(zs, NG + 1, rounding_mode="floor")
    sz_start, sz_end = _edges(zsize, zvalid)
    sz_s, sz_e = _seg_bounds(sz_start, sz_end)
    n_sz = (sz_e - sz_s + 1).float()        # N(size) per run
    zero = _f32(0.0, n_sz)
    szn = torch.where(sz_start, n_sz ** 2, zero).sum(-1) / nz
    sznn = szn / nz
    zp = nz / n_p
    mu_g = (zval * g).sum(-1) / nz
    glv = (zval * (g - mu_g[:, None]) ** 2).sum(-1) / nz
    mu_s = (zval * s).sum(-1) / nz
    zv = (zval * (s - mu_s[:, None]) ** 2).sum(-1) / nz
    p_gs = n_gs / nz[:, None]
    ze = -torch.where(gs_start, p_gs * torch.log2(p_gs + EPS), zero).sum(-1)
    return {
        "SmallAreaEmphasis": sae,
        "LargeAreaEmphasis": lae,
        "GrayLevelNonUniformity": gln,
        "GrayLevelNonUniformityNormalized": glnn,
        "SizeZoneNonUniformity": szn,
        "SizeZoneNonUniformityNormalized": sznn,
        "ZonePercentage": zp,
        "GrayLevelVariance": glv,
        "ZoneVariance": zv,
        "ZoneEntropy": ze,
        "LowGrayLevelZoneEmphasis":
            (zval / torch.clamp(g, min=1.0) ** 2).sum(-1) / nz,
        "HighGrayLevelZoneEmphasis": (zval * g ** 2).sum(-1) / nz,
        "SmallAreaLowGrayLevelEmphasis":
            (zval / torch.clamp(g * s, min=1.0) ** 2).sum(-1) / nz,
        "SmallAreaHighGrayLevelEmphasis":
            (zval * g ** 2 / torch.clamp(s, min=1.0) ** 2).sum(-1) / nz,
        "LargeAreaLowGrayLevelEmphasis":
            (zval * s ** 2 / torch.clamp(g, min=1.0) ** 2).sum(-1) / nz,
        "LargeAreaHighGrayLevelEmphasis": (zval * s ** 2 * g ** 2).sum(-1) / nz,
    }


# ===================================================================== GLDM

def gldm_features(levels: torch.Tensor, mask: torch.Tensor,
                  n_levels: torch.Tensor,
                  alpha: float = 0.0) -> Dict[str, torch.Tensor]:
    """14 pyradiomics GLDM features of each map (texture_extra.py:200-262);
    dependence j = 1 + #(8-neighbours inside the ROI with |gray difference|
    ≤ α)."""
    inside = mask > 0
    m = levels.shape[0]
    dims = (-2, -1)
    dep = torch.zeros_like(levels)
    for dy, dx in NEIGH8:
        ng = shift2d(levels, dy, dx, -(10 ** 6))
        nin = shift2d(inside, dy, dx, False)
        dep = dep + (inside & nin & ((ng - levels).abs() <= alpha)).to(dep.dtype)
    nd = 9
    ok = inside & (levels >= 1) & (levels <= NG)
    key = torch.where(ok, map_offsets(m, NG * nd, levels.device)
                      + (levels - 1) * nd + dep, m * NG * nd)
    P = bincount(key, m * NG * nd).view(m, NG, nd)

    dev = levels.device
    nz = torch.clamp(P.sum(dim=dims), min=1.0)
    i_vals = torch.arange(1, NG + 1, dtype=torch.float32, device=dev)
    j_vals = torch.arange(1, nd + 1, dtype=torch.float32, device=dev)
    pg = P.sum(-1)
    pd = P.sum(-2)
    p = P / nz[:, None, None]
    ii, jj = i_vals[:, None], j_vals[None, :]
    mu_g = (i_vals * pg).sum(-1) / nz
    mu_d = (j_vals * pd).sum(-1) / nz
    return {
        "SmallDependenceEmphasis": (pd / j_vals ** 2).sum(-1) / nz,
        "LargeDependenceEmphasis": (pd * j_vals ** 2).sum(-1) / nz,
        "GrayLevelNonUniformity": (pg ** 2).sum(-1) / nz,
        "DependenceNonUniformity": (pd ** 2).sum(-1) / nz,
        "DependenceNonUniformityNormalized": (pd ** 2).sum(-1) / nz ** 2,
        "GrayLevelVariance": ((i_vals - mu_g[:, None]) ** 2 * pg).sum(-1) / nz,
        "DependenceVariance": ((j_vals - mu_d[:, None]) ** 2 * pd).sum(-1) / nz,
        "DependenceEntropy": -(p * torch.log2(p + EPS)).sum(dim=dims),
        "LowGrayLevelEmphasis": (pg / i_vals ** 2).sum(-1) / nz,
        "HighGrayLevelEmphasis": (pg * i_vals ** 2).sum(-1) / nz,
        "SmallDependenceLowGrayLevelEmphasis":
            (P / (ii ** 2 * jj ** 2)).sum(dim=dims) / nz,
        "SmallDependenceHighGrayLevelEmphasis":
            (P * ii ** 2 / jj ** 2).sum(dim=dims) / nz,
        "LargeDependenceLowGrayLevelEmphasis":
            (P * jj ** 2 / ii ** 2).sum(dim=dims) / nz,
        "LargeDependenceHighGrayLevelEmphasis":
            (P * ii ** 2 * jj ** 2).sum(dim=dims) / nz,
    }


# ==================================================================== NGTDM

def ngtdm_features(levels: torch.Tensor, mask: torch.Tensor,
                   n_levels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """5 pyradiomics NGTDM features of each map (texture_extra.py:267-326):
    Coarseness, Contrast, Busyness, Complexity, Strength."""
    inside = mask > 0
    m = levels.shape[0]
    lvf = levels.float()
    zero = _f32(0.0, lvf)
    nbr_sum = torch.zeros_like(lvf)
    nbr_cnt = torch.zeros_like(lvf)
    for dy, dx in NEIGH8:
        ng = shift2d(lvf, dy, dx, 0.0)
        nin = shift2d(inside, dy, dx, False)
        nbr_sum = nbr_sum + torch.where(nin, ng, zero)
        nbr_cnt = nbr_cnt + nin.float()
    has_nbr = inside & (nbr_cnt > 0)
    a_bar = nbr_sum / torch.clamp(nbr_cnt, min=1.0)
    diff = torch.where(has_nbr, (lvf - a_bar).abs(), zero)

    ok = has_nbr & (levels >= 1) & (levels <= NG)
    key = torch.where(ok, map_offsets(m, NG, levels.device) + levels - 1,
                      m * NG)
    n_i = bincount(key, m * NG).view(m, NG)
    s_i = bincount(key, m * NG, weights=diff).view(m, NG)
    n_vp = torch.clamp(n_i.sum(-1), min=1.0)
    p_i = n_i / n_vp[:, None]
    i_vals = torch.arange(1, NG + 1, dtype=torch.float32, device=levels.device)
    present = p_i > 0
    ngp = torch.clamp(present.sum(-1).float(), min=1.0)
    pi_, pj = p_i[:, :, None], p_i[:, None, :]
    si_, sj = s_i[:, :, None], s_i[:, None, :]
    di = i_vals[:, None] - i_vals[None, :]
    both = present[:, :, None] & present[:, None, :]

    coarse_den = (p_i * s_i).sum(-1)
    coarseness = torch.where(coarse_den > 0, 1.0 / coarse_den,
                             _f32(10.0 ** 6, coarse_den))
    pij_diff2 = pi_ * pj * di ** 2
    contrast = torch.where(
        ngp > 1,
        pij_diff2.sum(dim=(-2, -1)) / (ngp * (ngp - 1.0) + EPS)
        * s_i.sum(-1) / n_vp, zero)
    busy_den = (i_vals[:, None] * pi_ - i_vals[None, :] * pj).abs()
    busy_den = torch.where(both, busy_den, zero).sum(dim=(-2, -1))
    busyness = torch.where(busy_den > 0, (p_i * s_i).sum(-1) / busy_den, zero)
    comp_num = di.abs() * torch.where(
        both, (pi_ * si_ + pj * sj) / torch.clamp(pi_ + pj, min=EPS), zero)
    complexity = comp_num.sum(dim=(-2, -1)) / n_vp
    strength_num = torch.where(both, (pi_ + pj) * di ** 2, zero).sum(dim=(-2, -1))
    s_sum = s_i.sum(-1)
    strength = torch.where(s_sum > 0, strength_num / s_sum, zero)
    return {
        "Coarseness": coarseness,
        "Contrast": contrast,
        "Busyness": busyness,
        "Complexity": complexity,
        "Strength": strength,
    }


# =================================================================== shape2D

# marching-squares lookup: per 2×2 corner case (bit order: TL=1, TR=2, BR=4,
# BL=8), the enclosed area inside the cell and the iso-contour length, with
# crossings at edge midpoints
_MS_AREA = (0.0, 0.125, 0.125, 0.5, 0.125, 0.25, 0.5, 0.875,
            0.125, 0.5, 0.25, 0.875, 0.5, 0.875, 0.875, 1.0)
_SQ2H = 0.7071067811865476
_MS_PERIM = (0.0, _SQ2H, _SQ2H, 1.0, _SQ2H, 2 * _SQ2H, 1.0, _SQ2H,
             _SQ2H, 1.0, 2 * _SQ2H, _SQ2H, 1.0, _SQ2H, _SQ2H, 0.0)


def shape2d_features(mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The 9 default pyradiomics shape2D features of each mask [B, H, W]
    (texture_extra.py:341-408): marching-squares area and perimeter, the
    second-moment axes, and the maximum diameter over the boundary mesh's
    vertices (per-row extremes)."""
    inside = (mask > 0).float()
    b, h, w = inside.shape
    dev = inside.device
    dims = (-2, -1)
    n_pix = torch.clamp(inside.sum(dim=dims), min=1.0)

    padded = torch.nn.functional.pad(inside, (1, 1, 1, 1))
    case = (padded[:, :-1, :-1] + 2 * padded[:, :-1, 1:]
            + 4 * padded[:, 1:, 1:] + 8 * padded[:, 1:, :-1]).long()
    area = torch.tensor(_MS_AREA, dtype=torch.float32, device=dev)[case].sum(dim=dims)
    perim = torch.tensor(_MS_PERIM, dtype=torch.float32, device=dev)[case].sum(dim=dims)

    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] * torch.ones(1, w, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] * torch.ones(h, 1, device=dev)
    my = (inside * ys).sum(dim=dims) / n_pix
    mx = (inside * xs).sum(dim=dims) / n_pix
    dy_ = ys - my[:, None, None]
    dx_ = xs - mx[:, None, None]
    cyy = (inside * dy_ ** 2).sum(dim=dims) / n_pix
    cxx = (inside * dx_ ** 2).sum(dim=dims) / n_pix
    cxy = (inside * dy_ * dx_).sum(dim=dims) / n_pix
    cov = torch.stack([torch.stack([cyy, cxy], -1),
                       torch.stack([cxy, cxx], -1)], -2)
    eigs = torch.linalg.eigvalsh(cov)       # ascending
    zero = _f32(0.0, eigs)
    major = 4.0 * torch.sqrt(torch.clamp(eigs[:, 1], min=0.0))
    minor = 4.0 * torch.sqrt(torch.clamp(eigs[:, 0], min=0.0))
    elongation = torch.sqrt(torch.clamp(eigs[:, 0], min=0.0)
                            / torch.clamp(eigs[:, 1], min=EPS))

    # maximum diameter over the marching-squares vertices: midpoints of the
    # 4-adjacent pixel pairs (padding included) whose inside values differ;
    # each row's extreme x suffices
    hcross = padded[:, :, :-1] != padded[:, :, 1:]   # [b, h+2, w+1]
    vcross = padded[:, :-1, :] != padded[:, 1:, :]   # [b, h+1, w+2]
    inf = _f32(math.inf, eigs)
    hx = torch.arange(w + 1, dtype=torch.float32, device=dev) - 0.5
    vx = torch.arange(w + 2, dtype=torch.float32, device=dev) - 1.0
    h_min = torch.where(hcross, hx, inf).amin(-1)
    h_max = torch.where(hcross, hx, -inf).amax(-1)
    v_min = torch.where(vcross, vx, inf).amin(-1)
    v_max = torch.where(vcross, vx, -inf).amax(-1)
    hy = torch.arange(h + 2, dtype=torch.float32, device=dev) - 1.0
    vy = torch.arange(h + 1, dtype=torch.float32, device=dev) - 0.5
    pts_y = torch.cat([hy, hy, vy, vy]).expand(b, -1)
    pts_x = torch.cat([h_min, h_max, v_min, v_max], -1)
    valid = torch.isfinite(pts_x)
    px = torch.where(valid, pts_x, zero)
    py = torch.where(valid, pts_y, zero)
    d2 = ((px[:, :, None] - px[:, None, :]) ** 2
          + (py[:, :, None] - py[:, None, :]) ** 2)
    d2 = torch.where(valid[:, :, None] & valid[:, None, :], d2, zero)
    max_diam = torch.sqrt(d2.amax(dim=dims))

    sphericity = 2.0 * torch.sqrt(math.pi * area) / torch.clamp(perim, min=EPS)
    return {
        "MeshSurface": area,
        "PixelSurface": n_pix,
        "Perimeter": perim,
        "PerimeterSurfaceRatio": perim / torch.clamp(area, min=EPS),
        "Sphericity": sphericity,
        "MaximumDiameter": max_diam,
        "MajorAxisLength": major,
        "MinorAxisLength": minor,
        "Elongation": elongation,
    }
