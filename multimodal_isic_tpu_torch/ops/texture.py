"""Radiomics texture features on masked ROIs, batched over maps.

Counterpart of ``multimodal_isic_tpu/ops/texture.py``: fixed-bin-width
discretization, GLCM (24 features), GLRLM (16) and first order (18), with
the pyradiomics/IBSI conventions of the JAX package (bin edges anchored at
multiples of the bin width, force2D distance-1 angles, symmetrical GLCM,
per-angle values averaged, the same NaN and degenerate-ROI results).

Every function takes a batch of maps, ``[M, H, W]`` in, one value per map
``[M]`` out: the JAX ``vmap`` written out as a batch dimension.  The JAX
package's one-hot contractions (scatter-free forms for the TPU) become
counts with a per-map key offset (:func:`bincount`), which give the same
integers without a [M·H·W, NG] one-hot in memory.

The co-occurrence matrices, the run bookkeeping and the run histogram go
through the kernel wrappers of ``ops.glcm``, ``ops.glrlm_runs`` and
``ops.histogram`` when ``use_kernels`` is set (on a CUDA tensor they launch
the hand-written kernels, on a CPU tensor they run their plain versions),
else straight through the plain versions.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

# static upper bound on discretized gray levels (texture.py:29)
NG = 64
EPS = float(torch.finfo(torch.float32).eps)

# in-plane distance-1 angles under force2D: (dy, dx) of the "positive"
# direction; the symmetric GLCM adds the mirror
ANGLES_2D = ((0, 1), (1, -1), (1, 0), (1, 1))

_BIG = 3.4e38


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim float32 tensor on ``like``'s device, for true division (on
    CUDA PyTorch computes ``x / python_scalar`` as ``x * (1 / scalar)``)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def bincount(keys: torch.Tensor, n: int,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float32 [n]: the count (or ``weights`` sum) of each key in [0, n);
    key ``n`` is the sentinel for "not counted".  The counted keys are
    selected first (one device sync): most pixels of a map lie outside the
    ROI, and adding them all to one sentinel bin serialises the atomics of
    ``index_add_`` on the card (on an H100, 1.8 s of a 2.3 s chunk of 16
    images).  Integer counts are exact in float32 below 2²⁴."""
    flat = keys.reshape(-1)
    sel = flat < n
    idx = flat[sel].long()
    src = (torch.ones(idx.shape, dtype=torch.float32, device=keys.device)
           if weights is None else weights.reshape(-1)[sel].float())
    out = torch.zeros(n, dtype=torch.float32, device=keys.device)
    return out.index_add_(0, idx, src)


def map_offsets(m: int, stride: int, device) -> torch.Tensor:
    """[M, 1, 1] key offset of each map: map i owns keys [i·stride, (i+1)·stride)."""
    return (torch.arange(m, device=device) * stride).view(m, 1, 1)


def shift2d(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """x shifted by (dy, dx) over its last two dims, vacated cells filled:
    result[..., p] = x[..., p − (dy, dx)] (texture.py:250-262)."""
    h, w = x.shape[-2:]
    out = torch.full_like(x, fill)
    ys, yd = slice(max(-dy, 0), h - max(dy, 0)), slice(max(dy, 0), h - max(-dy, 0))
    xs, xd = slice(max(-dx, 0), w - max(dx, 0)), slice(max(dx, 0), w - max(-dx, 0))
    if ys.start < ys.stop and xs.start < xs.stop:
        out[..., yd, xd] = x[..., ys, xs]
    return out


def discretize(image: torch.Tensor, mask: torch.Tensor, bin_width: float):
    """Fixed-bin-width discretization of [M, H, W] maps (texture.py:37-60):
    level = floor(x / w) − floor(min / w) + 1, clamped into 1..n_levels,
    n_levels ≤ NG (wider ROIs saturate into the top bin) → (levels int32
    [M, H, W], 0 outside the ROI; n_levels int32 [M]; lowest edge [M])."""
    inside = mask > 0
    bw = _f32(bin_width, image)
    roi_min = torch.where(inside, image, _f32(_BIG, image)).amin(dim=(-2, -1))
    roi_max = torch.where(inside, image, _f32(-_BIG, image)).amax(dim=(-2, -1))
    low = torch.floor(roi_min / bw)
    lv = torch.floor(image / bw) - low[:, None, None] + 1.0
    n_levels = torch.clamp(torch.floor(roi_max / bw) - low + 1.0, max=float(NG))
    lv = torch.minimum(torch.clamp(lv, min=1.0), n_levels[:, None, None])
    levels = torch.where(inside, lv, 0.0).to(torch.int32)
    # an empty ROI gives n_levels ≈ -6.8e37: saturate the conversion to
    # int32 (as XLA does) instead of leaving it to the platform
    n_int = torch.clamp(n_levels, min=-2.0 ** 31).to(torch.int32)
    return levels, n_int, low * bw


def _level_valid(n_levels: torch.Tensor, count: int = NG) -> torch.Tensor:
    """[M, count] float: 1 where gray value i = 1..count ≤ n_levels."""
    i_vals = torch.arange(1, count + 1, dtype=torch.float32,
                          device=n_levels.device)
    return (i_vals <= n_levels.float()[:, None]).float()


def _entropy(p: torch.Tensor, dims) -> torch.Tensor:
    return -(p * torch.log2(p + EPS)).sum(dim=dims)


# ===================================================================== GLCM

def glcm_features(levels: torch.Tensor, mask: torch.Tensor,
                  n_levels: torch.Tensor,
                  use_kernels: bool = False) -> Dict[str, torch.Tensor]:
    """The 24 pyradiomics GLCM features of each map, averaged over the 4
    angles (texture.py:107-245).  Gray values are the 1-based level indices,
    masked to the first ``n_levels``.  MCC: √ of the second eigenvalue of Q
    by 96 steps of deflated power iteration, as the JAX package."""
    from . import glcm as G
    raw = (G.glcm_matrices if use_kernels else G.glcm_matrices_reference)(
        levels, mask)                                        # [M, 4, NG, NG]
    dev = levels.device
    i_vals = torch.arange(1, NG + 1, dtype=torch.float32, device=dev)
    lvl_valid = _level_valid(n_levels)
    pair_valid = lvl_valid[:, :, None] * lvl_valid[:, None, :]
    raw = raw * pair_valid[:, None]

    P = raw
    n = torch.clamp(P.sum(dim=(-2, -1), keepdim=True), min=1.0)
    p = P / n
    px = p.sum(dim=-1)                      # [M, 4, NG] marginal over j
    py = p.sum(dim=-2)
    ux = (i_vals * px).sum(-1)              # [M, 4]
    uy = (i_vals * py).sum(-1)
    sigx = torch.sqrt(torch.clamp(((i_vals - ux[..., None]) ** 2 * px).sum(-1), min=0.0))
    sigy = torch.sqrt(torch.clamp(((i_vals - uy[..., None]) ** 2 * py).sum(-1), min=0.0))

    ii = i_vals[:, None]
    jj = i_vals[None, :]
    ksum = (ii + jj).long()                 # 2..2NG
    kdiff = (ii - jj).abs().long()          # 0..NG-1
    # p_{x+y} and p_{x-y}: sums of p over anti-diagonals / |i-j| bands, as
    # products with 0/1 selection matrices (exact selections; full f32)
    sel_sum = torch.zeros(NG * NG, 2 * NG + 1, device=dev)
    sel_sum[torch.arange(NG * NG, device=dev), ksum.reshape(-1)] = 1.0
    sel_diff = torch.zeros(NG * NG, NG, device=dev)
    sel_diff[torch.arange(NG * NG, device=dev), kdiff.reshape(-1)] = 1.0
    p_flat = p.reshape(*p.shape[:2], NG * NG)
    pxy_sum = p_flat @ sel_sum              # [M, 4, 2NG+1]
    pxy_diff = p_flat @ sel_diff            # [M, 4, NG]
    k_sum_vals = torch.arange(2 * NG + 1, dtype=torch.float32, device=dev)
    k_diff_vals = torch.arange(NG, dtype=torch.float32, device=dev)

    hxy = _entropy(p, (-2, -1))
    hx = _entropy(px, -1)
    hy = _entropy(py, -1)
    pxpy = px[..., :, None] * py[..., None, :]
    hxy1 = -(p * torch.log2(pxpy + EPS)).sum(dim=(-2, -1))
    hxy2 = _entropy(pxpy, (-2, -1))

    contrast = ((ii - jj) ** 2 * p).sum(dim=(-2, -1))
    dissim_avg = (k_diff_vals * pxy_diff).sum(-1)
    dvar = ((k_diff_vals - dissim_avg[..., None]) ** 2 * pxy_diff).sum(-1)
    dentropy = _entropy(pxy_diff, -1)
    sum_avg = (k_sum_vals * pxy_sum).sum(-1)
    sentropy = _entropy(pxy_sum, -1)

    autocorr = (ii * jj * p).sum(dim=(-2, -1))
    cluster = ii + jj - ux[..., None, None] - uy[..., None, None]
    cl_tend = (cluster ** 2 * p).sum(dim=(-2, -1))
    cl_shade = (cluster ** 3 * p).sum(dim=(-2, -1))
    cl_prom = (cluster ** 4 * p).sum(dim=(-2, -1))
    corr_den = sigx * sigy
    corr_num = ((ii - ux[..., None, None]) * (jj - uy[..., None, None]) * p
                ).sum(dim=(-2, -1))
    correlation = torch.where(corr_den > 0, corr_num / (corr_den + EPS),
                              _f32(1.0, p))

    id_ = (pxy_diff * (1.0 / (1.0 + k_diff_vals))).sum(-1)
    idm = (pxy_diff / (1.0 + k_diff_vals ** 2)).sum(-1)
    ng_f = torch.clamp(n_levels.float(), min=1.0)[:, None, None]   # [M, 1, 1]
    idmn = (pxy_diff / (1.0 + (k_diff_vals / ng_f) ** 2)).sum(-1)
    idn = (pxy_diff / (1.0 + k_diff_vals / ng_f)).sum(-1)
    inv_var = torch.where(
        kdiff > 0, p / torch.clamp(kdiff.float() ** 2, min=1.0),
        _f32(0.0, p)).sum(dim=(-2, -1))

    imc1_den = torch.maximum(hx, hy)
    imc1 = torch.where(imc1_den > 0, (hxy - hxy1) / (imc1_den + EPS),
                       _f32(0.0, p))
    imc2_arg = torch.clamp(1.0 - torch.exp(-2.0 * (hxy2 - hxy)), 0.0, 1.0)
    imc2 = torch.where(hxy2 >= hxy, torch.sqrt(imc2_arg), _f32(0.0, p))

    joint_energy = (p ** 2).sum(dim=(-2, -1))
    max_prob = p.amax(dim=(-2, -1))
    sum_squares = ((ii - ux[..., None, None]) ** 2 * p).sum(dim=(-2, -1))

    mcc = _mcc(p, px, py)
    mcc = torch.where(ng_f[..., 0] > 1, mcc, _f32(1.0, p))

    feats = {
        "Autocorrelation": autocorr,
        "ClusterProminence": cl_prom,
        "ClusterShade": cl_shade,
        "ClusterTendency": cl_tend,
        "Contrast": contrast,
        "Correlation": correlation,
        "DifferenceAverage": dissim_avg,
        "DifferenceEntropy": dentropy,
        "DifferenceVariance": dvar,
        "Id": id_,
        "Idm": idm,
        "Idmn": idmn,
        "Idn": idn,
        "Imc1": imc1,
        "Imc2": imc2,
        "InverseVariance": inv_var,
        "JointAverage": ux,
        "JointEnergy": joint_energy,
        "JointEntropy": hxy,
        "MCC": mcc,
        "MaximumProbability": max_prob,
        "SumAverage": sum_avg,
        "SumEntropy": sentropy,
        "SumSquares": sum_squares,
    }
    return {k: v.mean(dim=-1) for k, v in feats.items()}


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1, keepdim=True))


def _mcc(p, px, py, steps: int = 96):
    """MCC per (map, angle) (texture.py:189-215): Q = D⁻¹A is similar to
    S = D^{-1/2} A D^{-1/2}; deflate its top pair (1, √px) and take the
    dominant eigenvalue of the rest by power iteration from the JAX start
    (ones/√NG).  Where that start has no component along the second
    eigenvector (two levels with equal marginals), the iterate vanishes and
    JAX returns 0 for the angle; the port then restarts from a ramp
    (ROADMAP C5), which changes nothing where the iteration lives."""
    safe_py = torch.where(py > 0, py, _f32(1.0, py))
    a = (p / safe_py[..., None, :]) @ p.transpose(-1, -2)
    inv_sqrt_px = torch.where(
        px > 0, 1.0 / torch.sqrt(torch.clamp(px, min=EPS)), _f32(0.0, px))
    s = a * inv_sqrt_px[..., :, None] * inv_sqrt_px[..., None, :]
    v1 = torch.sqrt(torch.clamp(px, min=0.0))
    v1 = v1 / torch.clamp(_norm(v1), min=EPS)
    s_defl = s - v1[..., :, None] * v1[..., None, :]

    def dot(x, y):
        return (x * y).sum(-1, keepdim=True)

    def iterate(v):
        v = v - v1 * dot(v1, v)
        v = v / torch.clamp(_norm(v), min=EPS)
        for _ in range(steps):
            w = (s_defl @ v[..., None])[..., 0]
            w = w - v1 * dot(v1, w)        # re-orthogonalize
            v = w / torch.clamp(_norm(w), min=EPS)
        return v

    v = iterate(torch.full_like(px, 1.0 / 8.0))     # ones(NG) / sqrt(NG)
    dead = (v == 0).all(-1, keepdim=True)
    if bool(dead.any()):
        ramp = torch.arange(1, NG + 1, dtype=px.dtype, device=px.device)
        v = torch.where(dead, iterate(ramp.expand_as(px)), v)
    lam2 = dot(v, (s_defl @ v[..., None])[..., 0])[..., 0]
    return torch.sqrt(torch.clamp(lam2, 0.0, 1.0))


# ==================================================================== GLRLM

def run_starts_and_lengths(levels, inside, dy: int, dx: int):
    """Per-cell run bookkeeping along one angle (texture.py:265-302) for
    [M, H, W] maps: starts and ends from neighbour comparison, each cell's
    distance to its run's end by a doubling reverse cumulative min along the
    direction → (start bool, gray int32, length int32)."""
    h, w = levels.shape[-2:]
    prev_lv = shift2d(levels, dy, dx, -1)
    prev_ok = shift2d(inside, dy, dx, False)
    start = inside & (~prev_ok | (levels != prev_lv))
    next_lv = shift2d(levels, -dy, -dx, -1)
    next_ok = shift2d(inside, -dy, -dx, False)
    is_end = inside & (~next_ok | (levels != next_lv))

    dev = levels.device
    if dy != 0:
        t = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
        span = h
    else:
        t = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
        span = w
    big = h + w
    end_t = torch.where(is_end, t, big)
    k = 1
    while k < span:
        end_t = torch.minimum(end_t, shift2d(end_t, -dy * k, -dx * k, big))
        k <<= 1
    length = end_t - t + 1
    return start, levels.to(torch.int32), length.to(torch.int32)


def glrlm_matrices(levels: torch.Tensor, mask: torch.Tensor, max_len: int,
                   use_kernels: bool = False) -> torch.Tensor:
    """[M, 4, NG, max_len] run counts per (gray, length) and angle: the
    packed run bookkeeping (``ops.glrlm_runs``), then the joint histogram
    of (gray, clip(length, 1, max_len)) over the run starts
    (``ops.histogram``), batched over maps × angles."""
    from . import glrlm_runs as R
    from . import histogram as Hm
    runs = R.glrlm_runs if use_kernels else R.glrlm_runs_reference
    hist = Hm.joint_histogram if use_kernels else Hm.joint_histogram_reference
    m, h, w = levels.shape
    packed = runs(levels, mask > 0)                          # [M, 4, H, W]
    start, gray, length = R.unpack_runs(packed)
    g_codes = torch.where(start, gray, 0)
    l_codes = torch.where(start, torch.clamp(length, 1, max_len), 0)
    P = hist(g_codes.reshape(m * 4, h * w), l_codes.reshape(m * 4, h * w),
             NG, max_len)
    return P.reshape(m, 4, NG, max_len)


def glrlm_features(levels: torch.Tensor, mask: torch.Tensor,
                   n_levels: torch.Tensor, max_len: int = 640,
                   use_kernels: bool = False) -> Dict[str, torch.Tensor]:
    """The 16 pyradiomics GLRLM features of each map, averaged over the 4
    angles (texture.py:315-394).  Runs longer than ``max_len`` saturate
    into its top bin."""
    inside = mask > 0
    dev = levels.device
    n_p = torch.clamp(inside.sum(dim=(-2, -1)).float(), min=1.0)[:, None]
    i_vals = torch.arange(1, NG + 1, dtype=torch.float32, device=dev)
    l_vals = torch.arange(1, max_len + 1, dtype=torch.float32, device=dev)
    lvl_valid = _level_valid(n_levels)

    P = glrlm_matrices(levels, mask, max_len, use_kernels)  # [M, 4, NG, L]
    P = P * lvl_valid[:, None, :, None]
    nr = torch.clamp(P.sum(dim=(-2, -1)), min=1.0)          # [M, 4]
    p = P / nr[..., None, None]
    pg = P.sum(dim=-1)                                      # [M, 4, NG]
    pl = P.sum(dim=-2)                                      # [M, 4, L]
    ii = i_vals[:, None]
    ll = l_vals[None, :]

    mu_g = (i_vals * pg).sum(-1) / nr
    mu_l = (l_vals * pl).sum(-1) / nr
    feats = {
        "ShortRunEmphasis": (pl / (l_vals ** 2)).sum(-1) / nr,
        "LongRunEmphasis": (pl * l_vals ** 2).sum(-1) / nr,
        "GrayLevelNonUniformity": (pg ** 2).sum(-1) / nr,
        "GrayLevelNonUniformityNormalized": (pg ** 2).sum(-1) / nr ** 2,
        "RunLengthNonUniformity": (pl ** 2).sum(-1) / nr,
        "RunLengthNonUniformityNormalized": (pl ** 2).sum(-1) / nr ** 2,
        "RunPercentage": nr / n_p,
        "GrayLevelVariance": (((i_vals - mu_g[..., None]) ** 2) * pg).sum(-1) / nr,
        "RunVariance": (((l_vals - mu_l[..., None]) ** 2) * pl).sum(-1) / nr,
        "RunEntropy": _entropy(p, (-2, -1)),
        "LowGrayLevelRunEmphasis": (pg / (i_vals ** 2)).sum(-1) / nr,
        "HighGrayLevelRunEmphasis": (pg * i_vals ** 2).sum(-1) / nr,
        "ShortRunLowGrayLevelEmphasis":
            (P / (ii ** 2 * ll ** 2)).sum(dim=(-2, -1)) / nr,
        "ShortRunHighGrayLevelEmphasis":
            (P * ii ** 2 / ll ** 2).sum(dim=(-2, -1)) / nr,
        "LongRunLowGrayLevelEmphasis":
            (P * ll ** 2 / ii ** 2).sum(dim=(-2, -1)) / nr,
        "LongRunHighGrayLevelEmphasis":
            (P * ii ** 2 * ll ** 2).sum(dim=(-2, -1)) / nr,
    }
    return {k: v.mean(dim=-1) for k, v in feats.items()}


# =============================================================== first order

def nanpercentiles(sorted_vals: torch.Tensor, counts: torch.Tensor,
                   percents) -> Dict[float, torch.Tensor]:
    """``jnp.nanpercentile`` (linear interpolation) of each row of
    ``sorted_vals`` [M, N] (ascending, NaNs last; ``counts`` [M] float32 the
    non-NaN count), NaN for an empty row.  In XLA's float32 arithmetic, so
    that a percentile that lands on a tie equals the tied value as in JAX
    (the robust range's x ≥ p10 keeps or drops those pixels): q = p·(1/100)
    (XLA's form of p / 100), rank q·(count−1), floor and ceil clamped to
    [0, count−1], then fma(hi, w, lo·(1−w)) with one rounding."""
    out = {}
    last = sorted_vals.shape[-1] - 1
    for pc in percents:
        q = _f32(float(pc), sorted_vals) * (_f32(1.0, sorted_vals)
                                            / _f32(100.0, sorted_vals))
        rank = q * (counts - 1.0)
        lo, hi = torch.floor(rank), torch.ceil(rank)
        hi_w = rank - lo
        lo_w = 1.0 - hi_w
        lo_i = torch.maximum(torch.zeros_like(lo), torch.minimum(lo, counts - 1))
        hi_i = torch.maximum(torch.zeros_like(hi), torch.minimum(hi, counts - 1))
        lo_v = sorted_vals.gather(-1, lo_i.long().clamp(0, last)[:, None])[:, 0]
        hi_v = sorted_vals.gather(-1, hi_i.long().clamp(0, last)[:, None])[:, 0]
        out[pc] = (hi_v.double() * hi_w.double()
                   + (lo_v * lo_w).double()).float()
    return out


def firstorder_features(image: torch.Tensor, mask: torch.Tensor,
                        bin_width: float) -> Dict[str, torch.Tensor]:
    """The 18 first-order features of each map (texture.py:399-460);
    percentiles over the in-ROI values with ``jnp.nanpercentile``'s linear
    interpolation, from one sort per map."""
    inside = mask > 0
    dims = (-2, -1)
    n = torch.clamp(inside.sum(dim=dims).float(), min=1.0)
    x = image.float()
    zero = _f32(0.0, x)

    mean = torch.where(inside, x, zero).sum(dim=dims) / n
    minimum = torch.where(inside, x, _f32(_BIG, x)).amin(dim=dims)
    maximum = torch.where(inside, x, _f32(-_BIG, x)).amax(dim=dims)
    energy = torch.where(inside, x ** 2, zero).sum(dim=dims)
    c = x - mean[:, None, None]
    var = torch.where(inside, c ** 2, zero).sum(dim=dims) / n
    std = torch.sqrt(var)
    rms = torch.sqrt(energy / n)
    mad = torch.where(inside, c.abs(), zero).sum(dim=dims) / n
    m3 = torch.where(inside, c ** 3, zero).sum(dim=dims) / n
    m4 = torch.where(inside, c ** 4, zero).sum(dim=dims) / n
    skew = torch.where(std > 0, m3 / torch.clamp(std ** 3, min=EPS), zero)
    kurt = torch.where(std > 0, m4 / torch.clamp(var ** 2, min=EPS), zero)

    flat = torch.where(inside, x, _f32(float("nan"), x)).flatten(1)
    sorted_vals = torch.sort(flat, dim=-1).values        # NaNs sort last
    pct = nanpercentiles(sorted_vals, inside.sum(dim=dims).float(),
                         (10, 25, 50, 75, 90))
    p10, p90 = pct[10][:, None, None], pct[90][:, None, None]

    in_robust = inside & (x >= p10) & (x <= p90)
    n_rob = torch.clamp(in_robust.sum(dim=dims).float(), min=1.0)
    mean_rob = torch.where(in_robust, x, zero).sum(dim=dims) / n_rob
    rmad = torch.where(in_robust, (x - mean_rob[:, None, None]).abs(),
                       zero).sum(dim=dims) / n_rob

    levels, _, _ = discretize(image, mask, bin_width)
    m = levels.shape[0]
    ok = inside & (levels >= 1) & (levels <= NG)
    keys = torch.where(ok, levels - 1 + map_offsets(m, NG, levels.device),
                       m * NG)
    hist = bincount(keys, m * NG).view(m, NG)
    p_hist = hist / n[:, None]
    entropy = _entropy(p_hist, -1)
    uniformity = (p_hist ** 2).sum(-1)

    return {
        "Energy": energy,
        "TotalEnergy": energy,  # spacing (1, 1): voxel volume 1
        "Entropy": entropy,
        "Minimum": minimum,
        "10Percentile": pct[10],
        "90Percentile": pct[90],
        "Maximum": maximum,
        "Mean": mean,
        "Median": pct[50],
        "InterquartileRange": pct[75] - pct[25],
        "Range": maximum - minimum,
        "MeanAbsoluteDeviation": mad,
        "RobustMeanAbsoluteDeviation": rmad,
        "RootMeanSquared": rms,
        "Skewness": skew,
        "Kurtosis": kurt,
        "Variance": var,
        "Uniformity": uniformity,
    }
