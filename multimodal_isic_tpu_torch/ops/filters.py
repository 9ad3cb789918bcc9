"""The pyradiomics derived-image filter bank, batched over maps.

Counterpart of ``multimodal_isic_tpu/ops/filters.py:21-148``: coif1
stationary wavelet (LL/LH/HL/HH), LoG at σ 1/2/3, square, squareroot,
logarithm, exponential and gradient, 13 derived images keyed exactly as
``filter_bank``.  Every function takes ``img`` [M, H, W] float32 (a batch of
image×channel maps) where the JAX functions took one [H, W] map; the
per-map reductions (``max|x|``) are per map.

Exactness: ``discretize`` floors ``x / bin_width``, so a filter output one ulp
away from the JAX value can move a pixel to another bin.  The taps therefore
accumulate in the JAX order *and rounding*: XLA computes the ``einsum`` over
the gathered taps as a sequential fused multiply-add, ``acc = fma(x_k, w_k,
acc)`` for k = 0, 1, ..., which :func:`_fma_taps` reproduces by adding the
exact float64 product and rounding to float32 once per tap.  No convolution
or matrix product is used, so TF32 flags cannot touch the result, and the
same elementwise float32/float64 operations give the same bits on the CPU and
on the card.  Divisions take a tensor divisor, never a Python scalar: on CUDA
PyTorch turns ``x / scalar`` into ``x * (1 / scalar)``, which rounds
differently.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .texture import _f32

# coif1 analysis filters (published Coiflet-6 coefficients, pywt convention)
COIF1_DEC_LO = (
    -0.01565572813546454, -0.0727326195128539, 0.38486484686420286,
    0.8525720202122554, 0.3378976624578092, -0.0727326195128539,
)
# QMF: hi[n] = (-1)^n · lo[N-1-n]
COIF1_DEC_HI = tuple(
    ((-1) ** n) * COIF1_DEC_LO[len(COIF1_DEC_LO) - 1 - n]
    for n in range(len(COIF1_DEC_LO))
)


def _fma_taps(taps, weights: torch.Tensor) -> torch.Tensor:
    """Σ_k taps[k]·weights[k] as a chain of float32 fused multiply-adds in
    tap order: the float64 product of two float32 values is exact, so one
    float64 add and one rounding to float32 give fma's result."""
    w = weights.double()
    acc = None
    for k, t in enumerate(taps):
        prod = t.double() * w[k]
        acc = (prod if acc is None else prod + acc.double()).float()
    return acc


def _conv_along(x: torch.Tensor, kernel: torch.Tensor, dim: int,
                index: torch.Tensor) -> torch.Tensor:
    """out[..., n, ...] = Σ_k x[..., index[n, k], ...] · kernel[K-1-k] along
    ``dim``: the JAX gather-then-einsum with the reversed kernel."""
    kr = kernel.flip(0)
    taps = [x.index_select(dim, index[:, k]) for k in range(index.shape[1])]
    return _fma_taps(taps, kr)


def _conv1d_circular(img: torch.Tensor, kernel: torch.Tensor,
                     dim: int) -> torch.Tensor:
    """Circular (periodic) 1-D convolution along ``dim`` (SWT boundary)."""
    k = kernel.shape[0]
    n = img.shape[dim]
    idx = (torch.arange(n, device=img.device)[:, None]
           + torch.arange(k, device=img.device)[None, :] - k // 2) % n
    return _conv_along(img, kernel, dim, idx)


def wavelet_coif1_swt(img: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Level-1 stationary coif1 transform → wavelet-LL/LH/HL/HH; the first
    letter is the filter over rows (dim -2), the second over columns."""
    lo = torch.tensor(COIF1_DEC_LO, dtype=torch.float32, device=img.device)
    hi = torch.tensor(COIF1_DEC_HI, dtype=torch.float32, device=img.device)
    row_lo = _conv1d_circular(img, lo, -2)
    row_hi = _conv1d_circular(img, hi, -2)
    return {
        "wavelet-LL": _conv1d_circular(row_lo, lo, -1),
        "wavelet-LH": _conv1d_circular(row_lo, hi, -1),
        "wavelet-HL": _conv1d_circular(row_hi, lo, -1),
        "wavelet-HH": _conv1d_circular(row_hi, hi, -1),
    }


def _gauss_kernels(sigma: float, order0: bool) -> torch.Tensor:
    """The JAX kernel's float32 values (on the CPU): the normalising sum is
    taken left to right, as XLA reduces these 2r+1 values."""
    radius = max(1, int(math.ceil(4.0 * sigma)))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    s = torch.tensor(sigma, dtype=torch.float32)
    g = torch.exp(-0.5 * (x / s) ** 2)
    total = g[0].clone()
    for v in g[1:]:
        total = total + v
    g = g / total
    if order0:
        return g
    return g * ((x ** 2 - s ** 2) / s ** 4)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of numpy's ``reflect`` pad (no edge repeat), any pad width."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.minimum(i, period - i)


def log_filter(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Laplacian of Gaussian: ∂²G/∂x² * G_y + G_x * ∂²G/∂y² (separable FIR),
    reflect boundary, σ in pixels."""
    g = _gauss_kernels(sigma, order0=True).to(img.device)
    d2 = _gauss_kernels(sigma, order0=False).to(img.device)

    def conv(x, kernel, dim):
        k = kernel.shape[0]
        n = x.shape[dim]
        src = _reflect_index(n, k // 2, x.device)
        idx = (torch.arange(n, device=x.device)[:, None]
               + torch.arange(k, device=x.device)[None, :])
        return _conv_along(x, kernel, dim, src[idx])

    dxx = conv(conv(img, d2, -1), g, -2)
    dyy = conv(conv(img, g, -1), d2, -2)
    return dxx + dyy


def _absmax(img: torch.Tensor) -> torch.Tensor:
    """max|x| per map, [M, 1, 1]."""
    return img.abs().amax(dim=(-2, -1), keepdim=True)


def square_filter(img: torch.Tensor) -> torch.Tensor:
    """f = (c·x)², c = 1/√(max|x|)."""
    m = torch.clamp(_absmax(img), min=1e-30)
    coeff = _f32(1.0, img) / torch.sqrt(m)
    return (coeff * img) ** 2


def squareroot_filter(img: torch.Tensor) -> torch.Tensor:
    """f = √(c·x) for x ≥ 0, −√(−c·x) for x < 0, c = max|x|."""
    c = _absmax(img)
    return torch.where(img >= 0, torch.sqrt(torch.clamp(c * img, min=0.0)),
                       -torch.sqrt(torch.clamp(-c * img, min=0.0)))


def logarithm_filter(img: torch.Tensor) -> torch.Tensor:
    """f = sign(x)·c·log(|x| + 1), c = max|x| / log(max|x| + 1)."""
    m = _absmax(img)
    c = torch.where(m > 0, m / torch.log(m + 1.0), _f32(1.0, img))
    return torch.sign(img) * c * torch.log(img.abs() + 1.0)


def exponential_filter(img: torch.Tensor) -> torch.Tensor:
    """f = e^(c·x), c = log(max|x|) / max|x|."""
    m = _absmax(img)
    mc = torch.clamp(m, min=1e-30)
    c = torch.where(m > 0, torch.log(mc) / mc, _f32(1.0, img))
    return torch.exp(c * img)


def gradient_filter(img: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude by central differences, edge-replicated."""
    xp = torch.nn.functional.pad(img[:, None], (1, 1, 1, 1),
                                 mode="replicate")[:, 0]
    two = _f32(2.0, img)
    dy = (xp[:, 2:, 1:-1] - xp[:, :-2, 1:-1]) / two
    dx = (xp[:, 1:-1, 2:] - xp[:, 1:-1, :-2]) / two
    return torch.sqrt(dx ** 2 + dy ** 2)


def filter_bank(img: torch.Tensor,
                log_sigmas: Tuple[float, ...] = (1.0, 2.0, 3.0)
                ) -> Dict[str, torch.Tensor]:
    """All 13 derived images of [M, H, W] float32 maps, keyed by the
    pyradiomics image-type prefix of the feature columns."""
    out = {"original": img}
    out.update(wavelet_coif1_swt(img))
    for s in log_sigmas:
        out[f"log-sigma-{str(s).replace('.', '-')}-mm-3D"] = log_filter(img, s)
    out["square"] = square_filter(img)
    out["squareroot"] = squareroot_filter(img)
    out["logarithm"] = logarithm_filter(img)
    out["exponential"] = exponential_filter(img)
    out["gradient"] = gradient_filter(img)
    return out
