"""PCA with sklearn's semantics, on the tensor's device.

Counterpart of ``multimodal_isic_tpu/analysis/pca.py`` (the reference's
``PCA(n_components=0.90, whiten=False)``, ``save_latent.py:159-181``): fit
is ``torch.linalg.eigh`` of the float32 feature covariance (D × D, D = 768
here), components in descending variance with the largest-|loading|
coordinate made positive, and sklearn's fractional-K rule.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

Components = Union[int, float, None]


class PCAState(NamedTuple):
    mean: torch.Tensor                      # [D]
    components: torch.Tensor                # [K, D]
    explained_variance: torch.Tensor        # [K]
    explained_variance_ratio: torch.Tensor  # [K]


def _fit_full(x: torch.Tensor):
    n = x.shape[0]
    mean = x.mean(dim=0)
    xc = x - mean
    cov = (xc.T @ xc) / (n - 1)
    eigvals, eigvecs = torch.linalg.eigh(cov)  # ascending
    order = torch.argsort(eigvals, stable=True).flip(0)
    eigvals = eigvals[order].clamp_min(0.0)
    components = eigvecs[:, order].T  # rows = components
    # deterministic sign: the max-|loading| coordinate positive
    idx = torch.argmax(components.abs(), dim=1)
    signs = torch.sign(components[torch.arange(components.shape[0]), idx])
    components = components * torch.where(signs == 0, 1.0, signs)[:, None]
    ratio = eigvals / eigvals.sum().clamp_min(1e-30)
    return mean, components, eigvals, ratio


def fit(x, n_components: Components = None) -> PCAState:
    """``n_components``: int K, a float in (0, 1) selecting the smallest K
    whose cumulative explained-variance ratio strictly exceeds it (sklearn's
    rule), or None for all.  ``x`` [N, D]: fit on its device (an array on
    the CPU)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    mean, components, var, ratio = _fit_full(x)
    max_k = min(x.shape[0], components.shape[0])
    if n_components is None:
        k = max_k
    elif isinstance(n_components, float) and 0 < n_components < 1:
        csum = np.cumsum(ratio.cpu().numpy())
        k = min(int(np.searchsorted(csum, n_components, side="right") + 1),
                max_k)
    else:
        k = min(int(n_components), max_k)
    return PCAState(mean, components[:k], var[:k], ratio[:k])


def transform(state: PCAState, x) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32, device=state.mean.device)
    return (x - state.mean) @ state.components.T


def inverse_transform(state: PCAState, z) -> torch.Tensor:
    z = torch.as_tensor(z, dtype=torch.float32, device=state.mean.device)
    return z @ state.components + state.mean


def fit_transform(x, n_components: Components = None):
    state = fit(x, n_components)
    return state, transform(state, x)
