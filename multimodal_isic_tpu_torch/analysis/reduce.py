"""Radiomics feature reduction (the ``reduce_dim.py`` workload).

Counterpart of ``multimodal_isic_tpu/analysis/reduce.py`` (:1-204).  The
stages, in the reference's order (``reduce_dim.py:94-122``): variance filter
(1e-3) → standardisation fitted on train → L1-logistic feature selection
with cross-validated C → |ρ| > 0.95 correlation drop → test columns aligned
to train.

The variance filter, the standardisation and the correlation drop are numpy
float64 on the host, as in the JAX package.  The L1-logistic selection fits
every (C, class) problem as one batched FISTA solve on ``device`` (the C grid
× the one-vs-rest classes as batch dimensions of the same tensors), where
the reference runs liblinear once per C and fold: as in
``LogisticRegressionCV(..., scoring='f1', cv=StratifiedKFold(5, shuffle,
rs=42))`` under ovr, each class's binary subproblem is scored with binary F1
across the folds and keeps its own best C, and a feature is kept where its
mean |coefficient| across classes exceeds ``SelectFromModel``'s L1
threshold (1e-5).  The solve runs in full float32 (no TF32) whatever the
global flags say.  pandas is imported where a frame is built.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.splits import StratifiedKFold
from ..core.precision import full_float32

SELECT_THRESHOLD = 1e-5  # SelectFromModel's threshold for L1 models
POWER_ITERS = 16


def filter_low_variance(train_df, test_df, threshold: float = 1e-3):
    """sklearn ``VarianceThreshold``: keep the features with Var(x) >
    threshold (biased variance), :32-38."""
    var = train_df.values.astype(np.float64).var(axis=0)
    cols = train_df.columns[var > threshold]
    return train_df[cols], test_df[cols]


def normalize_features(train_df, test_df):
    """``StandardScaler`` fitted on train (ddof 0), applied to both
    (:41-48)."""
    import pandas as pd  # local: host-only dependency

    x = train_df.values.astype(np.float64)
    mean = x.mean(axis=0)
    std = x.std(axis=0)
    std = np.where(std == 0, 1.0, std)
    return (pd.DataFrame((train_df.values - mean) / std,
                         columns=train_df.columns),
            pd.DataFrame((test_df.values - mean) / std,
                         columns=train_df.columns))


def _fista_betas(iters: int, dtype=np.float32) -> list:
    """FISTA's momentum weights (t − 1)/t', the sequence t₀ = 1,
    t' = (1 + √(1 + 4t²))/2 in ``dtype`` (float32 as the JAX scan carries
    it)."""
    one, four, two = dtype(1.0), dtype(4.0), dtype(2.0)
    t = one
    betas = []
    for _ in range(iters):
        t_new = (one + np.sqrt(one + four * t * t)) / two
        betas.append(float((t - one) / t_new))
        t = t_new
    return betas


def _fista_l1_logistic(X: torch.Tensor, Y: torch.Tensor, sw: torch.Tensor,
                       C, iters: int = 300
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched one-vs-rest L1 logistic regression with sample weights
    (:51-99).

    X [N, D] standardised, Y [K, N] ±1 labels, sw [N] sample weights, C the
    inverse regularisation: a scalar, a [K] vector (a C per class, the
    per-class ``C_`` of ``LogisticRegressionCV`` under ovr) or [G, K] (a C
    grid of G points, each for every class).  Minimises
    ``C·Σᵢ swᵢ·log(1 + exp(−yᵢ(xᵢ·w + b))) + ‖w‖₁ + |b|`` (liblinear's
    objective with ``class_weight='balanced'``, whose intercept is an
    appended all-ones column under the same penalty) by FISTA with step 1/L,
    L = C/4 · (λ_max(Xᵀ diag(sw) X) + Σ sw), λ_max from 16 power
    iterations.  ``iters`` steps run as a loop of tensor operations on X's
    device with no device→host copy inside, in X's dtype (float32 on the
    selection's path; float64 gives a reference solve of the same steps).
    → (W [..., K, D], b [..., K]) for C's batch shape."""
    n, d = X.shape
    dev, dt = X.device, X.dtype
    with torch.no_grad(), full_float32():
        C = torch.as_tensor(C, dtype=dt, device=dev)
        C = C.expand(torch.broadcast_shapes(C.shape, (Y.shape[0],)))
        Xs = X * torch.sqrt(sw)[:, None]
        v = torch.ones(d, dtype=dt, device=dev) / torch.sqrt(
            torch.tensor(float(d), dtype=dt, device=dev))
        for _ in range(POWER_ITERS):
            v = Xs.T @ (Xs @ v)
            v = v / torch.linalg.vector_norm(v).clamp_min(1e-12)
        sq_norm = torch.dot(v, Xs.T @ (Xs @ v)).clamp_min(1e-6)
        L = C * 0.25 * (sq_norm + sw.sum())            # [..., K]
        inv_L = 1.0 / L
        w = torch.zeros(C.shape + (d,), dtype=dt, device=dev)
        b = torch.zeros(C.shape, dtype=dt, device=dev)
        zw, zb = w, b
        np_dt = np.float64 if dt == torch.float64 else np.float32
        for beta in _fista_betas(iters, np_dt):
            margin = Y * (zw @ X.T + zb[..., None])    # [..., K, N]
            ys = Y * (sw * torch.sigmoid(-margin))
            gw = -C[..., None] * (ys @ X)
            gb = -C * ys.sum(-1)
            w_new = zw - gw / L[..., None]
            b_new = zb - gb / L
            w_new = torch.sign(w_new) * (w_new.abs()
                                         - inv_L[..., None]).clamp_min(0.0)
            b_new = torch.sign(b_new) * (b_new.abs() - inv_L).clamp_min(0.0)
            zw = w_new + beta * (w_new - w)
            zb = b_new + beta * (b_new - b)
            w, b = w_new, b_new
    return w, b


def _binary_f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """sklearn ``f1_score`` with pos_label 1, the scorer
    ``LogisticRegressionCV`` applies to each one-vs-rest subproblem under
    ``scoring='f1'`` (:102-109)."""
    tp = np.sum(y_true & y_pred)
    fp = np.sum(~y_true & y_pred)
    fn = np.sum(y_true & ~y_pred)
    p = tp / (tp + fp) if tp + fp else 0.0
    r = tp / (tp + fn) if tp + fn else 0.0
    return float(2 * p * r / (p + r) if p + r else 0.0)


def lasso_importance(X: np.ndarray, y_train, C_values="auto",
                     n_folds: int = 5, seed: int = 42, iters: int = 300,
                     balanced: bool = True, device="cuda"):
    """The selection's per-feature importance (JAX :112-163) → (mean |W|
    over the classes [D], the per-class best C [K]).  Each fold's whole C
    grid is one :func:`_fista_l1_logistic` call on ``device``; the
    validation logits and F1 scores are float64 on the host."""
    dev = torch.device(device)
    Cs = (np.logspace(-2, 1, 20) if isinstance(C_values, str)
          else np.asarray(C_values))
    y = np.asarray(y_train).astype(int)
    classes = np.unique(y)
    k = len(classes)
    if balanced:  # class_weight='balanced' as per-sample weights
        counts = np.bincount(y, minlength=classes.max() + 1).astype(float)
        w_sample = len(y) / (k * counts[y])
    else:
        w_sample = np.ones(len(y))

    def f32(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def labels(yy) -> torch.Tensor:
        return f32(np.stack([np.where(yy == c, 1.0, -1.0) for c in classes]))

    kf = StratifiedKFold(n_folds, shuffle=True, random_state=seed)
    scores = np.zeros((len(Cs), k))
    grid = f32(Cs)[:, None]                                  # [n_C, 1]
    for tr_idx, va_idx in kf.split(np.zeros((len(y), 1)), y):
        W_all, b_all = _fista_l1_logistic(
            f32(X[tr_idx]), labels(y[tr_idx]), f32(w_sample[tr_idx]), grid,
            iters)                                           # [n_C, K, D]
        logits = np.einsum("nd,ckd->cnk", X[va_idx], W_all.cpu().numpy()) \
            + b_all.cpu().numpy()[:, None, :]
        for ci in range(len(Cs)):
            for ki, c in enumerate(classes):
                scores[ci, ki] += _binary_f1(y[va_idx] == c,
                                             logits[ci, :, ki] > 0)
    best_C = Cs[np.argmax(scores, axis=0)]                   # per-class C_
    W, _ = _fista_l1_logistic(f32(X), labels(y), f32(w_sample), f32(best_C),
                              iters)
    return np.abs(W.cpu().numpy()).mean(axis=0), best_C


def lasso_select(train_df, y_train, test_df, C_values="auto",
                 n_folds: int = 5, seed: int = 42, iters: int = 300,
                 balanced: bool = True, device="cuda"):
    """L1-logistic feature selection with C chosen per class by
    cross-validation (``reduce_dim.py:34-58``; JAX :112-166): the features
    whose :func:`lasso_importance` exceeds ``SelectFromModel``'s 1e-5."""
    importance, _ = lasso_importance(train_df.values, y_train, C_values,
                                     n_folds, seed, iters, balanced, device)
    cols = train_df.columns[importance > SELECT_THRESHOLD]
    return train_df[cols], test_df[cols]


def drop_correlated_features(df, threshold: float = 0.95):
    """The upper-triangle |ρ| > threshold column drop
    (``reduce_dim.py:60-64``; JAX :169-175)."""
    corr = np.abs(np.corrcoef(df.values.astype(np.float64), rowvar=False))
    upper = np.triu(corr, k=1)
    to_drop = [df.columns[j] for j in range(len(df.columns))
               if np.any(upper[:, j] > threshold)]
    return df.drop(columns=to_drop), to_drop


def reduce_features(rad_train, rad_test, y_train,
                    variance_threshold: float = 1e-3,
                    corr_threshold: float = 0.95, seed: int = 42,
                    log=print, device="cuda"):
    """The whole ``reduce_dim.py`` workload with its per-channel drop lines
    (JAX :178-197) → (train frame, test frame)."""
    num_features = len(rad_train.columns) // 4
    log(f"Initial features: {rad_train.shape[1]}")

    tr, te = filter_low_variance(rad_train, rad_test, variance_threshold)
    log(f"Features after variance filtering: {tr.shape[1]}")
    _log_channel_drops(log, "variance filtering", tr.columns, num_features)

    tr, te = normalize_features(tr, te)
    tr, te = lasso_select(tr, y_train, te, seed=seed, device=device)
    log(f"Features after Lasso selection: {tr.shape[1]}")
    _log_channel_drops(log, "Lasso selection", tr.columns, num_features)

    tr, _ = drop_correlated_features(tr, corr_threshold)
    log(f"Features after dropping correlated features: {tr.shape[1]}")
    return tr, te[tr.columns]


def _log_channel_drops(log, stage, columns, num_features):
    for tag in ("_gs", "_red", "_green", "_blue"):
        kept = len([c for c in columns if tag in c])
        log(f"Dropped due to {stage} - {tag[1:]}: {num_features - kept}")
