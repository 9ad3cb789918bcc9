"""Cluster-composition statistics (the ``cluster_latents.py`` analysis).

Counterpart of ``multimodal_isic_tpu/analysis/cluster.py`` (:1-131): the
reference's per-patch purity pipeline (``cluster_latents.py:58-138``) as
segment ops over cluster ids: same/other-class member counts, per-class
counts, purity proportions/ratios, patient-frequency class weights,
weighted purity and the 10th-percentile weighted-purity cluster filter.  A
``noise`` label (< 0) is excluded exactly like HDBSCAN's ``-1`` cluster.
These are the JAX package's numpy code, copied.

:func:`trustworthiness` is the same gram-trick float64 computation on a
tensor's device (the CLI's card): ranks by a stable sort a block of rows
at a time, so memory is ``[block, N]``, not ``[N, N]``; the penalty sum is
of integers, exact in float64, so the score equals the numpy form's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

EPS = 1e-8


def cluster_purity_stats(clusters: np.ndarray, targets: np.ndarray,
                         num_classes: int,
                         class_weights: Optional[Dict[int, float]] = None
                         ) -> Dict[str, np.ndarray]:
    """Per-patch cluster composition (vectorized; one bincount per quantity).

    Returns same_counts, other_counts, prop_same, ratio_same_other,
    counts_per_class [N, num_classes], and (given weights) prop_same_weighted —
    the exact quantities of ``cluster_latents.py:58-124``.
    """
    clusters = np.asarray(clusters)
    targets = np.asarray(targets).astype(int)
    valid = clusters >= 0
    n = len(clusters)
    # compact cluster ids
    uniq, comp = np.unique(clusters[valid], return_inverse=True)
    k = len(uniq)
    cid = np.full(n, -1, int)
    cid[valid] = comp

    # [K, C] class counts per cluster
    counts = np.zeros((k, num_classes), int)
    np.add.at(counts, (cid[valid], targets[valid]), 1)
    cluster_sizes = counts.sum(axis=1)

    counts_per_patch = np.zeros((n, num_classes), int)
    counts_per_patch[valid] = counts[cid[valid]]
    same = np.zeros(n, int)
    same[valid] = counts[cid[valid], targets[valid]] - 1  # exclude self
    other = np.zeros(n, int)
    other[valid] = cluster_sizes[cid[valid]] - same[valid] - 1

    prop_same = (same.astype(float) + EPS) / (same + other + EPS)
    ratio = (same.astype(float) + EPS) / (other.astype(float) + EPS)

    out = {
        "cluster_same_count": same,
        "cluster_other_count": other,
        "cluster_prop_same": prop_same,
        "cluster_ratio_same_other": ratio,
        "counts_per_class": counts_per_patch,
        "cluster_id": cid,
        "cluster_sizes": cluster_sizes,
        "cluster_class_counts": counts,
    }

    if class_weights is not None:
        w = np.array([class_weights.get(c, 0.0) for c in range(num_classes)])
        weighted_same = np.zeros(n, float)
        weighted_other = np.zeros(n, float)
        wc = counts * w[None, :]  # [K, C] weighted counts
        weighted_same[valid] = (counts[cid[valid], targets[valid]] - 1) * w[targets[valid]]
        total_w = wc.sum(axis=1)
        weighted_other[valid] = (total_w[cid[valid]]
                                 - counts[cid[valid], targets[valid]] * w[targets[valid]])
        out["cluster_prop_same_weighted"] = (
            (weighted_same + EPS) / (weighted_same + weighted_other + EPS))
    return out


def patient_class_weights(patient_targets: np.ndarray,
                          num_classes: int) -> Dict[int, float]:
    """total_patients / (patients-of-class + eps) — the reference's
    patient-frequency weighting (``cluster_latents.py:99-104``)."""
    patient_targets = np.asarray(patient_targets).astype(int)
    total = len(patient_targets)
    counts = np.bincount(patient_targets, minlength=num_classes)
    return {c: total / (counts[c] + EPS) for c in range(num_classes)}


def filter_low_purity_clusters(stats: Dict[str, np.ndarray],
                               percentile: float = 10.0) -> Tuple[np.ndarray, float]:
    """Keep patches whose cluster's weighted purity is ≥ the given percentile
    of per-cluster purity (one value per cluster — ``cluster_latents.py:
    127-138``).  → (keep mask [N], threshold)."""
    cid = stats["cluster_id"]
    purity = stats["cluster_prop_same_weighted"]
    valid = cid >= 0
    k = stats["cluster_class_counts"].shape[0]
    per_cluster = np.full(k, np.nan)
    # 'first' per cluster, as the reference's groupby().first() — via the
    # first occurrence index of each compact id (vectorized: the 2M-row
    # table made the per-patch loop this replaces a multi-second stall)
    ids, first_idx = np.unique(cid[valid], return_index=True)
    per_cluster[ids] = purity[np.where(valid)[0][first_idx]]
    threshold = float(np.percentile(per_cluster[~np.isnan(per_cluster)], percentile))
    keep = valid & (purity >= threshold)
    return keep, threshold


def trustworthiness(x, emb, n_neighbors: int = 5,
                    device: Union[str, torch.device] = "cpu",
                    block: int = 2048) -> float:
    """sklearn-definition trustworthiness of an embedding (the quality score
    the reference reports for its UMAP projections, ``cluster_latents.py:
    28``), in float64 on ``device``."""
    x = torch.as_tensor(np.asarray(x, np.float64), device=device)
    emb = torch.as_tensor(np.asarray(emb, np.float64), device=device)
    n, k = x.shape[0], n_neighbors

    def sq_dists(a, rows):
        # gram-trick distances of a block of rows: O(block·N) memory, not
        # the O(N²·D) broadcast-difference tensor (103 GB at a 4096×768
        # sample)
        s = (a ** 2).sum(-1)
        d = s[rows, None] - 2.0 * (a[rows] @ a.T) + s[None, :]
        d[torch.arange(len(rows), device=d.device), rows] = torch.inf
        return d

    t = torch.zeros((), dtype=torch.float64, device=x.device)
    for s0 in range(0, n, block):
        rows = torch.arange(s0, min(s0 + block, n), device=x.device)
        order = torch.argsort(sq_dists(x, rows), dim=1, stable=True)
        r_x = torch.empty_like(order).scatter_(   # rank 0 = NN
            1, order, torch.arange(n, device=x.device).expand_as(order))
        nn_e = torch.argsort(sq_dists(emb, rows), dim=1,
                             stable=True)[:, :k]
        rank = torch.gather(r_x, 1, nn_e).to(torch.float64)
        t += torch.where(rank >= k, rank - k + 1, 0.0).sum()
    return float(1.0 - 2.0 / (n * k * (2 * n - 3 * k - 1)) * float(t))
