"""Approximate k-nearest neighbours at the reference's scale.

Counterpart of ``multimodal_isic_tpu/analysis/ann.py`` (:1-291).  The
reference clusters its full train patch-latent table, ~2M rows
(``cluster_latents.py:26-32``), where the exact graph of
:func:`.embed.knn_graph` is O(N²·D).  This is the IVF path, every hot step a
dense product on the card:

1. **Buckets**: a light k-means (a random subset as the centers, a few
   Lloyd steps, assignment a row chunk at a time) into C ≈ √N buckets.  The
   subset and the balancing draws come from ``np.random.RandomState(seed)``
   as in JAX (``ann.py:204``, ``:135``), so given the same centers the
   buckets are JAX's.
2. **Bucket-shared probes**: each bucket probes its ``nprobe`` nearest
   buckets by centroid distance (itself included), so a bucket's queries
   share one candidate list.
3. **Exact rerank**: one rectangular product a bucket, its ``cap`` queries
   against the ``nprobe·cap`` members of its probed buckets, in full
   float32, then the k nearest other members.  A group of buckets is one batched product,
   sized to :data:`RERANK_BYTES` of distances (JAX folds probe by probe
   into a running top-k to fit a 16 GB chip; the set of candidates, hence
   the result, is the same).  Buckets are padded to ``cap`` with a sentinel
   row of huge coordinates, and ``_balance_buckets`` caps occupancy at 2×
   the mean, so the padding stays bounded on skewed data.

Unfilled slots (fewer than k candidates reachable) carry index 0 and
distance :data:`BIG`; every consumer compares against :data:`FINITE`.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.precision import full_float32

BIG = 1e15  # finite stand-in for "no neighbor found" distances
# Distances below FINITE are real edges; at or above it, sentinel slots.
# The sentinel row's coordinates are 1e18; genuine latent distances ≤ ~1e4.
FINITE = BIG / 10.0
ASSIGN_BLOCK = 8192
RERANK_BYTES = 4 << 30  # the distance block of one group of buckets

Device = Union[str, torch.device]


def _assign_chunked(x: torch.Tensor, centers: torch.Tensor,
                    block: int = ASSIGN_BLOCK) -> torch.Tensor:
    """Nearest-centroid assignment in row chunks → labels [N]."""
    c2 = (centers ** 2).sum(1)[None, :]
    out = []
    for s in range(0, x.shape[0], block):
        rows = x[s:s + block]
        with full_float32():
            xc = rows @ centers.T
        out.append(((rows ** 2).sum(1)[:, None] - 2.0 * xc + c2).argmin(1))
    return torch.cat(out)


def _lloyd_step(x: torch.Tensor, centers: torch.Tensor, n_buckets: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration (empty buckets keep their previous center)."""
    labels = _assign_chunked(x, centers)
    sums = torch.zeros_like(centers).index_add_(0, labels, x)
    counts = torch.bincount(labels, minlength=n_buckets).to(x.dtype)
    new = sums / counts.clamp_min(1.0)[:, None]
    return torch.where(counts[:, None] > 0, new, centers), labels


def _rerank(xp: torch.Tensor, members: torch.Tensor, probes: torch.Tensor,
            bucket_ids: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact rerank of the buckets ``bucket_ids`` [G]: xp [N+1, D] (the last
    row the sentinel), members [C, cap] with N marking pads, probes [C,
    nprobe] → (nbr [G, cap, k] indices into 0..N, dist [G, cap, k]), inf
    where fewer than k candidates.

    The k + 1 nearest candidates are taken, then the query itself (its
    bucket is among its probes) and sentinel pads (huge, but finite,
    distances) are dropped: the k nearest other members, without a
    ``[G, cap, M]`` mask."""
    n_sentinel = xp.shape[0] - 1
    q_idx = members[bucket_ids]                                  # [G, cap]
    cand = members[probes[bucket_ids]].flatten(1)                # [G, M]
    q, cx = xp[q_idx], xp[cand]
    with full_float32():
        d2 = torch.bmm(q, cx.transpose(1, 2))                    # [G, cap, M]
    # ‖q‖² − 2q·c + ‖c‖² in place, rounded as that expression
    d2.mul_(-2.0).add_((q ** 2).sum(2)[:, :, None]).add_(
        (cx ** 2).sum(2)[:, None, :])
    best_d, sel = torch.topk(d2, min(k + 1, d2.shape[2]), dim=2,
                             largest=False)
    del d2
    best_i = torch.gather(cand[:, None, :].expand(-1, q_idx.shape[1], -1), 2,
                          sel)
    best_d.masked_fill_((best_i == q_idx[:, :, None])
                        | (best_i == n_sentinel), torch.inf)
    best_d, order = torch.sort(best_d, dim=2, stable=True)
    best_i = torch.gather(best_i, 2, order)[:, :, :k]
    return best_i, best_d[:, :, :k].clamp_min(0.0).sqrt()


def _balance_buckets(x: np.ndarray, labels: np.ndarray, centers: np.ndarray,
                     limit: int, rs: np.random.RandomState):
    """Split every bucket with more than ``limit`` members into random
    equal pieces of ≤ ``limit``, each with its own centroid (the piece
    mean).  k-means occupancy on clustered data is heavily skewed (7× over
    the mean at 2M rows, measured in the JAX package), and the rerank's
    padded compute and memory scale with the MAX occupancy.  Random pieces
    of one tight bucket have near-identical centroids, so they land at the
    top of each other's probe lists and recall is unchanged.

    → (labels, centers) with ``bincount(labels).max() <= limit``."""
    counts = np.bincount(labels, minlength=len(centers))
    big = np.where(counts > limit)[0]
    if len(big) == 0:
        return labels, centers
    extra = []
    next_id = len(centers)
    for b in big:
        idx = np.where(labels == b)[0]
        rs.shuffle(idx)
        parts = int(np.ceil(len(idx) / limit))
        for p, chunk in enumerate(np.array_split(idx, parts)):
            mean = x[chunk].mean(axis=0)
            if p == 0:
                centers[b] = mean
            else:
                labels[chunk] = next_id
                extra.append(mean)
                next_id += 1
    if extra:
        centers = np.vstack([centers, np.asarray(extra, centers.dtype)])
    return labels, centers


def approx_knn_graph(
    x: np.ndarray,
    k: int = 15,
    metric: str = "euclidean",
    nprobe: Optional[int] = None,
    n_buckets: Optional[int] = None,
    n_iters: int = 4,
    seed: int = 0,
    verbose: bool = False,
    device: Device = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """→ (nbr [N, k] int64, dist [N, k] float32) numpy, self excluded: the
    contract of :func:`.embed.knn_graph` up to approximation.  'cosine'
    normalises the rows first and returns unit-sphere euclidean distances,
    as the exact path."""
    x = np.ascontiguousarray(x, np.float32)
    n, d = x.shape
    if metric == "cosine":
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    elif metric != "euclidean":
        raise ValueError(f"unsupported metric {metric!r}")

    c = n_buckets or max(int(np.sqrt(n)), 4)
    c = min(c, n)
    if n <= max(4 * k, 256) or c < 2:
        # tiny inputs: exact is cheaper than the machinery
        from .embed import knn_graph
        nbr, dist = knn_graph(torch.from_numpy(x).to(device), k)
        return nbr.cpu().numpy(), dist.cpu().numpy()
    xd = torch.from_numpy(x).to(device)
    rs = np.random.RandomState(seed)
    centers = xd[torch.from_numpy(rs.choice(n, c, replace=False)).to(device)]
    for _ in range(n_iters):
        centers, _ = _lloyd_step(xd, centers, c)
    labels = _assign_chunked(xd, centers).cpu().numpy()

    # cap occupancy at 2× the mean before choosing probe counts (the rerank
    # scales with the MAX occupancy; splitting grows C)
    cen = centers.cpu().numpy()
    limit = max(2 * int(np.ceil(n / c)), 4 * (k + 1), 128)
    labels, cen = _balance_buckets(x, labels, cen, limit, rs)
    c = len(cen)
    if nprobe is None:
        # a FIXED probe count loses recall as C grows (JAX measured recall@15
        # 0.996 at C=141 / nprobe 16, 0.85 at C=224): a natural cluster
        # spans ~C/n_clusters buckets.  Scale with C up to 96, so the rerank
        # stays O(96·cap·N·D); raise nprobe for recall-critical runs.
        nprobe = min(max(16, c // 8), 96)
    nprobe = min(nprobe, c)

    # bucket member table, padded with the sentinel index N; cap rounded up
    # to a multiple of 128 as in JAX
    order = np.argsort(labels, kind="stable")
    counts = np.bincount(labels, minlength=c)
    cap = ((max(int(counts.max()), 1) + 127) // 128) * 128
    members = np.full((c, cap), n, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for b in range(c):
        members[b, : counts[b]] = order[starts[b]: starts[b] + counts[b]]

    # bucket-level probe lists by centroid distance (self is at distance 0)
    cd2 = ((cen ** 2).sum(1)[:, None] - 2.0 * (cen @ cen.T)
           + (cen ** 2).sum(1)[None, :])
    probes = np.argsort(cd2, axis=1)[:, :nprobe]

    xp = torch.cat([xd, torch.full((1, d), 1e18, device=xd.device)])
    members_d = torch.from_numpy(members).to(xd.device)
    probes_d = torch.from_numpy(probes).to(xd.device)
    group = int(min(max(RERANK_BYTES // (cap * nprobe * cap * 4), 1), c))
    nbr_b = torch.empty((c, cap, k), dtype=torch.int64, device=xd.device)
    dist_b = torch.empty((c, cap, k), dtype=torch.float32, device=xd.device)
    for g0 in range(0, c, group):
        ids = torch.arange(g0, min(g0 + group, c), device=xd.device)
        nbr_b[ids], dist_b[ids] = _rerank(xp, members_d, probes_d, ids, k)
        if verbose:
            print(f"ann rerank: {min(g0 + group, c)}/{c} buckets", flush=True)

    valid = members_d < n
    out_nbr = torch.zeros((n, k), dtype=torch.int64, device=xd.device)
    out_dist = torch.full((n, k), BIG, dtype=torch.float32, device=xd.device)
    out_nbr[members_d[valid]] = nbr_b[valid]
    out_dist[members_d[valid]] = dist_b[valid]
    # unfilled slots (inf from the rerank) → index 0 / BIG
    bad = ~torch.isfinite(out_dist) | (out_nbr >= n)
    out_nbr[bad] = 0
    out_dist[bad] = BIG
    return out_nbr.cpu().numpy(), out_dist.cpu().numpy()


def knn_recall(nbr_approx: np.ndarray, nbr_exact: np.ndarray,
               dist_approx: Optional[np.ndarray] = None) -> float:
    """Mean fraction of true k-neighbors recovered per row.

    Pass ``dist_approx`` so unfilled sentinel slots (index 0 / distance
    ``BIG``) count as misses: without it, a filler index 0 would score as a
    hit on exactly the rows where the approximation failed, whenever 0 is a
    true neighbor."""
    hits = 0
    for r, (a, b) in enumerate(zip(nbr_approx, nbr_exact)):
        if dist_approx is not None:
            a = a[dist_approx[r] < FINITE]
        hits += len(np.intersect1d(a, b, assume_unique=False))
    return hits / nbr_exact.size
