"""Neighbour-graph embedding and density clustering on the card.

Counterpart of ``multimodal_isic_tpu/analysis/embed.py`` (:1-582), the
reference's cuML UMAP + HDBSCAN stage (``cluster_latents.py:26-44,
175-225``):

- :func:`knn_graph`: the exact kNN graph a block of rows at a time
  (``[block, N]`` distances, never ``[N, N]``), self excluded, euclidean or
  cosine; :func:`knn` dispatches to it or to :func:`.ann.approx_knn_graph`;
- :func:`neighbor_embedding`: a LargeVis/UMAP-style layout of the graph
  (fuzzy edge weights, student-t kernel, negative samples an epoch),
  full-batch Adam from a PCA init.  An epoch (:func:`_layout_epoch`) takes
  its ``[N, n_neg]`` negative indices as an argument; :func:`_optimize_layout`
  draws them from a ``torch.Generator`` seeded by (seed, epoch), so a run
  in chunks or resumed from a checkpoint replays the same draws.  The loss
  is taken ``n_seg`` edge/row segments at a time, each segment's backward
  run before the next forward, which bounds the peak memory;
- :func:`density_cluster` (DBSCAN* over the mutual-reachability graph at
  one density level) and :func:`hdbscan_cluster` (connected components at
  a ladder of density levels, batched, then the condensed tree and
  excess-of-mass selection on the host, JAX's numpy copied), both with the
  ``-1`` noise label.  Components come from min-label propagation both ways
  along the stored edges plus pointer jumping.

Two faults of the JAX module are not copied (ROADMAP C2, C3): a layout
checkpoint is resumed only when a fingerprint of its inputs (y0, the graph,
its weights, seed, epochs, lr, n_neg, repulsion) matches, and it is deleted
when the run completes; ``grad_segments`` rounds up, so no segment holds
more than ``EDGES_A_SEGMENT`` edges (:func:`layout_segments`).

Distance products run in full float32 (:func:`..core.precision.
full_float32`), as JAX's ``Precision.HIGHEST``.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.precision import full_float32
from ..core.rng import RngStream
from . import pca as PCA
from .ann import FINITE

Device = Union[str, torch.device]
EDGES_A_SEGMENT = 8_000_000  # ~0.6 GB of 20-d float32 edge gathers
BLOCK_ELEMENTS = 1 << 28     # [block, N] distances of the exact graph (1 GiB)
LABEL_ELEMENTS = 1 << 28     # [levels, N, k] elements a level group


def _device_of(x, device: Optional[Device]) -> torch.device:
    if device is not None:
        return torch.device(device)
    return x.device if torch.is_tensor(x) else torch.device("cuda")


def knn_graph(x, k: int = 15, metric: str = "euclidean", block: int = 4096,
              rows: Optional[torch.Tensor] = None,
              device: Optional[Device] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (nbr [R, k] indices, dist [R, k]) on the device, self excluded,
    nearest first, for the ``rows`` (all N by default).  'cosine'
    normalises the rows first.  A block of at most ``block`` query rows at
    a time, fewer where ``[block, N]`` would pass ``BLOCK_ELEMENTS``."""
    x = torch.as_tensor(x, dtype=torch.float32,
                        device=_device_of(x, device))
    if metric == "cosine":
        x = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
    elif metric != "euclidean":
        raise ValueError(f"unsupported metric {metric!r}")
    n = x.shape[0]
    kk = min(k, n - 1)
    rows = torch.arange(n, device=x.device) if rows is None else rows
    block = max(1, min(block, BLOCK_ELEMENTS // n))
    x2 = (x ** 2).sum(1)[None, :]
    nbrs, dists = [], []
    for s in range(0, len(rows), block):
        idx = rows[s:s + block]
        q = x[idx]
        with full_float32():
            d2 = q @ x.T
        # ‖q‖² − 2q·x + ‖x‖² in place, rounded as that expression
        d2.mul_(-2.0).add_((q ** 2).sum(1)[:, None]).add_(x2).clamp_min_(0.0)
        d2[torch.arange(len(idx), device=x.device), idx] = torch.inf
        d, nb = torch.topk(d2, kk, dim=1, largest=False)
        nbrs.append(nb)
        dists.append(d.sqrt_())
    return torch.cat(nbrs), torch.cat(dists)


def knn(x, k: int = 15, metric: str = "euclidean", method: str = "exact",
        device: Optional[Device] = None, **ann_kwargs
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN dispatcher: ``'exact'`` → :func:`knn_graph` (O(N²·D)),
    ``'approx'`` → :func:`.ann.approx_knn_graph` (O(N^1.5·D)), the path for
    the reference's 2M-row table.  ``ann_kwargs`` (nprobe, n_buckets, seed,
    ...) go to the approximate path only."""
    dev = _device_of(x, device)
    if method == "approx":
        from .ann import approx_knn_graph
        x = x.cpu().numpy() if torch.is_tensor(x) else x
        nbr, dist = approx_knn_graph(np.asarray(x), k, metric, device=dev,
                                     **ann_kwargs)
        return torch.from_numpy(nbr).to(dev), torch.from_numpy(dist).to(dev)
    if method != "exact":
        raise ValueError(f"method must be exact|approx, got {method!r}")
    if ann_kwargs:
        raise TypeError(  # loud, not silent: the knob would do nothing
            f"ann kwargs {sorted(ann_kwargs)} only apply to method='approx'")
    return knn_graph(x, k, metric, device=dev)


# ------------------------------------------------------------- embedding

def _core_distance(dist: torch.Tensor, min_samples: int) -> torch.Tensor:
    """hdbscan/cuML core distance: the distance to the ``min_samples``-th
    nearest neighbour COUNTING the point itself, i.e. the
    (min_samples−1)-th other point; ``dist`` excludes self, so the column is
    ``min_samples − 2``; ``min_samples ≤ 1`` gives 0."""
    if min_samples <= 1:
        return torch.zeros(dist.shape[0], dtype=dist.dtype,
                           device=dist.device)
    return dist[:, min(min_samples - 1, dist.shape[1]) - 1]


def _fuzzy_weights(dist: torch.Tensor) -> torch.Tensor:
    """UMAP-style local kernel w = exp(−(d − ρ)/σ): ρ the nearest distance,
    σ the mean excess distance.  Sentinel slots (≥ ``FINITE``) are absent
    edges: weight 0, left out of ρ and σ."""
    valid = dist < FINITE
    rho = torch.where(valid[:, :1], dist[:, :1], 0.0)
    excess = (dist - rho).clamp_min(0.0)
    denom = valid.sum(1, keepdim=True).clamp_min(1)
    sigma = (torch.where(valid, excess, 0.0).sum(1, keepdim=True)
             / denom).clamp_min(1e-6)
    return torch.where(valid, torch.exp(-excess / sigma), 0.0)


def layout_segments(n_edges: int) -> int:
    """Segments of the layout's loss: at most ``EDGES_A_SEGMENT`` edges
    each (ceiling division; JAX floors, ROADMAP C3)."""
    return max(1, -(-n_edges // EDGES_A_SEGMENT))


def _layout_epoch(carry, nbr: torch.Tensor, w: torch.Tensor,
                  neg_idx: torch.Tensor, lr: float = 0.1,
                  repulsion: float = 1.0, n_seg: int = 1):
    """One layout epoch → the next (y, m, v, t): attraction along the kNN
    edges, repulsion from the negative samples ``neg_idx`` [N, n_neg],
    kernel q = 1/(1 + d²), one full-batch Adam step (JAX ``_layout_chunk``'s
    ``step``, :214-224).  The loss is summed over ``n_seg`` segments of the
    edges and of the rows, each segment's gradient taken before the next
    segment's forward."""
    y, m, v, t = carry
    n, k = nbr.shape
    rows = torch.arange(n, device=y.device).repeat_interleave(k)
    cols, wf = nbr.reshape(-1), w.reshape(-1)
    e_seg, r_seg = -(-(n * k) // n_seg), -(-n // n_seg)
    yl = y.detach().requires_grad_(True)
    g = torch.zeros_like(y)
    for s in range(n_seg):
        e = slice(s * e_seg, (s + 1) * e_seg)
        r = slice(s * r_seg, (s + 1) * r_seg)
        with torch.enable_grad():
            d2e = ((yl[rows[e]] - yl[cols[e]]) ** 2).sum(-1)
            attract = (wf[e] * torch.log1p(d2e)).sum()
            d2n = ((yl[r, None, :] - yl[neg_idx[r]]) ** 2).sum(-1)
            repel = -torch.log(d2n / (1.0 + d2n) + 1e-6).sum()
            loss = (attract + repulsion * repel) / n
        g += torch.autograd.grad(loss, yl)[0]
    t = t + 1.0
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    one = torch.ones((), dtype=torch.float32, device=y.device)
    m_hat = m / (1.0 - (0.9 * one) ** t)
    v_hat = v / (1.0 - (0.999 * one) ** t)
    y = y - lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
    return y, m, v, t


def _layout_chunk(carry, negs: Sequence[torch.Tensor], nbr: torch.Tensor,
                  w: torch.Tensor, lr: float = 0.1, repulsion: float = 1.0,
                  n_seg: int = 1):
    """A chunk of layout epochs, one a negative draw of ``negs``; the (y, m,
    v, t) carry crosses chunks, so chunks in sequence are one run."""
    for neg_idx in negs:
        carry = _layout_epoch(carry, nbr, w, neg_idx, lr, repulsion, n_seg)
    return carry


def _negatives(seed: int, epoch: int, n: int, n_neg: int,
               device: torch.device) -> torch.Tensor:
    """The epoch's negative samples [N, n_neg], a function of (seed,
    epoch) only."""
    gen = RngStream(seed, "layout_negatives", device).at(epoch)
    return torch.randint(0, n, (n, n_neg), generator=gen, device=device)


def _fingerprint(y0, nbr, w, seed, n_epochs, lr, n_neg, repulsion) -> str:
    h = hashlib.sha256()
    for t in (y0, nbr, w):
        h.update(str((tuple(t.shape), str(t.dtype))).encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    h.update(repr((int(seed), int(n_epochs), float(lr), int(n_neg),
                   float(repulsion))).encode())
    return h.hexdigest()


def _optimize_layout(y0: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                     seed: int, n_epochs: int = 200, n_neg: int = 5,
                     lr: float = 0.1, repulsion: float = 1.0,
                     epoch_chunk: int = 50, n_seg: int = 1,
                     checkpoint_dir: Optional[str] = None,
                     checkpoint_every: int = 50,
                     verbose: bool = False) -> torch.Tensor:
    """The epoch loop in chunks of ``epoch_chunk``.  ``checkpoint_dir``
    keeps the Adam carry every ``checkpoint_every`` epochs (an atomic npz
    with a fingerprint of the inputs) and resumes from it only when the
    fingerprint matches; the file is deleted when the run completes."""
    n = y0.shape[0]
    carry = (y0, torch.zeros_like(y0), torch.zeros_like(y0),
             torch.zeros((), dtype=torch.float32, device=y0.device))
    start = 0
    ck = (os.path.join(checkpoint_dir, "layout_carry.npz")
          if checkpoint_dir else None)
    stamp = (_fingerprint(y0, nbr, w, seed, n_epochs, lr, n_neg, repulsion)
             if ck else None)
    if ck and os.path.exists(ck):
        with np.load(ck) as blob:
            if str(blob["fingerprint"]) == stamp:
                carry = tuple(torch.from_numpy(blob[name]).to(y0.device)
                              for name in ("y", "m", "v", "t"))
                start = int(blob["epoch"])
                if verbose:
                    print(f"layout: resumed at epoch {start}", flush=True)
            elif verbose:
                print("layout: checkpoint of other inputs ignored",
                      flush=True)
    s, last_saved = start, start
    while s < n_epochs:
        e = min(s + epoch_chunk, n_epochs)
        negs = (_negatives(seed, ep, n, n_neg, y0.device)
                for ep in range(s, e))
        carry = _layout_chunk(carry, negs, nbr, w, lr, repulsion, n_seg)
        s = e
        if verbose:
            print(f"layout epochs {s}/{n_epochs}", flush=True)
        if ck and s < n_epochs and s - last_saved >= checkpoint_every:
            os.makedirs(checkpoint_dir, exist_ok=True)
            blob = {name: c.cpu().numpy() for name, c in
                    zip(("y", "m", "v", "t"), carry)}
            np.savez(ck + ".tmp.npz", epoch=s, fingerprint=stamp, **blob)
            os.replace(ck + ".tmp.npz", ck)
            last_saved = s
            if verbose:
                print(f"layout: checkpointed epoch {s}", flush=True)
    if ck and os.path.exists(ck):
        os.remove(ck)
    return carry[0]


def neighbor_embedding(x, n_components: int = 2, n_neighbors: int = 15,
                       n_epochs: int = 500, metric: str = "euclidean",
                       seed: int = 0, lr: float = 0.05,
                       knn_method: str = "exact",
                       knn_kwargs: Optional[dict] = None,
                       precomputed_knn: Optional[tuple] = None,
                       epoch_chunk: int = 50,
                       grad_segments: Optional[int] = None,
                       layout_checkpoint_dir: Optional[str] = None,
                       checkpoint_every: int = 50, verbose: bool = False,
                       device: Optional[Device] = None) -> np.ndarray:
    """kNN-graph layout → [N, n_components] numpy.  A PCA init scaled to a
    standard deviation of 0.1 (UMAP's convention) keeps the global
    structure; the layout recovers the local neighbourhoods.
    ``precomputed_knn=(nbr, dist)`` skips the graph build (cuML UMAP's
    ``precomputed_knn``): at 2M rows the graph is the dominant cost and the
    clustering can take the same graph."""
    dev = _device_of(x, device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    if precomputed_knn is not None:
        nbr = torch.as_tensor(precomputed_knn[0], device=dev)[:, :n_neighbors]
        dist = torch.as_tensor(precomputed_knn[1],
                               device=dev)[:, :n_neighbors]
    else:
        nbr, dist = knn(x, n_neighbors, metric, method=knn_method,
                        device=dev, **(knn_kwargs or {}))
    w = _fuzzy_weights(dist)
    comps = min(n_components, x.shape[1], x.shape[0])
    y0 = PCA.transform(PCA.fit(x, comps), x)[:, :n_components]
    if y0.shape[1] < n_components:
        y0 = torch.nn.functional.pad(y0, (0, n_components - y0.shape[1]))
    y0 = y0 / max(float(y0.std(correction=0)), 1e-9) * 0.1
    if grad_segments is None:
        grad_segments = layout_segments(nbr.numel())
    y = _optimize_layout(y0, nbr, w, seed, n_epochs=n_epochs, lr=lr,
                         epoch_chunk=epoch_chunk, n_seg=grad_segments,
                         checkpoint_dir=layout_checkpoint_dir,
                         checkpoint_every=checkpoint_every, verbose=verbose)
    return y.cpu().numpy()


# ------------------------------------------------------ density clustering

def _connected_components(nbr: torch.Tensor, edge_ok: torch.Tensor,
                          n_iters: int = 64) -> torch.Tensor:
    """Min-label propagation over masked kNN edges, both ways along each
    edge, with pointer jumping (label ← label[label]); edge_ok [..., N, k]
    → labels [..., N] (leading dims: density levels).

    Labels flow both ways: the mutual-reachability rule is symmetric, the
    kNN rows are not, and pull-only propagation would split a component
    whose dense side does not list the sparse side's edge.  The loop stops
    early only at a fixed point, where the rest are no-ops."""
    n, k = nbr.shape
    lead = edge_ok.shape[:-2]
    label = torch.arange(n, device=nbr.device).expand(*lead, n).clone()
    tgt = torch.where(edge_ok, nbr, n).reshape(*lead, n * k)
    for _ in range(n_iters):
        nbr_labels = torch.where(edge_ok, label[..., nbr], n)
        new = torch.minimum(label, nbr_labels.amin(-1))
        src = new[..., :, None].expand(*lead, n, k).reshape(*lead, n * k)
        ext = torch.cat([new, torch.full((*lead, 1), n, dtype=new.dtype,
                                         device=new.device)], -1)
        new = ext.scatter_reduce_(-1, tgt, src, "amin")[..., :-1]
        new = torch.minimum(new, torch.gather(new, -1, new))  # pointer jump
        if torch.equal(new, label):
            break
        label = new
    return label


def _iters(n: int) -> int:
    return max(8, int(np.ceil(np.log2(max(n, 2)))) * 4)


def _graph(x, k, min_samples, metric, knn_method, knn_kwargs,
           precomputed_knn, dev):
    if precomputed_knn is not None:
        return (torch.as_tensor(precomputed_knn[0], device=dev),
                torch.as_tensor(precomputed_knn[1], device=dev))
    x = np.asarray(x.cpu() if torch.is_tensor(x) else x, np.float32)
    kk = k or max(min_samples + 1, 16)
    return knn(x, min(kk, x.shape[0] - 1), metric, method=knn_method,
               device=dev, **(knn_kwargs or {}))


def density_cluster(x, min_cluster_size: int = 50, min_samples: int = 10,
                    eps: Optional[float] = None, eps_scale: float = 2.0,
                    k: Optional[int] = None, metric: str = "euclidean",
                    knn_method: str = "exact",
                    knn_kwargs: Optional[dict] = None,
                    precomputed_knn: Optional[tuple] = None,
                    device: Optional[Device] = None) -> np.ndarray:
    """DBSCAN* over the mutual-reachability graph → labels [N] with −1
    noise: core distance = distance to the ``min_samples``-th neighbour;
    points connect when max(core_i, core_j, d_ij) ≤ eps; non-core points
    and clusters under ``min_cluster_size`` are noise.  ``eps`` defaults to
    ``eps_scale ×`` the median finite core distance (HDBSCAN instead picks a
    level a cluster: :func:`hdbscan_cluster`)."""
    dev = _device_of(x, device)
    n = x.shape[0]
    nbr, dist = _graph(x, k, min_samples, metric, knn_method, knn_kwargs,
                       precomputed_knn, dev)
    core = _core_distance(dist, min_samples)
    if eps is None:
        # approx kNN marks unfilled slots with BIG: such a core distance is
        # noise at any level and must not move the median
        core_np = core.cpu().numpy()
        finite = core_np[core_np < FINITE]
        if len(finite) == 0:
            return np.full(n, -1, int)
        eps = eps_scale * np.median(finite)
    eps = torch.tensor(eps, dtype=torch.float32, device=dev)

    mreach = torch.maximum(dist, torch.maximum(core[:, None], core[nbr]))
    is_core = core <= eps
    edge_ok = (mreach <= eps) & is_core[:, None] & is_core[nbr]
    label = _connected_components(nbr, edge_ok, _iters(n)).cpu().numpy()
    label[~is_core.cpu().numpy()] = -1

    # compact ids; small clusters → noise
    out = np.full(n, -1, int)
    uniq, counts = np.unique(label[label >= 0], return_counts=True)
    next_id = 0
    for u, c in zip(uniq, counts):
        if c >= min_cluster_size:
            out[label == u] = next_id
            next_id += 1
    return out


# ------------------------------------------- hierarchical (HDBSCAN) variant

def _labels_at_levels(nbr: torch.Tensor, dist: torch.Tensor,
                      core: torch.Tensor, eps_levels: torch.Tensor,
                      n_iters: int) -> torch.Tensor:
    """Component labels of the mutual-reachability graph at every eps of
    ``eps_levels`` → [L, N] (−1 for non-core points).  The levels share the
    kNN structure and differ in the edge mask, so a group of levels is one
    batched propagation (``LABEL_ELEMENTS`` of ``[L, N, k]`` a group)."""
    mreach = torch.maximum(dist, torch.maximum(core[:, None], core[nbr]))
    group = max(1, LABEL_ELEMENTS // max(nbr.numel(), 1))
    out = []
    for s in range(0, len(eps_levels), group):
        eps = eps_levels[s:s + group, None]                        # [G, 1]
        is_core = core[None, :] <= eps                             # [G, N]
        edge_ok = ((mreach[None] <= eps[..., None]) & is_core[..., None]
                   & is_core[:, nbr])
        lab = _connected_components(nbr, edge_ok, n_iters)
        out.append(torch.where(is_core, lab, -1))
    return torch.cat(out)


def _condense_and_select(levels_labels: np.ndarray, lam: np.ndarray,
                         min_cluster_size: int,
                         allow_single_cluster: bool = False) -> np.ndarray:
    """Condensed tree + excess-of-mass selection over discrete density
    levels (JAX :446-529, copied).

    ``levels_labels[l]`` are component labels at level ``l`` (coarse →
    fine, ``lam`` = 1/eps strictly increasing); a cluster node persists
    while it keeps ≥ ``min_cluster_size`` points and splits only when ≥ 2
    children clear that bar (HDBSCAN's condensed-tree rule).  Node stability
    accumulates Σ |alive members| · Δλ; a parent is selected iff its own
    stability beats the summed selected-stability of its children."""
    n_levels, n = levels_labels.shape

    # ---- build nodes: birth members, per-level alive counts, children
    nodes = []  # dict(parent, birth_level, members, alive_hist=[(level,count)])
    cur = np.full(n, -1, np.int64)       # point -> node id
    roots = []
    for comp in np.unique(levels_labels[0]):
        if comp < 0:
            continue
        members = np.where(levels_labels[0] == comp)[0]
        if len(members) < min_cluster_size:
            continue
        nodes.append({"parent": -1, "birth": 0, "members": members,
                      "children": [], "stab": 0.0})
        cur[members] = len(nodes) - 1
        roots.append(len(nodes) - 1)

    for l in range(1, n_levels):
        dlam = lam[l] - lam[l - 1]
        lab = levels_labels[l]
        for nid in [i for i in np.unique(cur) if i >= 0]:
            pts = np.where(cur == nid)[0]
            nodes[nid]["stab"] += len(pts) * dlam  # alive over [λ_{l-1}, λ_l)
            sub = lab[pts]
            comps, counts = np.unique(sub[sub >= 0], return_counts=True)
            big = comps[counts >= min_cluster_size]
            if len(big) >= 2:               # true split: node dies here
                for comp in big:
                    members = pts[sub == comp]
                    nodes.append({"parent": nid, "birth": l,
                                  "members": members, "children": [],
                                  "stab": 0.0})
                    cid = len(nodes) - 1
                    nodes[nid]["children"].append(cid)
                    cur[members] = cid
                cur[pts[~np.isin(sub, big)]] = -1   # fall-outs
            elif len(big) == 1:             # continuation; shed fall-outs
                cur[pts[sub != big[0]]] = -1
            else:                           # node evaporates
                cur[pts] = -1

    if not nodes:
        return np.full(n, -1, int)

    # ---- excess-of-mass selection (children processed before parents)
    selected = np.zeros(len(nodes), bool)
    sel_stab = np.zeros(len(nodes))
    for nid in range(len(nodes) - 1, -1, -1):
        node = nodes[nid]
        child_sum = sum(sel_stab[c] for c in node["children"])
        # HDBSCAN's allow_single_cluster=False: a lone root is never selected
        # (its points are noise unless a selected descendant claims them)
        root_barred = (node["parent"] == -1 and len(roots) == 1
                       and not allow_single_cluster)
        if root_barred or (node["children"] and node["stab"] <= child_sum):
            sel_stab[nid] = child_sum     # keep the children (possibly none)
        else:
            sel_stab[nid] = node["stab"]
            selected[nid] = True
            # deselect all descendants
            stack = list(node["children"])
            while stack:
                c = stack.pop()
                selected[c] = False
                stack.extend(nodes[c]["children"])

    out = np.full(n, -1, int)
    next_id = 0
    for nid in range(len(nodes)):
        if selected[nid]:
            out[nodes[nid]["members"]] = next_id
            next_id += 1
    return out


def hdbscan_cluster(x, min_cluster_size: int = 50, min_samples: int = 10,
                    n_levels: int = 24, k: Optional[int] = None,
                    metric: str = "euclidean",
                    allow_single_cluster: bool = False,
                    knn_method: str = "exact",
                    knn_kwargs: Optional[dict] = None,
                    precomputed_knn: Optional[tuple] = None,
                    device: Optional[Device] = None) -> np.ndarray:
    """Hierarchical density clustering → labels [N] with −1 noise: the
    reference's ``HDBSCAN(min_cluster_size=50, min_samples=10)``
    (``cluster_latents.py:32``) as components at ``n_levels`` geometrically
    spaced eps levels on the card, then the condensed tree and
    excess-of-mass selection on the host, a density level a cluster."""
    dev = _device_of(x, device)
    n = x.shape[0]
    nbr, dist = _graph(x, k, min_samples, metric, knn_method, knn_kwargs,
                       precomputed_knn, dev)
    core = _core_distance(dist, min_samples)
    core_np = core.cpu().numpy()
    # unfilled approx slots (BIG) are noise at any eps and must not stretch
    # the ladder
    finite = core_np[core_np < FINITE]
    if len(finite) == 0:
        return np.full(int(n), -1, int)
    # the ladder spans every core-distance scale: the coarsest level
    # connects nearly everything, the finest sits below the densest
    # cluster's working level
    lo = max(float(np.quantile(finite, 0.05)), 1e-6)
    hi = max(float(finite.max()) * 1.5, lo * 2.0)
    eps_levels = np.geomspace(hi, lo, n_levels).astype(np.float32)
    labels = _labels_at_levels(nbr, dist, core,
                               torch.from_numpy(eps_levels).to(dev),
                               _iters(n)).cpu().numpy()
    lam = 1.0 / eps_levels  # increasing: coarse → fine
    return _condense_and_select(labels, lam, min_cluster_size,
                                allow_single_cluster)
