"""Graph builders for patch-bag MIL, as dense adjacencies.

Counterpart of ``multimodal_isic_tpu/models/graphs.py`` (:20-163), the
reference's three builders (``utils_g_mil.py:495-605``): the patch grid
(4-neighbourhood, optionally with diagonals, self loops, row-normalised
D⁻¹(A+I)), feature kNN and random degree, each as an ``[..., N, N]`` mask:
at N = 196 patches a dense product is the natural form on the card.  Every
builder takes an optional validity mask ``[..., N]`` and builds the graph
over the bag's true nodes (the reference builds it from the real N_i
instances); leading batch dimensions build a graph a bag at once.

- kNN takes the Gram product in full float32 whatever the caller's TF32
  setting (reduced-precision products cost kNN its recall), keeps JAX's
  formula ``x2ᵢ + x2ⱼ − 2·x·xᵀ`` clamped at 0, and picks the ``kk``
  smallest distances with a stable sort, so exact ties go to the lower
  index as ``lax.top_k`` sends them.
- The random graph draws from a ``torch.Generator``; its edges are not
  JAX's (``jax.random`` and torch differ from one seed), its properties
  are: at most ``min(k, n_valid − 1)`` distinct valid non-self targets a
  node, symmetric, zero diagonal, invalid rows empty.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.precision import full_float32
from ..core.rng import generator as make_generator


@lru_cache(maxsize=None)
def build_grid_adj(num_nodes: int, connect_diagonals: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(adj_norm = D⁻¹(A+I), adj_mask with self loops), numpy float32
    [N, N], of an s×s grid (``utils_g_mil.py:495-520``; cached, as the
    reference caches it).  The callers copy before they write."""
    s = int(np.sqrt(num_nodes))
    if s * s != num_nodes:
        raise ValueError("num_nodes must be a perfect square to build grid "
                         "adjacency")
    r, c = np.divmod(np.arange(num_nodes), s)
    dr = np.abs(r[:, None] - r[None, :])
    dc = np.abs(c[:, None] - c[None, :])
    adj = (dr + dc) == 1
    if connect_diagonals:
        adj |= (dr == 1) & (dc == 1)
    mask = (adj | np.eye(num_nodes, dtype=bool)).astype(np.float32)
    return mask / mask.sum(axis=1)[:, None], mask


def build_grid_adj_dynamic(valid: torch.Tensor,
                           connect_diagonals: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid adjacency over the true bag size inside a padded ``[..., N]``
    prefix mask (JAX :49-78): a bag of n valid nodes gets an s×s grid with
    ``s = floor(sqrt(n + 0.5))`` over its first s² nodes; the other valid
    nodes (n not a square) and the padding keep self loops only.
    → (adj_norm, adj_mask incl. self loops), both ``[..., N, N]`` float32."""
    n = valid.shape[-1]
    n_valid = valid.to(torch.int32).sum(-1)
    s = torch.floor(torch.sqrt(n_valid.float() + 0.5)).long().clamp_min(1)
    s = s[..., None]
    idx = torch.arange(n, device=valid.device)
    r, c = idx // s, idx % s
    in_grid = idx < s * s
    dr = (r[..., :, None] - r[..., None, :]).abs()
    dc = (c[..., :, None] - c[..., None, :]).abs()
    neigh = (dr + dc) == 1
    if connect_diagonals:
        neigh = neigh | ((dr == 1) & (dc == 1))
    adj = neigh & in_grid[..., :, None] & in_grid[..., None, :]
    eye = torch.eye(n, dtype=torch.bool, device=valid.device)
    adj_mask = (adj | eye).float()
    return adj_mask / adj_mask.sum(-1, keepdim=True), adj_mask


def build_knn_adj(x: torch.Tensor, k: int = 8,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Directed kNN mask ``[..., N, N]`` from node features ``[..., N, F]``
    (squared euclidean, self excluded; JAX :81-108, the dense form of
    ``build_knn_edge_index``, ``utils_g_mil.py:527-546``).  With ``valid``,
    neighbours come from the true nodes only: each valid node gets
    ``min(k, n_valid − 1)`` of them, invalid rows stay empty."""
    n = x.shape[-2]
    x = x.float()
    x2 = (x ** 2).sum(-1)
    with full_float32():
        gram = torch.matmul(x, x.transpose(-1, -2))
    d2 = (x2[..., :, None] + x2[..., None, :] - 2.0 * gram).clamp_min(0.0)
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d2 = d2.masked_fill(eye, float("inf"))
    if valid is not None:
        d2 = d2.masked_fill(~valid[..., None, :].bool(), float("inf"))
    kk = min(k, n - 1)
    vals, order = torch.sort(d2, dim=-1, stable=True)
    keep = torch.isfinite(vals[..., :kk]).float()
    adj = torch.zeros_like(d2).scatter(-1, order[..., :kk], keep)
    if valid is not None:
        adj = adj * valid[..., :, None].float()
    return adj


def build_random_adj(num_nodes: int, k: int = 4,
                     valid: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """Each node draws up to k distinct non-self targets among the valid
    nodes, then the graph is symmetrised (JAX :111-132,
    ``utils_g_mil.py:581-602``) → ``[..., N, N]`` float32 (the batch
    dimensions those of ``valid``).  Draws from ``generator`` (on the
    device of ``valid``, or ``device``)."""
    if valid is None:
        valid = torch.ones(num_nodes, dtype=torch.bool, device=device)
    v = valid.bool()
    u = torch.rand(v.shape[:-1] + (num_nodes, num_nodes), generator=generator,
                   device=v.device)
    eye = torch.eye(num_nodes, dtype=torch.bool, device=v.device)
    score = u.masked_fill(~v[..., None, :] | eye, float("inf"))
    vals, chosen = torch.topk(score, min(k, num_nodes), dim=-1,
                              largest=False)
    adj = torch.zeros_like(u).scatter(-1, chosen,
                                      torch.isfinite(vals).float())
    adj = adj * v[..., :, None].float()  # invalid sources emit nothing
    adj = torch.maximum(adj, adj.transpose(-1, -2))  # undirected
    return adj.masked_fill(eye, 0.0)


def build_graph(x: torch.Tensor, graph_type: str = "grid",
                k: Optional[int] = None, connect_diagonals: bool = False,
                generator: Optional[torch.Generator] = None,
                valid: Optional[torch.Tensor] = None):
    """The reference's dispatch (``utils_g_mil.py:549-605``; JAX :135-157)
    → (adj_norm or None, adj_mask ``[..., N, N]``): both for 'grid', the
    mask alone for 'knn' and 'random'.  The random graph draws from
    ``generator``, by default one seeded with 0 (JAX's ``PRNGKey(0)``)."""
    n = x.shape[-2]
    if graph_type == "grid":
        if valid is not None:
            return build_grid_adj_dynamic(valid, connect_diagonals)
        norm, mask = build_grid_adj(n, connect_diagonals)
        return (torch.from_numpy(norm.copy()).to(x.device),
                torch.from_numpy(mask.copy()).to(x.device))
    if graph_type == "knn":
        return None, build_knn_adj(x, 8 if k is None else int(k), valid)
    if graph_type == "random":
        if generator is None:
            generator = make_generator(0, x.device)
        if valid is None:
            valid = torch.ones(x.shape[:-1], dtype=torch.bool,
                               device=x.device)
        return None, build_random_adj(n, 4 if k is None else int(k), valid,
                                      generator)
    raise ValueError(f"Unsupported graph_type='{graph_type}'. Supported "
                     "types: 'grid', 'knn'.")


def adj_to_edge_index(adj_mask) -> np.ndarray:
    """[2, E] edge list in row-major order, for the reference's API."""
    if isinstance(adj_mask, torch.Tensor):
        adj_mask = adj_mask.detach().cpu().numpy()
    src, dst = np.nonzero(np.asarray(adj_mask))
    return np.stack([src, dst])
