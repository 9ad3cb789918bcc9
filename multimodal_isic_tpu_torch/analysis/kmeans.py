"""k-means on the tensor's device: k-means++ initialisation, Lloyd
iterations, restarts batched.

Counterpart of ``multimodal_isic_tpu/analysis/kmeans.py`` (:1-95), the
default backbone of ``cli.cluster_latents`` (the reference's cuML stage,
``cluster_latents.py:26-35``, replaced for the purity statistics, which
take any hard assignment).

- :func:`kmeanspp_init` draws the k-means++ centers from an explicit
  ``torch.Generator`` (``torch.multinomial`` where JAX has
  ``jax.random.choice(p=…)``, so the draws are not JAX's);
- :func:`lloyd` runs ``max_iters`` Lloyd iterations from given centers, as
  JAX's ``lax.scan`` does; it stops early only at an exact fixed point,
  where every later iteration is a no-op.  Empty clusters are re-seeded at
  the globally farthest point, and ``n_iter`` counts the shifts above
  ``tol``;
- both take ``R`` restarts at once (``[R, K, D]`` centers, ``[R, N, K]``
  distances), which :func:`fit_best_of` uses in place of JAX's ``vmap``.

Distances are ``‖x‖² − 2x·cᵀ + ‖c‖²`` in full float32
(:func:`..core.precision.full_float32`), as JAX's ``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.precision import full_float32


class KMeansState(NamedTuple):
    centers: torch.Tensor  # [K, D] ([R, K, D] for restarts)
    inertia: torch.Tensor  # scalar ([R])
    n_iter: torch.Tensor   # scalar ([R])


def _pairwise_sq(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x [N, D], c [R, K, D] → squared distances [R, N, K], ≥ 0."""
    x2 = (x ** 2).sum(1)[None, :, None]
    c2 = (c ** 2).sum(2)[:, None, :]
    with full_float32():
        xc = torch.matmul(x, c.transpose(1, 2))
    return (x2 - 2.0 * xc + c2).clamp_min_(0.0)


def kmeanspp_init(generator: torch.Generator, x: torch.Tensor, k: int,
                  n_init: int = 0) -> torch.Tensor:
    """k-means++ centers [K, D] (``n_init`` > 0: ``n_init`` independent
    draws [n_init, K, D]) from ``generator``, on ``x``'s device."""
    x = torch.as_tensor(x, dtype=torch.float32)
    r, n = max(n_init, 1), x.shape[0]
    first = torch.randint(0, n, (r,), generator=generator, device=x.device)
    centers = x[first][:, None, :].repeat(1, k, 1)
    dmin = None
    for i in range(1, k):
        d2 = _pairwise_sq(x, centers[:, i - 1:i])[..., 0]          # [R, N]
        dmin = d2 if dmin is None else torch.minimum(dmin, d2)
        total = dmin.sum(1, keepdim=True)
        # every point on a center already (fewer distinct points than k):
        # any point will do
        probs = torch.where(total > 0, dmin / total.clamp_min(1e-30), 1.0)
        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        centers[:, i] = x[nxt]
    return centers if n_init else centers[0]


def lloyd(x: torch.Tensor, centers: torch.Tensor, max_iters: int = 100,
          tol: float = 1e-4) -> Tuple[KMeansState, torch.Tensor]:
    """Lloyd iterations from ``centers`` [K, D] (or [R, K, D]) → (state,
    labels [N] (or [R, N])).  JAX's ``fit`` after its initialisation."""
    x = torch.as_tensor(x, dtype=torch.float32, device=centers.device)
    batched = centers.dim() == 3
    c = (centers if batched else centers[None]).to(torch.float32)
    r, k = c.shape[:2]
    n_iter = torch.zeros(r, dtype=torch.int64, device=x.device)
    for _ in range(max_iters):
        d2 = _pairwise_sq(x, c)                                     # [R, N, K]
        dmin, labels = d2.min(2)
        onehot = torch.zeros_like(d2).scatter_(2, labels[..., None], 1.0)
        counts = onehot.sum(1)                                      # [R, K]
        with full_float32():
            sums = torch.matmul(onehot.transpose(1, 2), x)          # [R, K, D]
        new = sums / counts.clamp_min(1.0)[..., None]
        # re-seed empties at the globally farthest point
        far = x[dmin.argmax(1)]                                     # [R, D]
        new = torch.where((counts > 0)[..., None], new, far[:, None, :])
        n_iter += (((new - c) ** 2).sum((1, 2)) > tol).to(torch.int64)
        if torch.equal(new, c):  # a fixed point: the rest are no-ops
            break
        c = new
    d2 = _pairwise_sq(x, c)
    dmin, labels = d2.min(2)
    state = KMeansState(c, dmin.sum(1), n_iter)
    if batched:
        return state, labels
    return KMeansState(*(v[0] for v in state)), labels[0]


def fit(generator: torch.Generator, x, k: int, max_iters: int = 100,
        tol: float = 1e-4) -> Tuple[KMeansState, torch.Tensor]:
    """→ (state, labels [N]): k-means++ from ``generator``, then Lloyd."""
    x = torch.as_tensor(x, dtype=torch.float32, device=generator.device)
    return lloyd(x, kmeanspp_init(generator, x, k), max_iters, tol)


def predict(state: KMeansState, x) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32, device=state.centers.device)
    return _pairwise_sq(x, state.centers[None])[0].argmin(1)


def best_restart(states: KMeansState, labels: torch.Tensor
                 ) -> Tuple[KMeansState, torch.Tensor]:
    """The lowest-inertia restart of a batched :func:`lloyd` result."""
    best = int(states.inertia.argmin())
    return KMeansState(*(v[best] for v in states)), labels[best]


def fit_best_of(generator: torch.Generator, x, k: int, n_init: int = 4,
                max_iters: int = 100) -> Tuple[KMeansState, torch.Tensor]:
    """``n_init`` restarts batched, the lowest-inertia one kept (sklearn's
    ``n_init``)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=generator.device)
    return best_restart(*lloyd(x, kmeanspp_init(generator, x, k, n_init),
                               max_iters))
