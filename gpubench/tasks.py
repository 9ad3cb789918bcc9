"""What the builders share: the seeded input pools, the gather order of the
resident training loop, the first steps that the comparison reads, and the
comparisons themselves.

An inference task (``drivers/infer_closed.py``) gives ``pool`` (host
tensors, dim 0 the pool's rows), ``preprocess(batch)`` and ``model(x,
batch)`` (the port's calls the window times), ``release()`` and
``reference(batch, lowp)``; :func:`infer_numbers` compares.

A training task (``drivers/train_resident.py``) subclasses
:class:`TrainTask`: ``augment(batch)`` and ``model_step(x, batch)`` are the
port's calls, ``grad_leaves()`` reads the first gradient as the optimizer
got it, and ``reference_steps(n, control)`` runs the plain reference over
the same rows from the same seed.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from .common import sub_seed


def generator(seed: int, purpose: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, purpose))
    return g


def uint8_noise(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Seeded uint8 noise on ``device``, one draw."""
    return torch.randint(0, 256, tuple(shape), generator=gen, device=device,
                         dtype=torch.uint8)


def to_host(dev: torch.Tensor, pin: bool, rows: int = 128) -> torch.Tensor:
    """A device tensor copied to host memory (pinned on a card), by blocks
    of rows."""
    out = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=pin)
    for s in range(0, dev.shape[0], rows):
        out[s:s + rows].copy_(dev[s:s + rows])
    return out


def fusion_meta(gen: torch.Generator, n: int, cfg: Dict, device
                ) -> Dict[str, torch.Tensor]:
    """Seeded metadata columns of ``n`` requests: radiomics, age, sex,
    anatomical site, artifact flags and the diagnosis."""
    dev = device
    return {
        "radiomics": torch.randn(n, cfg["radiomics_dim"], generator=gen,
                                 device=dev),
        "age": torch.randn(n, generator=gen, device=dev),
        "sex": torch.randint(0, cfg["num_sex_classes"], (n,), generator=gen,
                             device=dev),
        "loc": torch.randint(0, cfg["num_loc_classes"], (n,), generator=gen,
                             device=dev),
        "artifacts": torch.randint(0, 2, (n, cfg["num_artifact_classes"]),
                                   generator=gen, device=dev),
        "target": torch.randint(0, cfg["num_classes"], (n,), generator=gen,
                                device=dev),
    }


def infer_numbers(kind: str, outs: List[torch.Tensor],
                  refs: List[torch.Tensor]) -> Dict[str, float]:
    """The numbers an inference cell compares, over the sampled batches:

    - ``logits``: ``logit_err``, the largest |program − reference| of any
      logit over the reference logits' RMS;
    - ``latents``: ``latent_err``, the largest relative L2 error of one
      image's latents, ‖program − reference‖ / ‖reference‖.
    """
    o = torch.stack([t.double() for t in outs])
    r = torch.stack([t.double() for t in refs])
    if kind == "logits":
        rms = r.pow(2).mean().sqrt().clamp_min(1e-30)
        return {"logit_err": float((o - r).abs().max() / rms)}
    if kind == "latents":
        o, r = o.flatten(0, 1).flatten(1), r.flatten(0, 1).flatten(1)
        rel = (o - r).norm(dim=1) / r.norm(dim=1).clamp_min(1e-30)
        return {"latent_err": float(rel.max())}
    raise ValueError(f"no comparison {kind!r}")


# ------------------------------------------------------------- training

def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = sorted(tensors)
    vals = torch.stack([tensors[n].detach().double().norm() for n in names])
    return dict(zip(names, vals.cpu().tolist()))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[List[str]] = None) -> Dict[str, float]:
    """Each leaf's |‖program‖ − ‖reference‖| over the larger of the leaf's
    reference norm and the median leaf's."""
    names = sorted(ref) if keep is None else keep
    med = float(np.median([ref[n] for n in names]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``loss_err``: the largest relative gap of a compared step's loss;
    ``grad_err``: the worst of :func:`leaf_gaps` of the first gradient's
    leaf norms; ``delta_err``: the worst of the parameters' change over the
    compared steps, over the leaves whose reference gradient is at least a
    thousandth of the median leaf's (the others move by round-off
    alone)."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["losses"], ref["losses"]))
    g = ref["grad"]
    med = float(np.median(list(g.values())))
    moved = [n for n in sorted(g) if g[n] >= 1e-3 * med]
    grad = leaf_gaps(prog["grad"], g)
    delta = leaf_gaps(prog["delta"], ref["delta"], moved)
    g_leaf, d_leaf = max(grad, key=grad.get), max(delta, key=delta.get)
    print(f"gpubench: worst leaves: gradient {g_leaf}, change {d_leaf}; "
          f"{len(g) - len(moved)} leaves left out of the change",
          file=sys.stderr)
    return {"loss_err": loss, "grad_err": grad[g_leaf],
            "delta_err": delta[d_leaf]}


class TrainTask:
    """The resident training loop's state: a pool of crops on the device,
    the order that gathers each step's rows (a seeded permutation an epoch,
    the last partial batch dropped), and the port's training-step object
    that the first steps and the window drive.

    Subclasses set ``self.images`` (uint8 [N, H, W, 3] on the device),
    ``self.meta`` (columns, possibly empty), ``self.model`` and
    ``self.optimizer``, and define ``augment``, ``model_step``,
    ``grad_leaves`` and ``reference_steps``."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.batch = int(traffic["batch"])
        self.meta: Dict[str, torch.Tensor] = {}

    def make_order(self) -> None:
        """[steps, B] gather rows on the device for ``order_epochs``
        epochs, made once so the window copies nothing to the card."""
        n = self.images.shape[0]
        per = n // self.batch
        rng = np.random.RandomState(sub_seed(self.seed, "order") % 2 ** 32)
        rows = [rng.permutation(n)[:per * self.batch]
                for _ in range(int(self.traffic["order_epochs"]))]
        self.order = torch.as_tensor(np.concatenate(rows).reshape(
            -1, self.batch), dtype=torch.long, device=self.device)

    def gather(self, k: int) -> Dict[str, torch.Tensor]:
        idx = self.order[k % self.order.shape[0]]
        out = {key: v.index_select(0, idx) for key, v in self.meta.items()}
        out["image_u8"] = self.images.index_select(0, idx)
        return out

    def step(self, k: int):
        batch = self.gather(k)
        return self.model_step(self.augment(batch), batch)

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def first_steps(self, n: int) -> Dict:
        """Steps 1..n through the window's own calls, with what the
        comparison reads: each step's loss, the first gradient's leaf
        norms, and the leaf norms of the parameters' change over the n
        steps."""
        p0 = {k: v.detach().clone() for k, v in self.params().items()}
        losses, grad = [], None
        for k in range(n):
            losses.append(self.step(k))
            if k == 0:
                grad = _norms(self.grad_leaves())
        delta = _norms({k: v.detach() - p0[k]
                        for k, v in self.params().items()})
        return {"losses": [float(x) for x in losses], "grad": grad,
                "delta": delta}

    @staticmethod
    def reference_result(losses, grad, p0, p_end) -> Dict:
        return {"losses": [float(x) for x in losses], "grad": _norms(grad),
                "delta": _norms({k: p_end[k] - p0[k] for k in p0})}


def adamw_(p: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor],
           state: Dict, t: int, lrs: Dict[str, float], wd: float,
           betas=(0.9, 0.95), eps: float = 1e-8) -> None:
    """One AdamW step in place (decoupled decay on the old weights)."""
    b1, b2 = betas
    for k in p:
        m, v = state.setdefault(k, (torch.zeros_like(p[k]),
                                    torch.zeros_like(p[k])))
        m.mul_(b1).add_(g[k], alpha=1 - b1)
        v.mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
        p[k].mul_(1 - lrs[k] * wd)
        denom = v.sqrt() / math.sqrt(1 - b2 ** t) + eps
        p[k].addcdiv_(m, denom, value=-lrs[k] / (1 - b1 ** t))
