"""Packed HPO trial cohorts: P same-shape trials trained as one program.

Counterpart of ``multimodal_isic_tpu/hpo/population.py`` (:1-705), the form
here of the reference's fractional-GPU trial packing (``tune_mil.py:
213-227``, ``utils_g_mil.py:79-91``; 4 torch processes a GPU).  The keys
that set a model's shapes (hidden_dim, att_dim, optimizer; for Graph-MIL
every architecture and topology key) are sampled once a cohort, the
continuous keys (lr, weight_decay, the dropout rates) once a trial, and the
cohort trains in lockstep under ``torch.func``:

- the P trials' parameters are one float32 tensor ``[P, n]`` (each trial's
  parameters flattened in ``named_parameters`` order), and a trial's
  module parameters are views of its row, handed to ``functional_call``;
- one per-bag step takes every trial's gradient with ``vmap(grad(·))`` and
  updates the stacked state with the Adam / AdamW rules of
  ``torch.optim`` (:meth:`Cohort.step`), lr and weight decay a trial;
- one cohort forward a split gives the probabilities ``[P, n_bags, C]``,
  read back once; the metrics of each trial are computed on the host.

Dropout takes a 0-d tensor rate a trial (``models.graph_mil._dropout``) and
draws through a hook: each dropout site draws ``[P0, *shape]`` uniforms from
the epoch's generator (``vmap(randomness="same")``) and a trial takes the
row of its ORIGINAL index, so the draws of a trial do not depend on which
trials share its cohort, and compaction leaves a survivor's run as it was.
The draws are not the sequential trainer's (that one draws ``shape``
uniforms a site); at dropout 0 nothing is drawn that changes a value.

Every trial keeps the sequential semantics of ``train/mil.py::_train_core``:
the same seed → the same init (``train.mil.init_params_``), the same
stratified 80/20 split, the same per-epoch resampling order, one step a
bag, the ``CE(log(p + 1e-9))`` loss, per-trial patience and the dual
best-checkpoint tracking.  A member with a config reproduces the sequential
``train_mil`` / ``train_graph_mil`` result for it (tested).
"""

from __future__ import annotations

import os
import time
import weakref
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch.func import functional_call, grad, vmap
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..core import metrics as M
from ..core.rng import RngStream
from ..core.splits import StratifiedShuffleSplit, weighted_sample_indices
from ..models.mil import AttentionMIL, mil_loss
from ..train import mil as TM
from .space import GRAPH_MIL_SPACE, sample_config

Device = Union[str, torch.device]

SHAPE_KEYS = ("hidden_dim", "att_dim", "optimizer")
POP_KEYS = ("lr", "weight_decay", "dropout")

# Graph-MIL packing (the reference's flagship 1000-sample search,
# tune_mil.py:170-200, 4 trials a GPU at :33): the per-trial keys are the
# optimizer's and the two dropout rates (GraphMIL takes them as tensor
# overrides); every architecture / topology key is a cohort shape key.
# Sampling shape keys once a cohort gives FULL cohorts: bucketing
# independently sampled 19-dim configs by shape would almost always give
# singletons (~1e8 distinct signatures).
GRAPH_POP_KEYS = ("lr", "weight_decay", "gnn_dropout", "pool_dropout")
GRAPH_SHAPE_KEYS = tuple(k for k in GRAPH_MIL_SPACE if k not in GRAPH_POP_KEYS)

B1, B2, EPS = 0.9, 0.999, 1e-8   # torch.optim.Adam's defaults
STATE_COPIES = 5   # params, Adam m and v, the two best-checkpoint trackers
BAG_SIZE = 196     # patches a bag: 14 × 14 of a 224² image's latents
BUDGET_SHARE = 10 / 16   # JAX's 10 GiB of a 16 GB chip, of the card's memory
CPU_BUDGET_GB = 10.0     # the budget on the CPU: JAX's default


class PackedSpec(NamedTuple):
    """What the cohort engine needs from a model family.

    ``rate_keys``  the per-trial rates beyond lr / wd (dropout), in the
                   order of ``rates``' columns;
    ``build``      input_dim → the shape config's module (initialised by
                   ``train.mil.init_params_``, as the sequential trainable);
    ``rate_kwargs`` a trial's rates [R] → the forward's override kwargs;
    ``graph_cfg``  the graph config whose adjacency is built once a bag and
                   shared by the cohort, or None for classic MIL.
    """
    rate_keys: tuple
    build: Callable[[int], torch.nn.Module]
    rate_kwargs: Callable[[torch.Tensor], Dict]
    graph_cfg: Optional[Dict]


def mil_spec(shape_config: Dict, num_classes: int) -> PackedSpec:
    def build(input_dim):
        return AttentionMIL(input_dim=input_dim,
                            hidden_dim=int(shape_config["hidden_dim"]),
                            att_dim=int(shape_config["att_dim"]),
                            dropout=0.0, num_classes=num_classes)
    return PackedSpec(("dropout",), build,
                      lambda r: {"dropout_rate": r[0]}, None)


def graph_mil_spec(shape_config: Dict, num_classes: int) -> PackedSpec:
    if shape_config.get("graph_type") == "random":
        # grid / kNN graphs are a function of the bag, so one adjacency a
        # bag serves the cohort exactly; a random topology is drawn a trial
        # (as the sequential train_graph_mil does): sharing it would
        # correlate the cohort.  The reference's space is {grid, knn}
        # (tune_mil.py:180).
        raise ValueError(
            "graph_type='random' cannot run packed: the cohort would share "
            "one topology draw. Use the sequential runner for random graphs.")
    return PackedSpec(
        ("gnn_dropout", "pool_dropout"),
        lambda input_dim: TM.graph_mil_from_config(shape_config, input_dim,
                                                   num_classes),
        lambda r: {"gnn_dropout_rate": r[0], "pool_dropout_rate": r[1]},
        shape_config)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class Cohort:
    """P same-shape trials' state on one device: parameters, Adam moments
    and the two best-checkpoint trackers as ``[P, n]`` float32 tensors, the
    per-trial lr / wd / rates, and each position's original trial index.

    ``step`` trains every trial on one bag; ``probs`` evaluates a split for
    every trial in one forward; ``take`` keeps the positions ``sel``
    (compaction)."""

    def __init__(self, spec: PackedSpec, model: torch.nn.Module,
                 pop: Dict[str, np.ndarray], decoupled: bool,
                 device: Device):
        self.spec, self.model, self.decoupled = spec, model, decoupled
        self.device = torch.device(device)
        named = list(model.named_parameters())
        self.layout, off = [], 0
        for name, p in named:
            self.layout.append((name, tuple(p.shape), off, p.numel()))
            off += p.numel()
        flat = torch.cat([p.detach().reshape(-1) for _, p in named]).to(
            self.device, torch.float32)
        model.to("meta")  # functional_call swaps in every parameter
        self.P0 = len(np.asarray(pop["lr"]))
        self.params = flat.expand(self.P0, -1).clone()
        self.m = torch.zeros_like(self.params)
        self.v = torch.zeros_like(self.params)
        self.best_bacc = self.params.clone()
        self.best_loss = self.params.clone()
        self.lr = np.asarray(pop["lr"], np.float64)
        self.wd = np.asarray(pop["weight_decay"], np.float64)
        self.rates = torch.tensor(
            np.stack([np.asarray(pop[k], np.float64) for k in spec.rate_keys],
                     1), dtype=torch.float32, device=self.device)
        self.tidx = torch.arange(self.P0, device=self.device)
        self.orig = np.arange(self.P0)
        self.t = 0
        self._scalars()

    def __len__(self) -> int:
        return len(self.orig)

    def _scalars(self) -> None:
        """The per-trial update scalars, [P, 1] float32, from float64 (as
        ``torch.optim`` rounds its Python scalars)."""
        col = lambda a: torch.tensor(a[:, None], dtype=torch.float32,
                                     device=self.device)
        self._wd_col = col(self.wd)
        self._decay_col = col(1.0 - self.lr * self.wd)

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Module parameters as views of ``flat`` [..., n]."""
        lead = flat.shape[:-1]
        return {name: flat[..., o:o + n].view(*lead, *shape)
                for name, shape, o, n in self.layout}

    def _forward(self, params, x, valid, adj, train, draws=None,
                 rates=None):
        args = (x,) if adj is None else (x, adj)
        kwargs = {"valid": valid, "train": train, "generator": draws}
        if rates is not None:
            kwargs.update(self.spec.rate_kwargs(rates))
        return functional_call(self.model, params, args, kwargs)[0]

    def step(self, x: torch.Tensor, valid: torch.Tensor,
             adj: Optional[torch.Tensor], y: torch.Tensor,
             generator: torch.Generator) -> None:
        """One bag: every trial's gradient (one vmapped forward and
        backward), then one Adam / AdamW update of the stacked state."""
        P0 = self.P0

        def loss(params, rates, t):
            def draws(shape, device, dtype):
                u = torch.rand((P0,) + tuple(shape), generator=generator,
                               device=device, dtype=dtype)
                # the trial's own row, whatever its position
                return torch.index_select(u, 0, t.reshape(1))[0]
            probs = self._forward(params, x, valid, adj, True, draws, rates)
            return mil_loss(probs, y)

        grads = vmap(grad(loss), randomness="same")(
            self.views(self.params), self.rates, self.tidx)
        # two [P, n] work buffers, allocated once the backward has freed
        # its activations (:func:`estimate_cohort_bytes`): the gradients,
        # then the update's numerator; the update's denominator
        g = torch.empty_like(self.params)
        torch.cat([grads.pop(name).reshape(len(self), -1)
                   for name, *_ in self.layout], 1, out=g)
        del grads
        self.t += 1
        bc1 = 1.0 - B1 ** self.t
        bc2_sqrt = (1.0 - B2 ** self.t) ** 0.5
        neg_step = torch.tensor(-(self.lr / bc1)[:, None],
                                dtype=torch.float32, device=self.device)
        if self.decoupled:   # AdamW: p ← p·(1 − lr·wd) first
            self.params.mul_(self._decay_col)
        else:                # Adam: wd folded into the gradient
            g.addcmul_(self.params, self._wd_col)
        self.m.lerp_(g, 1.0 - B1)
        self.v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
        denom = torch.sqrt(self.v).div_(bc2_sqrt).add_(EPS)
        torch.mul(self.m, neg_step, out=g)  # g is spent: the step's numerator
        self.params.addcdiv_(g, denom)

    @torch.no_grad()
    def probs(self, flat: torch.Tensor, split: "TM.BagSplit"
              ) -> torch.Tensor:
        """Every trial's probabilities of ``split``'s bags [P, B, C], in
        chunks of ``train.mil.EVAL_CHUNK`` bags."""
        def chunk(s):
            sl = slice(s, s + TM.EVAL_CHUNK)
            x, valid, adj = split.feats[sl], split.valid[sl], split.graph(sl)
            return vmap(lambda f: self._forward(self.views(f), x, valid, adj,
                                                False))(flat)
        return torch.cat([chunk(s) for s in range(0, len(split),
                                                  TM.EVAL_CHUNK)], 1)

    def metrics(self, flat: torch.Tensor, split: "TM.BagSplit",
                num_classes: int) -> List[Dict[str, float]]:
        """The 10-metric bundle of every trial: one cohort forward on the
        device, one read-back of ``[P, B, C]`` probabilities and the [P]
        losses, the metrics on the host."""
        probs = self.probs(flat, split)
        losses = mil_loss(probs, split.y.expand(probs.shape[0], -1)).mean(-1)
        host = torch.cat([probs.flatten(1), losses[:, None]], 1).cpu().numpy()
        b, c = probs.shape[1:]
        return [M.evaluate_probs(split.labels, row[:-1].reshape(b, c),
                                 num_classes, loss=float(row[-1]))
                for row in host]

    def select(self, improved: np.ndarray, which: str) -> None:
        """``best_{which}`` ← ``params`` where ``improved`` [P], row by row
        in place (no ``[P, n]`` temporary)."""
        best = getattr(self, f"best_{which}")
        for pos in np.flatnonzero(improved).tolist():
            best[pos].copy_(self.params[pos])

    def snapshot(self, pos: int):
        """Host copies of one position's best checkpoints."""
        return self.best_bacc[pos].cpu(), self.best_loss[pos].cpu()

    def take(self, sel: np.ndarray) -> None:
        """Keep positions ``sel`` (repeats allowed), in that order."""
        idx = torch.from_numpy(np.asarray(sel, np.int64)).to(self.device)
        for name in ("params", "m", "v", "best_bacc", "best_loss", "rates",
                     "tidx"):
            setattr(self, name, getattr(self, name)[idx])
        self.lr, self.wd, self.orig = self.lr[sel], self.wd[sel], \
            self.orig[sel]
        self._scalars()


def train_mil_population(
    shape_config: Dict,
    pop: Dict[str, np.ndarray],
    data: Dict,
    seed: int = 42,
    num_classes: int = 7,
    patience: int = 8,
    max_epochs: int = 50,
    report_fn=None,
    scheduler=None,
    trial_ids: Optional[Sequence[str]] = None,
    device: Device = "cuda",
) -> List[Dict]:
    """Train P AttentionMIL trials in lockstep.  ``pop`` holds per-trial
    'lr' / 'weight_decay' / 'dropout' arrays [P]; ``shape_config`` the
    shared hidden_dim / att_dim / optimizer.  The engine's semantics (ASHA
    inside the cohort, patience, compaction): :func:`_train_population`."""
    return _train_population(
        mil_spec(shape_config, num_classes), shape_config, pop, data,
        seed=seed, num_classes=num_classes, patience=patience,
        max_epochs=max_epochs, report_fn=report_fn, scheduler=scheduler,
        trial_ids=trial_ids, device=device)


def train_graph_mil_population(
    shape_config: Dict,
    pop: Dict[str, np.ndarray],
    data: Dict,
    seed: int = 42,
    num_classes: int = 7,
    patience: int = 8,
    max_epochs: int = 50,
    report_fn=None,
    scheduler=None,
    trial_ids: Optional[Sequence[str]] = None,
    device: Device = "cuda",
) -> List[Dict]:
    """Train P GraphMIL trials in lockstep: the packed form of the
    reference's flagship graph search (``tune_mil.py:170-200``, 4 trials a
    GPU at ``:33``).  ``shape_config`` carries the 15 architecture /
    topology keys (sampled once a cohort); ``pop`` the per-trial lr /
    weight_decay / gnn_dropout / pool_dropout arrays [P].  Each bag's
    adjacency is built once and shared by the cohort."""
    return _train_population(
        graph_mil_spec(shape_config, num_classes), shape_config, pop, data,
        seed=seed, num_classes=num_classes, patience=patience,
        max_epochs=max_epochs, report_fn=report_fn, scheduler=scheduler,
        trial_ids=trial_ids, device=device)


def _cohort_splits(spec: PackedSpec, data: Dict, seed: int, device: Device):
    """The sequential trainer's splits (``_train_core``): the stratified
    80/20 split of the training bags, padded once to the longest bag of
    train and test, on the device with their graphs → (train, val, test or
    None)."""
    train_feats = [np.asarray(a, np.float32) for a in data["train_feats"]]
    train_labels = np.asarray([int(l) for l in data["train_labels"]])
    test_feats = [np.asarray(a, np.float32)
                  for a in data.get("test_feats", [])]
    test_labels = np.asarray([int(l) for l in data.get("test_labels", [])])
    sss = StratifiedShuffleSplit(n_splits=1, test_size=0.2,
                                 random_state=seed)
    tr_idx, va_idx = next(sss.split(np.zeros((len(train_labels), 1)),
                                    train_labels))
    max_n = max(b.shape[0] for b in train_feats + test_feats)
    feats_all, valid_all = TM.pad_bags(train_feats, max_n)
    device = torch.device(device)
    train = TM.BagSplit(feats_all[tr_idx], valid_all[tr_idx],
                        train_labels[tr_idx], device, spec.graph_cfg)
    val = TM.BagSplit(feats_all[va_idx], valid_all[va_idx],
                      train_labels[va_idx], device, spec.graph_cfg)
    test = (TM.BagSplit(*TM.pad_bags(test_feats, max_n), test_labels,
                        device, spec.graph_cfg)
            if len(test_feats) and len(test_labels) else None)
    return train, val, test


def make_cohort(spec: PackedSpec, shape_config: Dict,
                pop: Dict[str, np.ndarray], input_dim: int, seed: int,
                device: Device) -> Cohort:
    """A cohort of ``pop``'s trials from ONE init shared by all of them:
    ``run_search`` hands every sequential trial the same seed, so this is
    the sequential protocol."""
    model = spec.build(input_dim)
    TM.init_params_(model, seed)
    return Cohort(spec, model, pop,
                  shape_config.get("optimizer", "adam") == "adamw", device)


def _train_population(
    spec: PackedSpec,
    shape_config: Dict,
    pop: Dict[str, np.ndarray],
    data: Dict,
    seed: int = 42,
    num_classes: int = 7,
    patience: int = 8,
    max_epochs: int = 50,
    report_fn=None,
    scheduler=None,
    trial_ids: Optional[Sequence[str]] = None,
    device: Device = "cuda",
) -> List[Dict]:
    """The packed-cohort trainer.  ``report_fn(trial_idx, metrics)`` is
    called a trial an epoch, and once a trial at the end.  → P final
    reports (the ``_train_core`` report, plus ``epochs_run`` and
    ``stopped_early``; ``_test_best_bacc`` / ``_test_best_loss`` where
    there is a test split).

    ``scheduler`` (an :class:`.asha.ASHAScheduler`, or anything with its
    ``on_result(trial_id, epoch, metrics) → 'continue' | 'stop'``) judges
    each trial at each epoch INSIDE the packed run, as the reference runs
    ASHA over its packed trials (``tune_mil.py:144-149,213-227``).  A
    stopped trial (ASHA or patience) leaves the best-checkpoint tracking at
    once; when at most half the cohort is live, the live trials are
    COMPACTED into a cohort of the next power of two (padded with phantom
    copies of the first live trial, kept out of all bookkeeping), so early
    stopping saves time.  Each stopped trial's best checkpoints go to the
    host before compaction, and the test evaluation puts the whole
    population back together."""
    rng = np.random.RandomState(seed)
    train, val, test = _cohort_splits(spec, data, seed, device)
    input_dim = int(train.feats.shape[-1])
    cohort = make_cohort(spec, shape_config, pop, input_dim, seed, device)
    P0 = cohort.P0
    if trial_ids is None:
        trial_ids = [f"t{t:03d}" for t in range(P0)]
    dropout = RngStream(seed, "mil_dropout", device)

    # per-ORIGINAL-trial bookkeeping (host side, survives compaction)
    best_bacc = np.full(P0, -np.inf)
    best_loss = np.full(P0, np.inf)
    best_bacc_metrics: List[Optional[Dict]] = [None] * P0
    best_loss_metrics: List[Optional[Dict]] = [None] * P0
    no_improve = np.zeros(P0, int)
    stopped = np.zeros(P0, bool)
    asha_stopped = np.zeros(P0, bool)
    epochs_run = np.zeros(P0, int)
    host_bacc_params: List[Optional[torch.Tensor]] = [None] * P0
    host_loss_params: List[Optional[torch.Tensor]] = [None] * P0
    phantom = np.zeros(P0, bool)

    for epoch in range(1, max_epochs + 1):
        order = weighted_sample_indices(train.labels, None, rng)
        gen = dropout.at(epoch)
        for b in order.tolist():
            cohort.step(train.feats[b], train.valid[b], train.graph(b),
                        train.y[b], gen)

        vm = cohort.metrics(cohort.params, val, num_classes)
        orig = cohort.orig
        p_now = len(orig)
        bacc = np.array([m["bacc"] for m in vm])
        loss = np.array([m["loss"] for m in vm])
        live = ~stopped[orig] & ~phantom
        improved_b = (bacc > best_bacc[orig] + 1e-6) & live
        improved_l = (loss < best_loss[orig] - 1e-6) & live
        cohort.select(improved_b, "bacc")
        cohort.select(improved_l, "loss")
        for pos in range(p_now):
            t = orig[pos]
            if stopped[t] or phantom[pos]:
                continue
            epochs_run[t] = epoch
            if improved_b[pos]:
                best_bacc[t] = bacc[pos]
                best_bacc_metrics[t] = vm[pos]
                no_improve[t] = 0
            else:
                no_improve[t] += 1
            if improved_l[pos]:
                best_loss[t] = loss[pos]
                best_loss_metrics[t] = vm[pos]
            if report_fn is not None:
                report_fn(t, {f"val_{k}": vm[pos][k] for k in TM.METRICS})
            if no_improve[t] >= patience:
                stopped[t] = True
            if not stopped[t] and scheduler is not None:
                decision = scheduler.on_result(
                    trial_ids[t], epoch,
                    {"val_bacc": vm[pos]["bacc"], "val_loss": vm[pos]["loss"]})
                if decision == "stop":
                    stopped[t] = True
                    # reaching the scheduler's max_t also says "stop": that
                    # is a completed trial, not an early stop
                    asha_stopped[t] = epoch < getattr(
                        scheduler, "max_t", max_epochs)
        live_pos = [pos for pos in range(p_now)
                    if not stopped[orig[pos]] and not phantom[pos]]
        if not live_pos:
            break
        # snapshot + compact once at most half the cohort is live (powers
        # of two: at most log2(P) cohort sizes)
        if _next_pow2(len(live_pos)) <= p_now // 2:
            for pos in range(p_now):
                t = orig[pos]
                if (stopped[t] and not phantom[pos]
                        and host_bacc_params[t] is None):
                    host_bacc_params[t], host_loss_params[t] = \
                        cohort.snapshot(pos)
            p_new = _next_pow2(len(live_pos))
            cohort.take(np.asarray(
                live_pos + [live_pos[0]] * (p_new - len(live_pos))))
            phantom = np.zeros(p_new, bool)
            phantom[len(live_pos):] = True

    orig = cohort.orig
    need_backfill = [t for t in range(P0) if best_bacc_metrics[t] is None]
    # one cohort evaluation covers every backfilled trial
    vm_all = (cohort.metrics(cohort.params, val, num_classes)
              if need_backfill else None)
    for t in need_backfill:
        pos = int(np.where(orig == t)[0][0]) if t in orig else None
        best_bacc_metrics[t] = (vm_all[pos] if pos is not None else
                                {k: float("nan") for k in (
                                    "bacc", "acc", "auc", "loss", "macro_f1",
                                    "weighted_f1")})
    for t in range(P0):
        if best_loss_metrics[t] is None:
            best_loss_metrics[t] = best_bacc_metrics[t]

    test_bacc_metrics = test_loss_metrics = [None] * P0
    if test is not None:
        # the FULL population's best checkpoints: the cohort's for the
        # survivors, host snapshots for the trials compacted out
        for pos in range(len(orig)):
            t = orig[pos]
            if not phantom[pos] and host_bacc_params[t] is None:
                host_bacc_params[t], host_loss_params[t] = \
                    cohort.snapshot(pos)
        stack = lambda snaps: torch.stack(snaps).to(cohort.device)
        test_bacc_metrics = cohort.metrics(stack(host_bacc_params), test,
                                           num_classes)
        test_loss_metrics = cohort.metrics(stack(host_loss_params), test,
                                           num_classes)

    reports = []
    for t in range(P0):
        vm = best_bacc_metrics[t]
        rep = {"val_bacc": float(max(best_bacc[t], vm["bacc"])),
               "val_acc": vm["acc"], "val_auc": vm["auc"],
               "val_loss": vm["loss"], "val_macro_f1": vm["macro_f1"],
               "val_weighted_f1": vm["weighted_f1"],
               "epochs_run": int(epochs_run[t]),
               "stopped_early": bool(asha_stopped[t])}
        if test_bacc_metrics[t] is not None:
            tb = test_bacc_metrics[t]
            rep.update({"test_bacc": tb["bacc"], "test_acc": tb["acc"],
                        "test_auc": tb["auc"], "test_loss": tb["loss"],
                        "test_macro_f1": tb["macro_f1"],
                        "test_weighted_f1": tb["weighted_f1"]})
            rep["_test_best_bacc"] = tb
            rep["_test_best_loss"] = test_loss_metrics[t]
        if report_fn is not None:
            report_fn(t, {k: v for k, v in rep.items()
                          if not k.startswith("_")})
        reports.append(rep)
    return reports


def _shape_model(model_type: str, shape_config: Dict, input_dim: int,
                 num_classes: int) -> torch.nn.Module:
    spec = (graph_mil_spec if model_type == "graph-mil" else mil_spec)(
        shape_config, num_classes)
    return spec.build(input_dim)


def estimate_trial_param_bytes(model_type: str, shape_config: Dict,
                               input_dim: int, num_classes: int) -> int:
    """float32 parameter bytes of ONE trial of this shape config (a model
    built on the ``meta`` device: nothing allocated)."""
    with torch.device("meta"):
        model = _shape_model(model_type, shape_config, input_dim,
                             num_classes)
    return int(sum(p.numel() * 4 for p in model.parameters()))


def memory_budget_bytes(device: Device = "cuda") -> float:
    """The cohort's memory budget: ``ISIC_HPO_MEM_GB`` GiB where set, else
    ``BUDGET_SHARE`` of the card's memory (JAX's 10 GiB of a 16 GB chip,
    ``GRAFT_HPO_HBM_GB``), or ``CPU_BUDGET_GB`` GiB on the CPU."""
    env = os.environ.get("ISIC_HPO_MEM_GB")
    if env:
        return float(env) * (1 << 30)
    device = torch.device(device)
    if device.type == "cuda":
        return BUDGET_SHARE * torch.cuda.get_device_properties(
            device).total_memory
    return CPU_BUDGET_GB * (1 << 30)


class _LiveBytes(TorchDispatchMode):
    """Bytes of the tensors that ops create and that are still alive, and
    their peak: a run on ``meta`` tensors allocates nothing and frees what
    the same run on a card frees."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {a.untyped_storage()._cdata for a in tree_leaves((args, kwargs))
                if isinstance(a, torch.Tensor)}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                store = t.untyped_storage()
                if store._cdata not in seen:  # new storage, not a view
                    seen.add(store._cdata)
                    self.live += store.nbytes()
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(store, self._free, store.nbytes())
        return out


def estimate_cohort_bytes(model_type: str, shape_config: Dict,
                          input_dim: int, num_classes: int, trials: int,
                          bag_size: int = BAG_SIZE) -> int:
    """The bytes a packed cohort of ``trials`` holds at its peak:
    ``STATE_COPIES`` float32 copies of every trial's parameters (live
    params, Adam m and v, the two best-checkpoint trackers of the dual-best
    protocol), and the larger of what one :meth:`Cohort.step` on a bag of
    ``bag_size`` patches adds (activations, dropout draws, gradients, the
    update's two flat buffers) and what one evaluation chunk of
    ``train.mil.EVAL_CHUNK`` such bags adds.  Both run on the ``meta``
    device under :class:`_LiveBytes`: the same ops as on the card, nothing
    allocated."""
    spec = (graph_mil_spec if model_type == "graph-mil" else mil_spec)(
        shape_config, num_classes)
    b = TM.EVAL_CHUNK
    with torch.device("meta"):
        model = spec.build(input_dim)
        x = torch.empty(b, bag_size, input_dim)
        valid = torch.ones(b, bag_size, dtype=torch.bool)
        adj = (torch.empty(b, bag_size, bag_size)
               if spec.graph_cfg is not None else None)
        y = torch.zeros((), dtype=torch.long)
    pop = {k: np.full(trials, 0.5) for k in ("lr", "weight_decay")
           + spec.rate_keys}
    cohort = Cohort(spec, model, pop,
                    shape_config.get("optimizer", "adam") == "adamw", "meta")
    step, chunk = _LiveBytes(), _LiveBytes()
    with step:
        cohort.step(x[0], valid[0], None if adj is None else adj[0], y, None)
    with chunk, torch.no_grad():
        vmap(lambda f: cohort._forward(cohort.views(f), x, valid, adj,
                                       False))(cohort.params)
    state = STATE_COPIES * trials * estimate_trial_param_bytes(
        model_type, shape_config, input_dim, num_classes)
    return state + max(step.peak, chunk.peak)


def max_cohort_for_shape(model_type: str, shape_config: Dict, input_dim: int,
                         num_classes: int, cohort_size: int,
                         device: Device = "cuda",
                         bag_size: int = BAG_SIZE) -> int:
    """Largest sub-cohort, a power of two, whose step fits the memory
    budget (:func:`memory_budget_bytes`) by :func:`estimate_cohort_bytes`.
    The flagship space reaches ~556 MB of parameters a trial (gnn_hidden
    512 × 8 concat heads × 8 layers)."""
    budget = memory_budget_bytes(device)
    p = 1
    while p * 2 <= cohort_size and estimate_cohort_bytes(
            model_type, shape_config, input_dim, num_classes, p * 2,
            bag_size) <= budget:  # a power of 2: compaction-friendly
        p *= 2
    return p


def run_population_search(
    space: Dict,
    data: Dict,
    num_samples: int = 16,
    cohort_size: int = 8,
    metric: str = "val_bacc",
    mode: str = "max",
    seed: int = 42,
    max_epochs: int = 50,
    patience: int = 8,
    num_classes: int = 7,
    verbose: bool = True,
    scheduler=None,
    model_type: str = "mil",
    device: Device = "cuda",
) -> Dict:
    """Cohorted search: shape keys are sampled once a cohort (so a cohort
    is one packed program), continuous keys once a trial.  The breadth over
    the continuous keys is the sequential runner's; over the shape keys it
    is num_samples / cohort_size, the price of packing (the reference caps
    the trials a GPU the same way).

    ``model_type='graph-mil'`` packs the reference's 19-dim graph search
    (``tune_mil.py:170-200``): the 15 architecture / topology keys are the
    cohort's shape, lr / wd / gnn_dropout / pool_dropout are a trial's.

    ``scheduler`` (ASHAScheduler) is SHARED by the cohorts: rung cutoffs
    compare every trial seen so far, as Ray's asynchronous rungs do over its
    packed workers (``tune_mil.py:144-149``).

    Under a multi-process group, COHORTS shard round-robin over the
    processes, with the rung board and the results table in the store (see
    ``runner.run_search``).
    → {best_config, results (DataFrame incl. epochs_run / stopped_early),
    wall_s}."""
    import pandas as pd

    from . import distributed as hdist

    if model_type == "graph-mil":
        shape_keys, pop_keys = GRAPH_SHAPE_KEYS, GRAPH_POP_KEYS
        trainer = train_graph_mil_population
    else:
        shape_keys, pop_keys = SHAPE_KEYS, POP_KEYS
        trainer = train_mil_population

    ns = hdist.search_namespace()
    rng = np.random.RandomState(seed)
    t_start = time.time()
    n_cohorts = (num_samples + cohort_size - 1) // cohort_size
    mine = set(hdist.shard_indices(n_cohorts))
    if hdist.process_count() > 1 and scheduler is not None \
            and scheduler.board is None:
        scheduler.board = hdist.CoordinationRungBoard(ns)
    cohort_rows: Dict[int, List[dict]] = {}
    bag_size = max(len(b) for b in list(data["train_feats"])
                   + list(data.get("test_feats", [])))
    for c in range(n_cohorts):
        P = min(cohort_size, num_samples - c * cohort_size)
        # every process samples every cohort from the same stream; only its
        # own round-robin slice trains (results exchanged afterwards)
        full = [sample_config(space, rng) for _ in range(P)]
        if c not in mine:
            continue
        shape_config = {k: full[0][k] for k in shape_keys if k in full[0]}
        pop = {k: np.array([cfg[k] for cfg in full]) for k in pop_keys}
        # memory-aware packing: big architectures train in sub-cohorts that
        # fit the budget (the reference caps 4 trials a GPU, tune_mil.py:33);
        # a trial's semantics do not change (same seed, split and id)
        input_dim = int(np.asarray(data["train_feats"][0]).shape[1])
        kind = "graph-mil" if model_type == "graph-mil" else "mil"
        sub = max_cohort_for_shape(kind, shape_config, input_dim,
                                   num_classes, cohort_size, device,
                                   bag_size)
        if verbose and sub < P:
            mb = estimate_trial_param_bytes(kind, shape_config, input_dim,
                                            num_classes) / 1e6
            print(f"cohort {c}: splitting {P} trials into sub-cohorts of "
                  f"{sub} (per-trial params {mb:.0f} MB)", flush=True)
        reports = []
        for s0 in range(0, P, sub):
            sl = slice(s0, min(s0 + sub, P))
            reports.extend(trainer(
                shape_config, {k: v[sl] for k, v in pop.items()}, data,
                seed=seed, num_classes=num_classes,
                patience=patience, max_epochs=max_epochs,
                scheduler=scheduler,
                trial_ids=[f"cohort{c:03d}_t{t:02d}"
                           for t in range(sl.start, sl.stop)],
                device=device))
        cohort_rows[c] = []
        for t, rep in enumerate(reports):
            cfg = {**shape_config, **{k: float(pop[k][t]) for k in pop_keys}}
            row = {"trial_id": f"cohort{c:03d}_t{t:02d}",
                   **{f"config/{k}": v for k, v in cfg.items()},
                   **{k: (float(v) if isinstance(v, (np.floating, np.integer))
                          else v)
                      for k, v in rep.items() if not k.startswith("_")}}
            cohort_rows[c].append(row)
        hdist.publish_result(ns, c, {"rows": cohort_rows[c]})
        if verbose:
            vals = [r[metric] for r in reports]
            print(f"cohort {c}: {P} trials, best {metric}="
                  f"{(max if mode == 'max' else min)(vals):.4f}", flush=True)

    # multi-process: wait for every cohort's published rows, then merge so
    # every process holds the full table
    for c, payload in hdist.collect_results(ns, expected=n_cohorts).items():
        cohort_rows.setdefault(c, payload["rows"])
    rows = [row for c in sorted(cohort_rows) for row in cohort_rows[c]]

    frame = pd.DataFrame(rows)
    vals = frame[metric].astype(float)
    best_idx = int(vals.idxmax() if mode == "max" else vals.idxmin())
    best_row = rows[best_idx]
    best_config = {k.split("/", 1)[1]: v for k, v in best_row.items()
                   if k.startswith("config/")}
    return {"best_config": best_config, "results": frame,
            "wall_s": time.time() - t_start}
