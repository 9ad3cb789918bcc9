"""MIL and Graph-MIL trainables (the reference's ``train_mil`` /
``train_graph_mil``, ``utils_g_mil.py:70-285,608-852``).

Counterpart of ``multimodal_isic_tpu/train/mil.py`` (:36-277), with its
semantics: a stratified 80/20 train/val split of the training bags (seeded,
sklearn's membership), inverse-class-frequency resampling with replacement
each epoch, **one optimizer step a bag** (the reference trains at bs 1) in
the resampled order, the ``CE(log(probs + 1e-9))`` loss, the 10-metric
evaluation every epoch, the best-by-val-bacc (+1e-6) and best-by-val-loss
(−1e-6) snapshots, patience, and a final report with test metrics from the
best-bacc snapshot.

Bags are padded to one ``max_n`` with validity masks and live on the
device for the whole run, so every step has one shape and sums run in
JAX's order.  A grid or kNN graph depends only on its bag, so each bag's is
built once before the first epoch; a random graph is drawn a step (and a
bag, seeded with 0, in evaluation, as JAX evaluates with ``PRNGKey(0)``).
Evaluation runs the padded bags of a split in batches of ``EVAL_CHUNK``.
The step reads nothing back: the epoch's losses are read once at its end.

The model's initial weights are drawn on the CPU with flax's initialisers
(``init_params_``: LeCun-normal Dense kernels, zero biases, Glorot-uniform
GAT attention vectors) from ``seed``, then moved to ``device``, so one seed
gives the same start on every device (not JAX's numbers: ``jax.random``
and torch differ).  ``make_optimizer`` maps the reference's three names on
``torch.optim``: Adam (weight decay folded into the gradient), AdamW and
SGD with momentum 0.9, the update rules JAX's ``core/optim.py`` implements.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core import metrics as M
from ..core.rng import RngStream, generator as make_generator
from ..core.splits import StratifiedShuffleSplit, weighted_sample_indices
from ..models.graph_mil import GATLayer, GraphMIL
from ..models.graphs import (build_grid_adj_dynamic, build_knn_adj,
                             build_random_adj)
from ..models.mil import AttentionMIL, mil_loss

EVAL_CHUNK = 64  # padded bags a forward in evaluation
# the 10-metric bundle, in the order ``report_fn`` receives it (JAX :189)
METRICS = ("bacc", "acc", "auc", "loss", "macro_p", "macro_r", "macro_f1",
           "weighted_p", "weighted_r", "weighted_f1")

Device = Union[str, torch.device]


def pad_bags(bags: Sequence[np.ndarray], max_n: Optional[int] = None):
    """list of [N_i, F] → (feats [B, N, F] float32, valid [B, N] bool)."""
    max_n = max_n or max(b.shape[0] for b in bags)
    f = bags[0].shape[1]
    feats = np.zeros((len(bags), max_n, f), np.float32)
    valid = np.zeros((len(bags), max_n), bool)
    for i, b in enumerate(bags):
        feats[i, :b.shape[0]] = b
        valid[i, :b.shape[0]] = True
    return feats, valid


def make_optimizer(params: Iterable[torch.nn.Parameter], name: str,
                   lr: float, weight_decay: float = 0.0
                   ) -> torch.optim.Optimizer:
    """The reference's switch (``utils_g_mil.py:139-146``): adam | adamw |
    sgd with momentum 0.9."""
    name = name.lower()
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9,
                               weight_decay=weight_decay)
    raise ValueError(f"Unsupported optimizer: {name}")


@torch.no_grad()
def init_params_(model: torch.nn.Module, seed: int) -> None:
    """flax's default initialisers, drawn on the CPU from ``seed``: Dense
    kernels LeCun-normal (truncated at ±2σ, σ = sqrt(1 / fan_in) /
    0.8796), biases and GIN's ε zero, LayerNorms ones and zeros, GAT's
    ``att_src`` / ``att_dst`` Glorot-uniform over (heads, out_dim)."""
    g = make_generator(seed, "cpu")
    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            std = math.sqrt(1.0 / m.weight.shape[1]) / .87962566103423978
            torch.nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std,
                                        2 * std, generator=g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, GATLayer):
            heads, dim = m.att_src.shape
            limit = math.sqrt(6.0 / (heads + dim))
            for p in (m.att_src, m.att_dst):
                p.uniform_(-limit, limit, generator=g)


def _adj_for_bag(x: torch.Tensor, valid: torch.Tensor, cfg: Dict,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Graph topology over the true bag nodes (JAX :48-67), both sides
    masked by ``valid``; ``[..., N, N]``."""
    gtype = cfg.get("graph_type", "grid")
    k = cfg.get("k_neighbors", None)
    if gtype == "grid":
        _, adj = build_grid_adj_dynamic(
            valid, bool(cfg.get("connect_diagonals", False)))
    elif gtype == "knn":
        adj = build_knn_adj(x, 8 if k is None else int(k), valid=valid)
    elif gtype == "random":
        adj = build_random_adj(x.shape[-2], 4 if k is None else int(k),
                               valid=valid, generator=generator)
    else:
        raise ValueError(f"Unsupported graph_type='{gtype}'")
    v = valid.float()
    return adj * v[..., :, None] * v[..., None, :]


class BagSplit:
    """One split's padded bags on the device, and their fixed graphs."""

    def __init__(self, feats: np.ndarray, valid: np.ndarray,
                 labels: np.ndarray, device: torch.device,
                 graph_cfg: Optional[Dict]):
        self.labels = np.asarray(labels, np.int64)
        self.feats = torch.from_numpy(feats).to(device)
        self.valid = torch.from_numpy(valid).to(device)
        self.y = torch.from_numpy(self.labels).to(device)
        self.graph_cfg = graph_cfg
        self.adj = None
        if graph_cfg is not None and \
                graph_cfg.get("graph_type", "grid") != "random":
            self.adj = torch.cat([
                _adj_for_bag(self.feats[s:s + EVAL_CHUNK],
                             self.valid[s:s + EVAL_CHUNK], graph_cfg)
                for s in range(0, len(self.feats), EVAL_CHUNK)]) \
                if len(self.feats) else None

    def __len__(self) -> int:
        return len(self.labels)

    def graph(self, sl, generator=None) -> Optional[torch.Tensor]:
        """The adjacency of bags ``sl`` (an index or a slice), or None for
        a model without a graph."""
        if self.graph_cfg is None:
            return None
        if self.adj is not None:
            return self.adj[sl]
        return _adj_for_bag(self.feats[sl], self.valid[sl], self.graph_cfg,
                            generator)


def _forward(model, x, valid, adj, train, generator):
    if adj is None:
        return model(x, valid=valid, train=train, generator=generator)
    return model(x, adj, valid=valid, train=train, generator=generator)


def train_epoch(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                split: BagSplit, order: np.ndarray,
                generator: torch.Generator) -> torch.Tensor:
    """One optimizer step a bag, in ``order`` (JAX's ``lax.scan``,
    :148-173) → the steps' losses [len(order)], on the device, unread."""
    losses = []
    for b in order.tolist():
        probs, _ = _forward(model, split.feats[b], split.valid[b],
                            split.graph(b, generator), True, generator)
        loss = mil_loss(probs, split.y[b])
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    return torch.stack(losses)


@torch.no_grad()
def predict_probs(model: torch.nn.Module, split: BagSplit) -> torch.Tensor:
    """Probabilities of every bag of ``split`` [B, C], in batches of
    ``EVAL_CHUNK`` padded bags; a random graph seeded with 0."""
    gen = (make_generator(0, split.feats.device)
           if split.graph_cfg is not None and split.adj is None else None)
    return torch.cat([
        _forward(model, split.feats[s:s + EVAL_CHUNK],
                 split.valid[s:s + EVAL_CHUNK],
                 split.graph(slice(s, s + EVAL_CHUNK), gen), False, None)[0]
        for s in range(0, len(split), EVAL_CHUNK)])


def evaluate_split(model: torch.nn.Module, split: BagSplit,
                   num_classes: int) -> Dict[str, float]:
    """The reference's ``_evaluate_split`` bundle (``utils_g_mil.py:
    150-187``; JAX :95-109); NaN everywhere for an empty split."""
    if len(split) == 0:
        return {k: float("nan") for k in METRICS}
    probs = predict_probs(model, split)
    loss = mil_loss(probs, split.y).mean()
    return M.evaluate_probs(split.labels, probs.cpu().numpy(), num_classes,
                            loss=float(loss))


def _snapshot(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _train_core(model: torch.nn.Module, is_graph: bool, config: Dict,
                data: Dict, seed: int, num_classes: int, patience: int,
                max_epochs: int,
                report_fn: Optional[Callable[[Dict], None]] = None,
                device: Device = "cuda") -> Dict:
    device = torch.device(device)
    rng = np.random.RandomState(seed)
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
    feats_all, valid_all = pad_bags(train_feats, max_n)
    graph_cfg = config if is_graph else None
    train = BagSplit(feats_all[tr_idx], valid_all[tr_idx],
                     train_labels[tr_idx], device, graph_cfg)
    val = BagSplit(feats_all[va_idx], valid_all[va_idx],
                   train_labels[va_idx], device, graph_cfg)
    test = (BagSplit(*pad_bags(test_feats, max_n), test_labels, device,
                     graph_cfg) if len(test_feats) else None)

    init_params_(model, seed)
    model.to(device)
    optimizer = make_optimizer(
        model.parameters(), config.get("optimizer", "adam"),
        float(config.get("lr", 1e-4)),
        weight_decay=float(config.get("weight_decay", 1e-5)))
    dropout = RngStream(seed, "mil_dropout", device)

    best_by_bacc = {"params": None, "val_metrics": None, "val_bacc": -np.inf}
    best_by_loss = {"params": None, "val_metrics": None, "val_loss": np.inf}
    epochs_no_improve = 0
    epoch_losses: List[float] = []
    for epoch in range(1, max_epochs + 1):
        order = weighted_sample_indices(train.labels, None, rng)
        losses = train_epoch(model, optimizer, train, order,
                             dropout.at(epoch))
        val_metrics = evaluate_split(model, val, num_classes)
        epoch_losses.append(float(losses.mean()))

        if val_metrics["bacc"] > best_by_bacc["val_bacc"] + 1e-6:
            best_by_bacc = {"params": _snapshot(model),
                            "val_metrics": val_metrics,
                            "val_bacc": val_metrics["bacc"]}
            epochs_no_improve = 0
        else:
            epochs_no_improve += 1
        if val_metrics["loss"] < best_by_loss["val_loss"] - 1e-6:
            best_by_loss = {"params": _snapshot(model),
                            "val_metrics": val_metrics,
                            "val_loss": val_metrics["loss"]}
        if report_fn is not None:
            report_fn({f"val_{k}": val_metrics[k] for k in METRICS})
        if epochs_no_improve >= patience:
            break

    for best, key, metric in ((best_by_bacc, "val_bacc", "bacc"),
                              (best_by_loss, "val_loss", "loss")):
        if best["params"] is None:
            vm = evaluate_split(model, val, num_classes)
            best.update({"params": _snapshot(model), "val_metrics": vm,
                         key: vm[metric]})

    test_best_bacc = test_best_loss = None
    if test is not None and len(test):
        model.load_state_dict(best_by_bacc["params"])
        test_best_bacc = evaluate_split(model, test, num_classes)
        model.load_state_dict(best_by_loss["params"])
        test_best_loss = evaluate_split(model, test, num_classes)

    vm = best_by_bacc["val_metrics"]
    final_report = {
        "val_bacc": best_by_bacc["val_bacc"],
        "val_acc": vm["acc"], "val_auc": vm["auc"], "val_loss": vm["loss"],
        "val_macro_f1": vm["macro_f1"],
        "val_weighted_f1": vm["weighted_f1"],
    }
    if test_best_bacc:
        final_report.update({f"test_{k}": test_best_bacc[k] for k in (
            "bacc", "acc", "auc", "loss", "macro_f1", "weighted_f1")})
    if report_fn is not None:
        report_fn(final_report)
    final_report["_best_by_bacc_params"] = best_by_bacc["params"]
    final_report["_best_by_loss_params"] = best_by_loss["params"]
    final_report["_test_best_bacc"] = test_best_bacc  # full 10-metric dicts
    final_report["_test_best_loss"] = test_best_loss
    final_report["_epoch_losses"] = epoch_losses  # mean train loss an epoch
    return final_report


def _input_dim(data: Dict) -> int:
    return (data["train_feats"][0].shape[1] if len(data["train_feats"])
            else data.get("input_dim", 76))


def train_mil(config: Dict, data: Dict, seed: int = 42,
              num_classes: int = 7, patience: int = 8, max_epochs: int = 50,
              report_fn=None, device: Device = "cuda") -> Dict:
    model = AttentionMIL(input_dim=_input_dim(data),
                         hidden_dim=int(config["hidden_dim"]),
                         att_dim=int(config["att_dim"]),
                         dropout=float(config["dropout"]),
                         num_classes=num_classes)
    return _train_core(model, False, config, data, seed, num_classes,
                       patience, max_epochs, report_fn, device)


def train_graph_mil(config: Dict, data: Dict, seed: int = 42,
                    num_classes: int = 7, patience: int = 8,
                    max_epochs: int = 50, report_fn=None,
                    device: Device = "cuda") -> Dict:
    model = graph_mil_from_config(config, _input_dim(data), num_classes)
    return _train_core(model, True, config, data, seed, num_classes,
                       patience, max_epochs, report_fn, device)


def graph_mil_from_config(config: Dict, input_dim: int,
                          num_classes: int) -> GraphMIL:
    """GraphMIL from a sampled search config (``tune_mil.py:170-200``; JAX
    :254-277), shared by the trainable and the HPO cohorts."""
    return GraphMIL(input_dim=input_dim,
                    gnn_type=config.get("gnn_type", "gcn"),
                    gnn_hidden=int(config.get("gnn_hidden", 128)),
                    gnn_layers=int(config.get("gnn_layers", 2)),
                    gnn_dropout=float(config.get("gnn_dropout", 0.0)),
                    gnn_heads=int(config.get("gnn_heads", 4)),
                    gnn_concat=bool(config.get("gnn_concat", True)),
                    att_dim=int(config.get("att_dim", 64)),
                    att_heads=int(config.get("att_heads", 4)),
                    pool_dropout=float(config.get("pool_dropout", 0.0)),
                    classifier_dim=int(config.get("classifier_dim", 64)),
                    classifier_light=bool(config.get("classifier_light",
                                                     False)),
                    use_residual=bool(config.get("use_residual", True)),
                    use_layer_norm=bool(config.get("use_layer_norm", True)),
                    num_classes=num_classes)
