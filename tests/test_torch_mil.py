"""Port parity for the MIL modules: ``models/{mil,graphs,graph_mil}.py``,
the MIL converters, ``core/splits.py::StratifiedShuffleSplit``,
``core/metrics.py::evaluate_probs`` and one epoch of ``train/mil.py``'s
per-bag training, against the JAX package on the CPU.

Tolerances:
- forwards (eval mode, JAX's params carried over): probabilities and
  attention within ``FWD_TOL`` (rtol and atol 1e-5);
- builders: the grid (static and dynamic, square and non-square bag sizes)
  and kNN (integer features, so every distance is exact and ties are many)
  equal to JAX's; the random graph by its properties;
- splits bit for bit; ``evaluate_probs`` within 1e-6 (JAX's float32 rank
  sums against float64);
- one epoch at dropout 0 from JAX's initial params: every parameter within
  ``STEP_TOL`` · lr · steps of JAX's, except the attention-score biases
  (``att_fc2``, ``pool_att*_fc2``): a softmax over the patches does not see
  them, so their gradient is 0 computed as rounding noise, which Adam turns
  into steps of up to lr; they are held within lr · steps of their start.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.core import metrics as JM
from multimodal_isic_tpu.core import splits as JS
from multimodal_isic_tpu.models import graph_mil as JGM
from multimodal_isic_tpu.models import graphs as JG
from multimodal_isic_tpu.models import mil as JMIL
from multimodal_isic_tpu.train import mil as JT
from multimodal_isic_tpu_torch.core import metrics as TMet
from multimodal_isic_tpu_torch.core import splits as TS
from multimodal_isic_tpu_torch.models import graphs as TG
from multimodal_isic_tpu_torch.models.convert import (graph_mil_state_dict,
                                                      mil_state_dict)
from multimodal_isic_tpu_torch.models.graph_mil import GraphMIL, _dropout
from multimodal_isic_tpu_torch.models.mil import AttentionMIL, mil_loss
from multimodal_isic_tpu_torch.train import mil as TM

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = 1e-3
NC = 5
F_IN, N_PAD = 12, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded_params(model, args, seed):
    """Params of ``model`` with the shapes flax's ``init`` gives
    (``eval_shape``: no compile), drawn from a numpy seed: kernels
    N(0, 1 / fan_in), LayerNorm scales 1 + N(0, 0.1²), the rest N(0, 0.1²)
    (GIN's ε and GAT's attention vectors included)."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *args))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, s):
        leaf = path[-1].key
        a = np.asarray(rng.randn(*s.shape), np.float32)
        if leaf == "kernel":
            return a / np.sqrt(s.shape[0])
        return 0.1 * a + (1.0 if leaf == "scale" else 0.0)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _bags(seed=0, b=3):
    """``b`` padded bags [b, N_PAD, F_IN]: sizes 16, 9 and 10 (a square
    and a non-square grid inside the padding)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, N_PAD, F_IN).astype(np.float32)
    valid = np.zeros((b, N_PAD), bool)
    for i, n in enumerate((16, 9, 10)[:b]):
        valid[i, :n] = True
    return x, valid


def _jax_adj(x, valid):
    return np.stack([np.asarray(JG.build_grid_adj_dynamic(
        jnp.asarray(v))[1]) * v[:, None] * v[None, :] for v in valid])


# --------------------------------------------------------------- forwards

def test_attention_mil_forward_matches_jax():
    x, valid = _bags()
    jm = JMIL.AttentionMIL(input_dim=F_IN, hidden_dim=10, att_dim=6,
                           dropout=0.3, num_classes=NC)
    params = _seeded_params(jm, (jnp.zeros((N_PAD, F_IN)),), 1)
    fwd = jax.jit(jax.vmap(lambda a, v: jm.apply({"params": params}, a,
                                                 valid=v)))
    jp, ja = fwd(jnp.asarray(x), jnp.asarray(valid))
    tm = AttentionMIL(input_dim=F_IN, hidden_dim=10, att_dim=6, dropout=0.3,
                      num_classes=NC)
    tm.load_state_dict(mil_state_dict(params))
    with torch.no_grad():
        tp, ta = tm(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **FWD_TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **FWD_TOL)
    assert float(ta[1, 9:].abs().sum()) == 0.0  # padding: exactly no weight
    # one bag alone, unpadded, gives the padded bag's probabilities
    with torch.no_grad():
        p1, _ = tm(torch.from_numpy(x[1, :9]))
    np.testing.assert_allclose(p1.numpy(), tp[1].numpy(), rtol=1e-6,
                               atol=1e-7)


GRAPH_CASES = {  # gnn_type: (extra GraphMIL fields)
    "gcn": dict(classifier_light=False),
    "gin": dict(classifier_light=True),
    "graphsage": dict(classifier_light=False, use_residual=False),
    "gat": dict(classifier_light=False, gnn_heads=2),
    "transformer": dict(classifier_light=True, gnn_heads=2,
                        gnn_concat=False),
}


@pytest.mark.parametrize("gnn_type", sorted(GRAPH_CASES))
def test_graph_mil_forward_matches_jax(gnn_type):
    x, valid = _bags(seed=2)
    adj = _jax_adj(x, valid)
    fields = dict(input_dim=F_IN, gnn_type=gnn_type, gnn_hidden=8,
                  gnn_layers=2, gnn_dropout=0.3, att_dim=6, att_heads=2,
                  pool_dropout=0.2, classifier_dim=8, num_classes=NC,
                  **GRAPH_CASES[gnn_type])
    jm = JGM.GraphMIL(**fields)
    params = _seeded_params(jm, (jnp.zeros((N_PAD, F_IN)),
                                 jnp.zeros((N_PAD, N_PAD))), 3)
    fwd = jax.jit(jax.vmap(lambda a, g, v: jm.apply({"params": params}, a,
                                                    g, valid=v)))
    jp, ja = fwd(jnp.asarray(x), jnp.asarray(adj), jnp.asarray(valid))
    tm = GraphMIL(**fields)
    tm.load_state_dict(graph_mil_state_dict(params))
    with torch.no_grad():
        tp, ta = tm(torch.from_numpy(x), torch.from_numpy(adj),
                    torch.from_numpy(valid))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **FWD_TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **FWD_TOL)
    assert float(ta[1, 9:].abs().sum()) == 0.0


def test_mil_loss_matches_jax():
    rng = np.random.RandomState(4)
    p = rng.rand(6, NC).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    p[0, 2] = 0.0  # log(0 + 1e-9): the epsilon is part of the idiom
    y = np.array([2, 0, 1, 4, 3, 2])
    want = jax.vmap(JMIL.mil_loss)(jnp.asarray(p), jnp.asarray(y))
    got = mil_loss(torch.from_numpy(p), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_dropout_keep_share_and_scale():
    """The keep mask: share ≈ 1 − rate, kept units scaled by 1 / keep, a
    0-d tensor rate as a float one; identity in eval and at rate 0."""
    h = torch.ones(200, 100)
    g = torch.Generator().manual_seed(0)
    for rate in (0.3, torch.tensor(0.3)):
        out = _dropout(h, rate, True, g)
        kept = out != 0
        assert abs(float(kept.float().mean()) - 0.7) < 0.01
        np.testing.assert_allclose(out[kept].numpy(), 1 / 0.7, rtol=1e-6)
    assert _dropout(h, 0.5, False, g) is h
    assert _dropout(h, 0.0, True, g) is h


# --------------------------------------------------------------- builders

@pytest.mark.parametrize("diag", [False, True])
def test_grid_builders_match_jax(diag):
    for n in (9, 16):
        want = JG.build_grid_adj(n, diag)
        got = TG.build_grid_adj(n, diag)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, np.asarray(w))
    _, valid = _bags()
    valid[2, :12] = True  # 12 valid: a 3×3 grid and three self loops
    norm, mask = TG.build_grid_adj_dynamic(torch.from_numpy(valid), diag)
    for i, v in enumerate(valid):
        jn, jmask = JG.build_grid_adj_dynamic(jnp.asarray(v), diag)
        np.testing.assert_array_equal(mask[i].numpy(), np.asarray(jmask))
        np.testing.assert_allclose(norm[i].numpy(), np.asarray(jn),
                                   rtol=1e-7)
    m = mask[2].numpy()
    assert (m[9:].sum(1) == 1).all() and (np.diag(m) == 1).all()


def test_knn_builder_matches_jax_with_exact_ties():
    """Integer features: every distance exact in float32 in both packages,
    and many exact ties, which both break toward the lower index."""
    rng = np.random.RandomState(5)
    x = rng.randint(-2, 3, (3, N_PAD, 4)).astype(np.float32)
    x[:, 5] = x[:, 3]  # planted duplicates: distance 0 and equal rows
    x[:, 7] = x[:, 3]
    _, valid = _bags()
    got = TG.build_knn_adj(torch.from_numpy(x), 5, torch.from_numpy(valid))
    for i in range(3):
        want = JG.build_knn_adj(jnp.asarray(x[i]), k=5,
                                valid=jnp.asarray(valid[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    g = got.numpy()
    assert (g.sum(-1)[valid] == 5).all() and g.sum(-1)[~valid].sum() == 0
    assert (np.diagonal(g, axis1=1, axis2=2) == 0).all()
    assert g[:, :, ~valid[1]][1].sum() == 0
    tiny = np.zeros(N_PAD, bool)
    tiny[:3] = True
    small = TG.build_knn_adj(torch.from_numpy(x[0]), 5,
                             torch.from_numpy(tiny)).numpy()
    assert (small[:3].sum(1) == 2).all() and small[3:].sum() == 0


def test_knn_full_float32_whatever_the_tf32_flags():
    """kNN takes its product in full float32 through cuBLAS's own flag and
    restores it: a caller that turned TF32 on with the legacy flag and off
    again leaves a state in which ``torch.get_float32_matmul_precision``
    raises, and the builder still runs there."""
    x = torch.from_numpy(np.random.RandomState(10).randn(N_PAD, 4)
                         .astype(np.float32))
    kept = torch.backends.cuda.matmul.fp32_precision
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        first = TG.build_knn_adj(x, 3)
        assert torch.backends.cuda.matmul.fp32_precision == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = False
        np.testing.assert_array_equal(TG.build_knn_adj(x, 3).numpy(),
                                      first.numpy())
        assert torch.backends.cuda.matmul.fp32_precision == "ieee"
    finally:
        torch.backends.cuda.matmul.fp32_precision = kept


def test_random_builder_properties():
    _, valid = _bags()
    g = torch.Generator().manual_seed(6)
    for k in (2, 4, 20):
        adj = TG.build_random_adj(N_PAD, k, torch.from_numpy(valid),
                                  generator=g).numpy()
        assert set(np.unique(adj)) <= {0.0, 1.0}
        assert (adj == adj.transpose(0, 2, 1)).all()
        assert (np.diagonal(adj, axis1=1, axis2=2) == 0).all()
        for a, v in zip(adj, valid):
            n = int(v.sum())
            assert a[~v].sum() == 0 and a[:, ~v].sum() == 0
            deg = a[v].sum(1)
            assert (deg >= min(k, n - 1)).all() and (deg <= n - 1).all()
    _, mask = TG.build_graph(torch.zeros(N_PAD, 3), "random", k=3)
    assert (mask.sum(1) >= 3).all()


# ------------------------------------------------------ splits and metrics

def test_stratified_shuffle_split_membership():
    from sklearn.model_selection import StratifiedShuffleSplit as SkSSS
    rng = np.random.RandomState(7)
    for n, seed in ((37, 0), (128, 42), (26, 3)):
        y = rng.randint(0, 5, n)
        y[:10] = np.arange(10) % 5
        X = np.zeros((n, 1))
        for ours, jax_, sk in zip(
                TS.StratifiedShuffleSplit(3, test_size=0.2,
                                          random_state=seed).split(X, y),
                JS.StratifiedShuffleSplit(3, test_size=0.2,
                                          random_state=seed).split(X, y),
                SkSSS(3, test_size=0.2, random_state=seed).split(X, y)):
            for a, b, c in zip(ours, jax_, sk):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)


def test_evaluate_probs_matches_jax():
    rng = np.random.RandomState(8)
    y = rng.randint(0, NC, 30)
    probs = rng.rand(30, NC).astype(np.float32)
    probs[:, 1] = np.round(probs[:, 1] * 4) / 4  # ties in a class's scores
    probs /= probs.sum(1, keepdims=True)
    for y_true in (y, np.where(y == 3, 0, y)):  # class 3 absent: AUC NaN
        want = JM.evaluate_probs(jnp.asarray(y_true), jnp.asarray(probs), NC,
                                 loss=jnp.float32(0.5))
        got = TMet.evaluate_probs(y_true, probs, NC, loss=0.5)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    assert np.isnan(TMet.evaluate_probs(np.where(y == 3, 0, y), probs,
                                        NC)["auc"])


# ------------------------------------------------------ one training epoch

def _train_data(seed=9, n=30, bag_n=9, f=6, k=3):
    rng = np.random.RandomState(seed)
    labels = np.arange(n) % k
    bags = []
    for i in range(n):
        b = rng.randn(bag_n - rng.randint(0, 3), f).astype(np.float32)
        b[:, labels[i]] += 1.0
        bags.append(b)
    te = [rng.randn(bag_n, f).astype(np.float32) for _ in range(6)]
    return {"train_feats": bags, "train_labels": labels,
            "test_feats": te, "test_labels": np.arange(6) % k}


def _jax_init(jmodel, is_graph, data, seed):
    """JAX ``_train_core``'s initial params (:127-131), the same draws."""
    max_n = max(b.shape[0] for b in data["train_feats"] + data["test_feats"])
    x0 = jnp.zeros((max_n, data["train_feats"][0].shape[1]))
    return jmodel.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(0)},
        x0, *((jnp.eye(max_n),) if is_graph else ()),
        valid=jnp.ones(max_n, bool))["params"]


SHIFT_INVARIANT = re.compile(r"att\d*_fc2\.bias$")


@pytest.mark.parametrize("kind", ["mil", "graph-mil"])
def test_one_epoch_matches_jax(kind, monkeypatch):
    data = _train_data()
    seed, lr = 3, 1e-2
    if kind == "mil":
        cfg = {"hidden_dim": 8, "att_dim": 4, "dropout": 0.0,
               "optimizer": "adamw", "lr": lr, "weight_decay": 1e-3}
        jmodel = JMIL.AttentionMIL(input_dim=6, hidden_dim=8, att_dim=4,
                                   dropout=0.0, num_classes=3)
        convert, j_train, t_train = (mil_state_dict, JT.train_mil,
                                     TM.train_mil)
    else:
        cfg = {"gnn_type": "gat", "gnn_hidden": 6, "gnn_layers": 2,
               "gnn_heads": 2, "gnn_dropout": 0.0, "pool_dropout": 0.0,
               "att_dim": 4, "att_heads": 2, "classifier_dim": 8,
               "graph_type": "grid", "optimizer": "adam", "lr": lr,
               "weight_decay": 1e-4}
        jmodel = JT.graph_mil_from_config(cfg, 6, 3)
        convert, j_train, t_train = (graph_mil_state_dict,
                                     JT.train_graph_mil, TM.train_graph_mil)
    start = _jax_init(jmodel, kind == "graph-mil", data, seed)
    monkeypatch.setattr(TM, "init_params_", lambda model, s: (
        model.load_state_dict(convert(start))))
    want = j_train(cfg, data, seed=seed, num_classes=3, patience=5,
                   max_epochs=1)
    got = t_train(cfg, data, seed=seed, num_classes=3, patience=5,
                  max_epochs=1, device="cpu")
    steps = int(np.ceil(0.8 * 30))  # the inner split's training bags
    w = convert(want["_best_by_bacc_params"])
    s0 = convert(start)
    assert set(w) == set(got["_best_by_bacc_params"])
    for name, t in got["_best_by_bacc_params"].items():
        if SHIFT_INVARIANT.search(name):
            assert float((t - s0[name]).abs().max()) <= lr * steps, name
            continue
        err = float((t - w[name]).abs().max())
        assert err <= STEP_TOL * lr * steps, (name, err)
        assert float((t - s0[name]).abs().max()) > 0, name  # it moved
    for key in ("val_bacc", "val_acc", "val_auc", "test_bacc"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"],
                               rtol=1e-4)
    assert len(got["_epoch_losses"]) == 1
    assert np.isfinite(got["_epoch_losses"][0])
