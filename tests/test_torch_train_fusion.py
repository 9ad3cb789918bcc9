"""Port parity for the fusion training slice: BatchNorm training and SGD
trajectories against the JAX package, the device-resident epochs and their
statistics, the fold split, early stopping, checkpoints, the stochastic
layers in distribution, the initializer families and the RNG streams.

Dropout and drop-connect draw from framework-specific RNGs, so the
trajectory tests pin them off (rates 0, or an eval-mode forward) as
``tests/test_trajectory_parity.py`` does; BatchNorm statistics, the loss
and the optimizer are the semantics under test there."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.core import early_stopping as jes
from multimodal_isic_tpu.core import rng as jrng
from multimodal_isic_tpu.core import splits as jsplits
from multimodal_isic_tpu.core.train_state import TrainState
from multimodal_isic_tpu.models import efficientnet as jeff
from multimodal_isic_tpu.models import fusion as jfu
from multimodal_isic_tpu.train import fusion as jtr
from multimodal_isic_tpu_torch.core import checkpoint as tck
from multimodal_isic_tpu_torch.core import rng as trng
from multimodal_isic_tpu_torch.core.early_stopping import EarlyStopping
from multimodal_isic_tpu_torch.core.splits import StratifiedKFold
from multimodal_isic_tpu_torch.data import augment as taug
from multimodal_isic_tpu_torch.data.pipeline import DeviceDataset
from multimodal_isic_tpu_torch.models import efficientnet as teff
from multimodal_isic_tpu_torch.models import fusion as tfu
from multimodal_isic_tpu_torch.models.convert import (
    flax_to_state_dict, state_dict_from_checkpoint)
from multimodal_isic_tpu_torch.train import fusion as ttr

BACKBONE = "efficientnet-b0"
RAD_DIM = 20
NC = 7
META_MODS = ("radiomics", "clinical", "artifacts")



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs (a B0
    step here ran 10x slower oversubscribed than on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _meta(rng, n):
    return {"radiomics": rng.randn(n, RAD_DIM).astype(np.float32),
            "age": rng.randn(n).astype(np.float32),
            "sex": rng.randint(0, 3, n).astype(np.int32),
            "loc": rng.randint(0, 15, n).astype(np.int32),
            "artifacts": rng.randint(0, 2, (n, 6)).astype(np.int32),
            "target": (np.arange(n) % NC).astype(np.int32)}


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)).long()
            if np.issubdtype(np.asarray(v).dtype, np.integer)
            else torch.from_numpy(np.array(v)) for k, v in b.items()}


@pytest.fixture(scope="module")
def image_net():
    """A JAX fusion net with the B0 image branch at 32² and perturbed
    weights (fresh-init logits are too flat to compare), and the port's
    state dict of the same weights."""
    rng = np.random.RandomState(0)
    model = jfu.MultiModalFusionNet(radiomics_dim=RAD_DIM, backbone=BACKBONE,
                                    fusion_strategy="concat")
    init_in = {k: jnp.asarray(v[:2]) for k, v in _meta(rng, 2).items()
               if k in jtr.BATCH_KEYS}
    init_in["image"] = jnp.zeros((2, 32, 32, 3), jnp.float32)
    params, stats = jtr.init_fusion(model, jax.random.PRNGKey(0), init_in)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.randn(*p.shape).astype(np.float32) * 0.05,
        params)
    stats = jax.tree_util.tree_map(
        lambda s: np.asarray(s) + np.abs(rng.randn(*s.shape)).astype(np.float32)
        * 0.1, stats)
    return model, params, stats, flax_to_state_dict(params, stats)


def _gen(seed):
    return trng.generator(seed, "cpu")


def _port_net(sd=None, **kw):
    m = tfu.MultiModalFusionNet(radiomics_dim=RAD_DIM, backbone=BACKBONE,
                                fusion_strategy="concat", **kw)
    if sd is not None:
        m.load_state_dict(sd)
    return m


# ------------------------------------------------------------ trajectories

def test_b0_bn_train_trajectory_matches_jax():
    """2 SGD steps of B0 + a linear head in train mode, float64 on both
    sides (BN's rsqrt amplifies rounding chaotically: the JAX backbone
    rounds its pooled features to f32, and by step 3 that noise reaches
    1e-4, as in tests/test_trajectory_parity.py), drop-connect and feature
    dropout pinned off: per-step losses and every running mean and
    (unbiased) variance match."""
    rng = np.random.RandomState(1)
    with jax.enable_x64(True):
        jmodel = jeff.EfficientNet(BACKBONE, num_classes=NC,
                                   drop_connect_rate=0.0,
                                   feature_dropout=False, dtype=jnp.float64)
        x0 = jnp.asarray(rng.rand(4, 32, 32, 3))
        vs = jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
            jax.random.PRNGKey(0), x0)
        params, stats = vs["params"], vs["batch_stats"]
        sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params),
                                jax.tree_util.tree_map(np.asarray, stats))
        head = torch.nn.Linear(teff.feature_dim(BACKBONE), NC).double()
        with torch.no_grad():
            head.weight.copy_(sd.pop("fc.weight"))
            head.bias.copy_(sd.pop("fc.bias"))
        tmodel = teff.EfficientNet(BACKBONE, drop_connect_rate=0.0,
                                   feature_dropout=False, dtype=torch.float64)
        tmodel.load_state_dict(sd)
        tmodel.double().train()
        topt = torch.optim.SGD(list(tmodel.parameters())
                               + list(head.parameters()),
                               lr=1e-3, weight_decay=1e-4)

        from multimodal_isic_tpu.core.optim import sgd
        opt = sgd(1e-3, momentum=0.0, weight_decay=1e-4)
        state = TrainState.create(params, opt, jax.random.PRNGKey(1))

        @jax.jit
        def step(state, stats, x, y):
            def loss_fn(p):
                logits, mut = jmodel.apply(
                    {"params": p, "batch_stats": stats}, x, train=True,
                    mutable=["batch_stats"])
                return jtr.cross_entropy(logits, y), mut["batch_stats"]
            (loss, new_stats), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(state.params)
            return state.apply_gradients(grads, opt), new_stats, loss

        for i in range(2):
            x = rng.rand(4, 32, 32, 3)
            y = rng.randint(0, NC, 4)
            state, stats, loss_j = step(state, stats, jnp.asarray(x),
                                        jnp.asarray(y))
            logits = head(tmodel(torch.from_numpy(x)).double())
            loss_t = ttr.cross_entropy(logits, torch.from_numpy(y))
            topt.zero_grad()
            loss_t.backward()
            topt.step()
            assert float(loss_t.detach()) == pytest.approx(float(loss_j),
                                                           rel=1e-6), i

        got = {k: v.numpy() for k, v in tmodel.state_dict().items()}
        want = flax_to_state_dict({}, jax.tree_util.tree_map(np.asarray, stats))
        assert len(want) == sum("running" in k for k in got)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        assert np.abs(got["head_bn.running_var"] - 1.0).max() > 1e-4


def test_fusion_sgd_trajectory_matches_jax():
    """5 SGD steps of the backbone-free fusion net through the port's
    ``make_fusion_train_step`` (model in eval mode: dropout off, gradients
    flow) against the JAX step with ``train=False``: per-step losses and
    correct counts, and the final weights."""
    rng = np.random.RandomState(2)
    jmodel = jfu.MultiModalFusionNet(modality=META_MODS, radiomics_dim=RAD_DIM,
                                     fusion_strategy="concat")
    batches = [_meta(rng, 8) for _ in range(5)]
    for b in batches:
        b["target"] = rng.randint(0, NC, 8).astype(np.int32)
    jin = {k: jnp.asarray(v) for k, v in batches[0].items()
           if k in jtr.BATCH_KEYS}
    params, _ = jtr.init_fusion(jmodel, jax.random.PRNGKey(0), jin)
    tmodel = tfu.MultiModalFusionNet(modality=META_MODS,
                                     radiomics_dim=RAD_DIM,
                                     fusion_strategy="concat")
    tmodel.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    tmodel.eval()
    tstep = ttr.make_fusion_train_step(tmodel, ttr.fusion_optimizer(tmodel))

    opt = jtr.fusion_optimizer()
    state = TrainState.create(params, opt, jax.random.PRNGKey(1))

    @jax.jit
    def jstep(state, batch):
        def loss_fn(p):
            logits = jmodel.apply({"params": p},
                                  **{k: batch[k] for k in jtr.BATCH_KEYS
                                     if k in batch}, train=False)
            return jtr.cross_entropy(logits, batch["target"]), logits
        (loss, logits), g = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        correct = jnp.sum(jnp.argmax(logits, 1) == batch["target"])
        return state.apply_gradients(g, opt), loss, correct

    for b in batches:
        state, loss_j, corr_j = jstep(state, {k: jnp.asarray(v)
                                              for k, v in b.items()})
        loss_t, corr_t = tstep(_torch_batch(b))
        assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
        assert int(corr_t) == int(corr_j)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     state.params))
    for k, v in tmodel.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ------------------------------------------------------------------ epochs

def test_eval_epoch_matches_jax(image_net):
    """``make_fusion_eval_epoch`` with ``padded_epoch_order`` (10 rows in
    batches of 4: the last batch half padding) against the JAX one."""
    jmodel, params, stats, sd = image_net
    rng = np.random.RandomState(3)
    n, bs, out_hw = 10, 4, (32, 32)
    imgs = rng.randint(0, 256, (n, 40, 40, 3)).astype(np.uint8)
    meta = _meta(rng, n)
    order, valid = ttr.padded_epoch_order(n, bs)
    jorder, jvalid = jtr.padded_epoch_order(n, bs)
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_array_equal(valid, jvalid)
    assert order.shape == (3, 4) and valid.sum() == n

    jloss, jcorr = jtr.make_fusion_eval_epoch(jmodel, out_hw)(
        params, stats, jnp.asarray(imgs),
        {k: jnp.asarray(v) for k, v in meta.items()}, jnp.asarray(order),
        jnp.asarray(valid))
    ds = DeviceDataset(imgs, meta, device="cpu", with_masks=False)
    model = _port_net(sd)
    loss, corr = ttr.make_fusion_eval_epoch(model, out_hw)(
        ds.images, ds.meta, order, valid)
    assert loss == pytest.approx(float(jloss), rel=1e-4, abs=1e-5)
    assert corr == int(jcorr)
    assert model.training  # modes restored
    # the statistic is the unweighted mean of per-batch means
    step = ttr.make_fusion_eval_step(model)
    per_batch = []
    for idx, vm in zip(order, valid):
        b = {k: v[idx[vm]] for k, v in ds.meta.items()}
        b["image"] = taug.preprocess_eval_batch(ds.images[idx[vm]], out_hw)
        per_batch.append(float(step(b)[0]))
    assert loss == pytest.approx(np.mean(per_batch), rel=1e-5)


def test_train_epoch_equals_manual_loop_of_its_step():
    """The device-resident epoch (gather → fast policy → step) against a
    manual loop of ``make_fusion_train_step`` with the same generators and
    weights: bit-identical losses, counts and final state."""
    rng = np.random.RandomState(4)
    n, bs, out_hw = 12, 4, (32, 32)
    imgs = rng.randint(0, 256, (n, 36, 36, 3)).astype(np.uint8)
    ds = DeviceDataset(imgs, _meta(rng, n), device="cpu", with_masks=False)
    a = ttr.build_fusion(_gen(5), radiomics_dim=RAD_DIM, backbone=BACKBONE,
                         fusion_strategy="concat")
    b = copy.deepcopy(a)
    tf = taug.make_fusion_train_fast(out_hw)
    order = ds.epoch_order(bs, rng.permutation(n))

    epoch = ttr.make_fusion_train_epoch(a, ttr.fusion_optimizer(a), tf)
    loss, corr = epoch(ds.images, ds.masks, ds.meta, order,
                       _gen(6), _gen(7))

    step = ttr.make_fusion_train_step(b, ttr.fusion_optimizer(b))
    g_aug, g_drop = _gen(6), _gen(7)
    losses, total = [], 0
    for idx in order:
        batch = {k: v[idx] for k, v in ds.meta.items()}
        batch["image"] = tf(ds.images[idx], None, g_aug)[0]
        l, c = step(batch, g_drop)
        losses.append(l)
        total += int(c)
    assert loss == float(torch.stack(losses).mean())
    assert corr == total
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    changed = [k for k, v in a.state_dict().items()
               if "running" in k and not torch.equal(
                   v, torch.zeros_like(v) if "mean" in k else torch.ones_like(v))]
    assert changed, "BN running statistics never moved"


def test_train_and_validate_epoch_loops_and_logging():
    rng = np.random.RandomState(8)
    model = tfu.MultiModalFusionNet(modality=META_MODS, radiomics_dim=RAD_DIM,
                                    fusion_strategy="weighted")
    ttr.init_fusion(model, _gen(0))
    batches = [_torch_batch(_meta(rng, 4)) for _ in range(3)]
    logged = []

    class Logger:
        def log(self, k, v, step):
            logged.append((k, v, step))

        def print(self, msg):
            pass

    step = ttr.make_fusion_train_step(model, ttr.fusion_optimizer(model))
    loss, acc = ttr.train_epoch(step, model, batches,
                                trng.RngStream(0, "dropout", "cpu"), Logger(), 1)
    assert np.isfinite(loss) and 0 <= acc <= 1
    keys = [k for k, _, _ in logged]
    assert "train/epoch_loss" in keys
    assert "model/fusion_weight_modality_2" in keys
    vloss = ttr.validate_epoch(ttr.make_fusion_eval_step(model), batches,
                               Logger(), 1)
    step_fn = ttr.make_fusion_eval_step(model)
    assert vloss == pytest.approx(np.mean([float(step_fn(b)[0])
                                           for b in batches]), rel=1e-6)
    assert ("val/epoch_loss", vloss, 1) in logged


def test_eval_step_leaves_training_model_in_train_mode():
    """A validation pass between train steps must not switch BatchNorm
    and dropout off: after ``make_fusion_eval_step`` and
    ``make_fusion_eval_epoch`` a train step still moves the BN running
    statistics and applies dropout."""
    rng = np.random.RandomState(9)
    model = _port_net()
    ttr.init_fusion(model, _gen(1))
    batch = _torch_batch(_meta(rng, 4))
    batch["image"] = torch.from_numpy(rng.randn(4, 32, 32, 3).astype(np.float32))
    ttr.make_fusion_eval_step(model)(batch)
    ds = DeviceDataset(rng.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8),
                       _meta(rng, 4), device="cpu", with_masks=False)
    ttr.make_fusion_eval_epoch(model, (32, 32))(
        ds.images, ds.meta, *ttr.padded_epoch_order(4, 4))
    assert all(m.training for m in model.modules())

    stem = model.image_model.stem_bn.running_mean.clone()
    step = ttr.make_fusion_train_step(model, torch.optim.SGD(
        model.parameters(), lr=0.0))  # lr 0: only the statistics move
    l1, _ = step(batch, _gen(2))
    l2, _ = step(batch, _gen(3))
    assert not torch.equal(model.image_model.stem_bn.running_mean, stem)
    assert float(l1) != float(l2)  # other dropout masks, same weights

    folded = _port_net(tfu.fold_fusion_params(model.state_dict(), BACKBONE),
                       backbone_bn_folded=True)
    assert not folded.image_model.training  # inference-only, starts in eval
    ttr.make_fusion_eval_step(folded)(batch)
    assert folded.training and not folded.image_model.training
    with pytest.raises(ValueError):
        folded.train()(**{k: batch[k] for k in ttr.BATCH_KEYS},
                       rng=_gen(0))


# ------------------------------------------------------------ core modules

@pytest.mark.parametrize("n_splits,shuffle,seed", [(10, True, 0), (5, False, None),
                                                   (3, True, 42)])
def test_stratified_kfold_matches_jax(n_splits, shuffle, seed):
    rng = np.random.RandomState(10)
    y = rng.choice(["nv", "mel", "bkl", "bcc", "akiec", "vasc", "df"], 160,
                   p=[.4, .2, .15, .1, .08, .04, .03])
    got = list(StratifiedKFold(n_splits, shuffle, seed).split(None, y))
    want = list(jsplits.StratifiedKFold(n_splits, shuffle, seed).split(None, y))
    assert len(got) == len(want) == n_splits
    for (tr, te), (jtr_, jte) in zip(got, want):
        np.testing.assert_array_equal(tr, jtr_)
        np.testing.assert_array_equal(te, jte)


def test_early_stopping_counter_and_deep_copy():
    losses = [1.0, 0.9, 0.95, 0.97, 0.85, 0.9, 0.91, 0.92]
    ours, ref = EarlyStopping(patience=3), jes.EarlyStopping(patience=3)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    snap = None
    for v in losses:
        stop = ours(v, model.state_dict())
        assert stop == bool(ref(v, {"w": 0}))
        assert ours.counter == ref.counter
        if v == ours.best_loss:
            snap = {k: t.clone() for k, t in model.state_dict().items()}
        loss = model(torch.ones(1, 3)).sum()  # a step after the snapshot
        opt.zero_grad()
        loss.backward()
        opt.step()
        if stop:
            break
    best = ours.get_best_params()
    for k, t in best.items():
        assert torch.equal(t, snap[k]), k  # later steps changed nothing
        assert not torch.equal(t, model.state_dict()[k])


def test_checkpoint_round_trip_and_convert(tmp_path, image_net):
    _, _, _, sd = image_net
    model = _port_net(sd).eval()
    path = tck.save_checkpoint(str(tmp_path / "ckpt"), model.state_dict(),
                               step=3, metadata={"epoch": 3})
    assert path.endswith("step_00000003")
    back = tck.restore_checkpoint(path, target=model.state_dict())
    from_convert = state_dict_from_checkpoint(path)
    assert back.keys() == model.state_dict().keys() == from_convert.keys()
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v) and torch.equal(from_convert[k], v), k
    fresh = _port_net(back).eval()
    x = {k: v for k, v in _torch_batch(_meta(np.random.RandomState(11), 3)
                                       ).items() if k in ttr.BATCH_KEYS}
    x["image"] = torch.randn(3, 32, 32, 3, generator=_gen(0))
    with torch.no_grad():
        assert torch.equal(fresh(**x), model(**x))
    with pytest.raises(ValueError):
        tck.restore_checkpoint(path, target={"other": torch.zeros(1)})


# --------------------------------------------- stochastic layers and init

def test_dropout_and_drop_connect_in_distribution():
    g = _gen(12)
    x = torch.ones(400, 500)
    y = teff.dropout(x, 0.3, True, g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert torch.equal(teff.dropout(x, 0.3, False, None), x)
    z = teff.drop_connect(torch.ones(20000, 2, 2, 3), 0.2, True, g)
    per_sample = z.flatten(1)
    assert bool((per_sample == per_sample[:, :1]).all())  # one flag a sample
    kept = per_sample[:, 0] != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.01
    torch.testing.assert_close(per_sample[kept, 0],
                               torch.full_like(per_sample[kept, 0], 1 / 0.8))
    with pytest.raises(ValueError):
        teff.dropout(x, 0.3, True, None)
    # the backbone's rates: drop_connect_rate·i/n per block, PARAMS dropout
    net = teff.EfficientNet("efficientnet-b3")
    rates = [b.drop_rate for b in net.blocks]
    assert rates[0] == 0.0 and rates[-1] == pytest.approx(0.2 * 25 / 26)
    assert net.dropout_rate == 0.3


def test_init_fusion_families():
    model = _port_net()
    ttr.init_fusion(model, _gen(13))
    w = model.radiomics_mlp.fc1.weight.detach()  # Dense 20 → 256
    assert float(w.std()) == pytest.approx(1 / np.sqrt(RAD_DIM), rel=0.05)
    assert float(w.abs().max()) <= 2 / np.sqrt(RAD_DIM) / 0.87962566103423978
    dw = model.image_model.blocks[1].depthwise_conv.weight.detach()  # K·K
    assert float(dw.abs().max()) <= 2 / 3 / 0.87962566103423978 + 1e-6
    assert not model.radiomics_mlp.fc1.bias.any()
    bn = model.image_model.blocks[1].bn1
    assert bool((bn.weight == 1).all() and (bn.running_var == 1).all())
    emb = model.loc_emb.weight.detach()
    assert float(emb.std()) == pytest.approx(1 / np.sqrt(8), rel=0.35)
    # built on the meta device, then every tensor from the generator alone
    again = ttr.build_fusion(_gen(13), radiomics_dim=RAD_DIM,
                             backbone=BACKBONE, fusion_strategy="concat")
    assert model.state_dict().keys() == again.state_dict().keys()
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def test_rng_streams():
    assert trng._stable_hash("augment") == jrng._stable_hash("augment")
    pool = trng.RngPool(3, "cpu")
    a1 = torch.rand(4, generator=pool["augment"].next())
    a2 = torch.rand(4, generator=pool["augment"].next())
    again = trng.RngPool(3, "cpu")
    again["dropout"].next()  # another consumer perturbs nothing
    assert torch.equal(torch.rand(4, generator=again["augment"].next()), a1)
    assert not torch.equal(a1, a2)
    assert torch.equal(torch.rand(4, generator=pool["augment"].at(1)), a2)
    gens = trng.RngStream(3, "x", "cpu").split(3)
    draws = [torch.rand(2, generator=g) for g in gens]
    assert not torch.equal(draws[0], draws[1])


def test_device_dataset_orders_and_loader():
    rng = np.random.RandomState(14)
    imgs = rng.randint(0, 256, (10, 8, 8, 3)).astype(np.uint8)
    ds = DeviceDataset(imgs, _meta(rng, 10), device="cpu", with_masks=False)
    assert ds.masks is None and ds.meta["sex"].dtype == torch.int64
    order = ds.epoch_order(4, np.arange(10)[::-1])
    np.testing.assert_array_equal(order, [[9, 8, 7, 6], [5, 4, 3, 2]])
    batches = list(ds.loader(4))
    assert [len(b["target"]) for b in batches] == [4, 4, 2]
    assert torch.equal(batches[1]["image"], torch.from_numpy(imgs[4:8]))
    assert len(list(ds.loader(4, drop_last=True))) == 2
    with pytest.raises(ValueError):
        DeviceDataset(imgs, _meta(rng, 10), device="cpu")  # masks needed
