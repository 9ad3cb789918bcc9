"""The port's ConvMAE training slice against the JAX package, on the tiny
128-aligned model (``tests/test_torch_convmae.py``'s configuration) with
seeded JAX params carried over by ``convmae_state_dict``: three train steps
against ``make_mae_train_step`` on JAX's masking draws (plain path and all
three kernel flags in float32, the plain path in bf16, and a start from JAX's
step-1 ``OptState`` through ``convmae_adamw_state``); the AdamW group split on
the ConvViT-Base names; the device-resident epoch against its steps;
``train_mae``'s best-state copy against its checkpoint; the train-state
checkpoint round trip."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.core.train_state import TrainState
from multimodal_isic_tpu.models import convmae as J
from multimodal_isic_tpu.train import mae as jmae
from multimodal_isic_tpu_torch.core import checkpoint as tckpt
from multimodal_isic_tpu_torch.core.rng import RngPool, generator
from multimodal_isic_tpu_torch.data.augment import POLICIES
from multimodal_isic_tpu_torch.models import convmae as T
from multimodal_isic_tpu_torch.models.convert import (convmae_adamw_state,
                                                      convmae_state_dict)
from multimodal_isic_tpu_torch.train import mae as tmae

CFG = dict(img_size=32, embed_dims=(128, 128, 128), depths=(1, 1, 1),
           num_heads=4, decoder_dim=128, decoder_depth=1, decoder_heads=4,
           norm_pix_loss=True)
ALL = dict(use_fused_mlp=True, use_fused_front=True, use_flash_attention=True)
BATCH, STEPS, RATIO = 4, 3, 0.75
# Parameters after AdamW steps, port vs JAX, each element's error in units
# of lr·steps, its group's learning rate times the steps taken: about what
# AdamW moves a weight with a steady gradient in those steps, so a missing or
# wrong update of any tensor shows, in the encoder (lr 1e-5) too.  Each tensor must keep the fraction ``bulk[0]`` of
# its elements within ``bulk[1]`` and every element within ``every``.
# Exempt: the key third of each qkv bias, whose gradient is exactly zero
# (softmax ignores a shift shared by all keys) and computed as rounding
# noise, which Adam divides by its own magnitude into updates of up to lr.
# float32: losses to 1e-5; 99% of each tensor within 0.03 (measured 100%;
# 0.01 holds 99.2%: the LayerNorm scales near 1 sit at a few ulps), every
# element within 0.1 (measured worst 0.037).  bf16: the two frameworks flip
# some bf16 roundings differently (tests/test_torch_convmae.py) and Adam
# turns a flip in a small gradient into a different step: losses to 2e-3,
# 95% of each tensor within 0.1 (measured 98.4% at worst), every element
# within 2 (measured worst 1.35).
STEP_TOL = {torch.float32: dict(loss=1e-5, bulk=(0.99, 0.03), every=0.1),
            torch.bfloat16: dict(loss=2e-3, bulk=(0.95, 0.1), every=2.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _jax_params():
    """Seeded JAX params (numpy leaves), no parameter at its trivial init;
    only the shapes come from flax (``eval_shape``: no compile of init)."""
    shapes = jax.eval_shape(lambda k: J.ConvMAE(**CFG).init(
        {"params": k}, jnp.zeros((1, 32, 32, 3)), mask_ratio=0.0),
        jax.random.PRNGKey(0))["params"]
    rng = np.random.RandomState(1)

    def draw(path, leaf):
        z = rng.randn(*leaf.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        return z * np.float32(0.02) + np.float32(path[-1].key == "scale")
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _images():
    return np.random.RandomState(0).randn(BATCH, 32, 32, 3).astype(np.float32)


def _keys():
    return [jax.random.PRNGKey(10 + i) for i in range(STEPS)]


def _draws(key):
    """JAX's masking draws for ``key``, as the JAX step makes them."""
    return tuple(torch.from_numpy(np.array(a)) for a in
                 J.random_masking(key, BATCH, 4, RATIO))


@functools.lru_cache(maxsize=None)
def _jax_run(flag_key: str, dtype: str):
    """JAX's three train steps → (losses, params after each step, the
    OptState after step 1), numpy leaves."""
    flags = ALL if flag_key == "all" else {}
    jm = J.ConvMAE(**CFG, **flags, dtype=getattr(jnp, dtype))
    opt = jmae.mae_optimizer()
    state = TrainState.create(_jax_params(), opt, jax.random.PRNGKey(0))
    step = jmae.make_mae_train_step(jm, opt, RATIO)
    losses, params, opt1 = [], [], None
    for key in _keys():
        state, loss = step(state, jnp.asarray(_images()), None, key)
        losses.append(float(loss))
        params.append(jax.device_get(state.params))
        opt1 = opt1 or jax.device_get(state.opt_state)
    return losses, params, opt1


def _port(dtype=torch.float32, params=None, **flags):
    model = T.ConvMAE(**CFG, dtype=dtype, **flags)
    model.load_state_dict(convmae_state_dict(params or _jax_params()))
    return model


def _hold(model, optimizer, want_params, tol, steps=STEPS):
    """Every parameter tensor against JAX's after ``steps`` steps, errors in
    units of its group's lr·steps (``STEP_TOL``)."""
    want = convmae_state_dict(want_params)
    lr = {id(p): g["lr"] for g in optimizer.param_groups for p in g["params"]}
    params = dict(model.named_parameters())
    assert set(params) == set(want)
    for k, v in params.items():
        err = (v.detach() - want[k]).abs().flatten() / (lr[id(v)] * steps)
        if k.endswith("qkv.bias"):
            c = err.numel() // 3
            assert bool(torch.isfinite(err[c:2 * c]).all()), k
            err = torch.cat([err[:c], err[2 * c:]])
        frac, within = tol["bulk"]
        assert float((err <= within).float().mean()) >= frac, \
            (k, float((err <= within).float().mean()))
        assert float(err.max()) <= tol["every"], (k, float(err.max()))


@pytest.mark.parametrize("flag_key,dtype", [("plain", "float32"),
                                            ("all", "float32"),
                                            ("plain", "bfloat16")])
def test_train_steps_match_jax(flag_key, dtype):
    tdt = getattr(torch, dtype)
    want_losses, want_params, _ = _jax_run(flag_key, dtype)
    model = _port(tdt, **(ALL if flag_key == "all" else {}))
    opt = tmae.mae_optimizer(model)
    step = tmae.make_mae_train_step(model, opt, RATIO)
    x = torch.from_numpy(_images())
    losses = [float(step(x, masking=_draws(k))) for k in _keys()]
    tol = STEP_TOL[tdt]
    np.testing.assert_allclose(losses, want_losses, rtol=tol["loss"])
    assert losses[-1] < losses[0]
    _hold(model, opt, want_params[-1], tol)
    assert all(p.grad is not None for p in model.parameters())


def test_train_from_jax_step_one_state():
    """The port started from JAX's params and AdamW state after step 1
    (``convmae_adamw_state``) takes steps 2 and 3 to JAX's step 3."""
    want_losses, want_params, opt1 = _jax_run("plain", "float32")
    model = _port(params=want_params[0])
    opt = tmae.mae_optimizer(model)
    opt.load_state_dict(convmae_adamw_state(opt1, model, opt))
    assert tmae.optimizer_step_count(opt) == 1
    step = tmae.make_mae_train_step(model, opt, RATIO)
    x = torch.from_numpy(_images())
    losses = [float(step(x, masking=_draws(k))) for k in _keys()[1:]]
    np.testing.assert_allclose(losses, want_losses[1:], rtol=1e-5)
    _hold(model, opt, want_params[-1], STEP_TOL[torch.float32], steps=2)


def test_adamw_groups_on_convvit_base_names():
    with torch.device("meta"):
        model = T.convmae_convvit_base_patch16_dec512d8b()
    opt = tmae.mae_optimizer(model)
    enc, dec = opt.param_groups
    assert (enc["name"], enc["lr"], dec["name"], dec["lr"]) == \
        ("encoder", 1e-5, "decoder", 1e-3)
    assert enc["betas"] == dec["betas"] == (0.9, 0.95)
    assert enc["weight_decay"] == dec["weight_decay"] == 0.05
    names = {id(p): n for n, p in model.named_parameters()}
    enc_names = [names[id(p)] for p in enc["params"]]
    dec_names = [names[id(p)] for p in dec["params"]]
    assert len(enc_names) + len(dec_names) == len(names)
    assert all("decoder" in n for n in dec_names)
    assert not any("decoder" in n for n in enc_names)
    # the reference splits on "decoder" only: mask_token trains at the
    # encoder rate, and so do pos_embed and the conv stages
    for n in ("mask_token", "pos_embed", "patch_embed1.proj.weight",
              "blocks1.0.mlp.fc1.weight", "blocks3.10.attn.qkv.bias"):
        assert n in enc_names
    for n in ("decoder_embed.weight", "decoder_blocks.7.mlp.fc2.bias",
              "decoder_norm.weight", "decoder_pred.bias"):
        assert n in dec_names


def _staged(n=10, hw=40, seed=3):
    rng = np.random.RandomState(seed)
    imgs = torch.from_numpy(rng.randint(0, 256, (n, hw, hw, 3)).astype(np.uint8))
    masks = torch.from_numpy((rng.rand(n, hw, hw) > 0.6).astype(np.uint8) * 255)
    return imgs, masks


def _train_policy(imgs, masks, gen):
    return POLICIES["mae_train"](imgs, masks, gen, (32, 32))


def test_train_epoch_equals_its_steps():
    """The device-resident epoch (gather → mae_train → lesion-guided step)
    is its steps run by hand on the same generators, bit for bit."""
    imgs, masks = _staged()
    order = np.random.RandomState(0).randint(0, 10, (3, BATCH))
    runs = []
    for by_hand in (False, True):
        model = _port(use_fused_mlp=True)
        opt = tmae.mae_optimizer(model)
        aug, msk = generator(5, "cpu"), generator(6, "cpu")
        if by_hand:
            step = tmae.make_mae_train_step(model, opt, RATIO,
                                            use_lesion_mask=True)
            losses = []
            for idx in torch.as_tensor(order):
                x, m = _train_policy(imgs[idx], masks[idx], aug)
                losses.append(step(x, m, msk))
            loss = float(torch.stack(losses).mean())
        else:
            epoch = tmae.make_mae_train_epoch(model, opt, RATIO, True,
                                              _train_policy)
            loss = epoch(imgs, masks, order, aug, msk)
        runs.append((loss, model.state_dict()))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def _eval_policy(imgs, masks):
    return POLICIES["mae_eval"](imgs, masks, (32, 32))


def _fused(model, opt, imgs, masks, order):
    train = tmae.make_mae_train_epoch(model, opt, RATIO, False, _train_policy)
    val = tmae.make_mae_eval_epoch(model, RATIO, _eval_policy)
    return (lambda epoch, aug, msk: train(imgs, masks, order, aug, msk),
            lambda gen: val(imgs, masks, order, generator(9, "cpu")))


@pytest.mark.parametrize("vals,best", [((1.0, 2.0, 3.0), 0),
                                       ((3.0, 1.0, 2.0), 1)])
def test_train_mae_keeps_a_copy_of_the_best_state(tmp_path, vals, best):
    """The best epoch's weights survive the later epochs' steps, and equal
    what the checkpoint of that epoch restores."""
    imgs, masks = _staged()
    order = np.arange(8).reshape(2, BATCH)
    model = _port()
    opt = tmae.mae_optimizer(model)
    fused_train, fused_val = _fused(model, opt, imgs, masks, order)
    val_losses = iter(vals)
    out = tmae.train_mae(model, opt, fused_train,
                         lambda gen: (fused_val(gen), next(val_losses))[1],
                         3, RngPool(0, "cpu"), checkpoint_dir=str(tmp_path))
    assert out["best_val_loss"] == 1.0
    assert [h["val_loss"] for h in out["history"]] == list(vals)
    assert out["checkpoint"].endswith(f"step_{2 * (best + 1):08d}")
    saved = T.ConvMAE(**CFG)
    meta = tckpt.restore_train_state(out["checkpoint"], saved)
    assert (meta["epoch"], meta["val_loss"]) == (best, 1.0)
    for k, v in saved.state_dict().items():
        assert torch.equal(v, out["best_state"][k]), k
    assert any(not torch.equal(v, model.state_dict()[k])
               for k, v in out["best_state"].items())


def test_train_state_checkpoint_round_trip(tmp_path):
    """Model + AdamW moments + step + RNG pool counters restored into a
    fresh model and optimizer: the same validation loss bit for bit, and
    the next step lands on the same weights."""
    imgs, masks = _staged()
    order = np.arange(8).reshape(2, BATCH)
    model = _port(use_fused_mlp=True)
    opt = tmae.mae_optimizer(model)
    pool = RngPool(0, "cpu")
    fused_train, fused_val = _fused(model, opt, imgs, masks, order)
    out = tmae.train_mae(model, opt, fused_train, fused_val, 2, pool,
                         checkpoint_dir=str(tmp_path))
    fresh = T.ConvMAE(**CFG, use_fused_mlp=True)
    fresh_opt = tmae.mae_optimizer(fresh)
    fresh_pool = RngPool(0, "cpu")
    meta = tckpt.restore_train_state(out["checkpoint"], fresh, fresh_opt,
                                     fresh_pool)
    assert meta["step"] == 4 and fresh_pool.state() == pool.state()
    assert torch.equal(fresh_pool["mask"].next().get_state(),
                       pool["mask"].next().get_state())
    assert fresh_opt.state_dict()["param_groups"] == \
        opt.state_dict()["param_groups"]
    _, fresh_val = _fused(fresh, fresh_opt, imgs, masks, order)
    assert fresh_val(None) == out["history"][-1]["val_loss"]
    x = _train_policy(imgs[:BATCH], masks[:BATCH], generator(1, "cpu"))[0]
    draws = fresh.masking(BATCH, RATIO, generator(2, "cpu"))
    for m, o in ((model, opt), (fresh, fresh_opt)):
        tmae.make_mae_train_step(m, o, RATIO)(x, masking=draws)
    for k, v in model.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k
