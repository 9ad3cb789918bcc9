"""Port parity: the PyTorch EfficientNet (``multimodal_isic_tpu_torch``)
against the JAX package's, with the same (perturbed) weights carried over by
``models/convert.py``.  B0 at an odd 63² input, so that SAME padding of the
stride-2 convs is asymmetric.  The JAX folded model runs its Pallas kernels
in interpret mode; the port's folded ``pallas_serving`` model runs its
kernel wrappers, which on the CPU take their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.models import efficientnet as jeff
from multimodal_isic_tpu_torch.models import efficientnet as teff
from multimodal_isic_tpu_torch.models.convert import flax_to_state_dict
from multimodal_isic_tpu_torch.ops import fused_dwconv as tfd

NAME = "efficientnet-b0"
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def jax_model():
    """(x, params, batch_stats) of a JAX B0 with perturbed weights and
    non-trivial running statistics (fresh-init outputs are ~1e-7, which would
    make the comparisons vacuous)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 63, 63, 3).astype(np.float32)
    vs = jeff.EfficientNet(model_name=NAME).init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.randn(*p.shape).astype(np.float32) * 0.05,
        vs["params"])
    stats = jax.tree_util.tree_map(np.asarray, vs["batch_stats"])
    for blk in stats.values():
        leaves = blk.values() if "mean" not in blk else [blk]
        for s in leaves:
            s["mean"] = (rng.randn(*s["mean"].shape) * 0.1).astype(np.float32)
            s["var"] = rng.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)
    return x, params, stats


def test_standard_bn_matches_jax(jax_model):
    x, params, stats = jax_model
    yj = jeff.EfficientNet(model_name=NAME).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    model = teff.EfficientNet(NAME).eval()
    model.load_state_dict(flax_to_state_dict(params, stats))
    with torch.no_grad():
        yt = model(torch.from_numpy(x))
    assert yt.dtype == torch.float32 and yt.shape == (2, teff.feature_dim(NAME))
    assert float(np.abs(np.asarray(yj)).max()) > 1e-2  # non-vacuous
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


def test_fold_batchnorm_matches_jax(jax_model):
    _, params, stats = jax_model
    folded_j = flax_to_state_dict(jeff.fold_batchnorm(params, stats, NAME))
    folded_t = teff.fold_batchnorm(flax_to_state_dict(params, stats), NAME)
    assert folded_t.keys() == folded_j.keys()
    for k in folded_j:
        np.testing.assert_allclose(folded_t[k].numpy(), folded_j[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    # the folded state dict loads into the folded port model as it is
    teff.EfficientNet(NAME, bn_folded=True).load_state_dict(folded_t)


def test_folded_pallas_serving_matches_jax(jax_model, monkeypatch):
    x, params, stats = jax_model
    folded = jeff.fold_batchnorm(params, stats, NAME)
    yj = jeff.EfficientNet(model_name=NAME, bn_folded=True,
                           pallas_serving=True).apply(
        {"params": folded}, jnp.asarray(x), train=False)

    sd = teff.fold_batchnorm(flax_to_state_dict(params, stats), NAME)
    served = teff.EfficientNet(NAME, bn_folded=True, pallas_serving=True)
    served.load_state_dict(sd)
    plain = teff.EfficientNet(NAME, bn_folded=True)
    plain.load_state_dict(sd)

    calls = {"dw": 0, "expand": 0}

    def spy(key, fn):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(tfd, "dw_silu_pool", spy("dw", tfd.dw_silu_pool))
    monkeypatch.setattr(tfd, "expand_dw_silu_pool",
                        spy("expand", tfd.expand_dw_silu_pool))
    with torch.no_grad():
        yt = served(torch.from_numpy(x))
        yp = plain(torch.from_numpy(x))
    blocks = teff.block_args(NAME)
    assert calls["dw"] == sum(e == 1 and s == 1 for e, _, s, _, _ in blocks)
    assert calls["expand"] == sum(e != 1 and s == 1 for e, _, s, _, _ in blocks)
    assert float(np.abs(np.asarray(yj)).max()) > 1e-2
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)


def test_same_pads_asymmetric():
    # the B3@380 stride-2 convs: stem and blocks 2, 5, 8, 18
    from multimodal_isic_tpu.ops.depthwise import same_pads as jpads
    from multimodal_isic_tpu_torch.ops.depthwise import same_pads as tpads
    cases = [(380, 3, (0, 1)), (190, 3, (0, 1)), (95, 5, (2, 2)),
             (48, 3, (0, 1)), (24, 5, (1, 2)), (63, 3, (1, 1)), (32, 5, (1, 2))]
    for n, k, want in cases:
        assert tpads(n, k, 2) == jpads(n, k, 2) == want
