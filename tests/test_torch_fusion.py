"""Port parity: the PyTorch ``MultiModalFusionNet`` against the JAX one for
all 6 fusion level × strategy combinations, with the same (perturbed) weights
carried over by ``models/convert.py`` — also from a checkpoint directory
written by the JAX package's ``core.checkpoint.save_checkpoint``.  Five
combinations take pre-extracted ``image_features``; one runs the B0 image
branch on a 32² image."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.core.checkpoint import save_checkpoint
from multimodal_isic_tpu.models import fusion as jfu
from multimodal_isic_tpu_torch.models import fusion as tfu
from multimodal_isic_tpu_torch.models.convert import (
    flax_to_state_dict, state_dict_from_checkpoint)

BACKBONE = "efficientnet-b0"
RAD_DIM = 20
COMBOS = [(level, strategy) for level in ("intermediate", "late")
          for strategy in ("concat", "weighted", "attention")]
IMAGE_COMBO = ("intermediate", "attention")


def _inputs(with_image):
    rng = np.random.RandomState(1)
    b = 4
    out = {
        "radiomics": rng.randn(b, RAD_DIM).astype(np.float32),
        "age": rng.randn(b).astype(np.float32),
        "sex": rng.randint(0, 3, b).astype(np.int64),
        "loc": rng.randint(0, 15, b).astype(np.int64),
        "artifacts": rng.randint(0, 2, (b, 6)).astype(np.int64),
    }
    if with_image:
        out["image"] = rng.randn(b, 32, 32, 3).astype(np.float32)
    else:
        out["image_features"] = rng.randn(b, 1280).astype(np.float32)
    return out


def _jax_model(level, strategy):
    """(inputs, JAX model, params, batch_stats) with perturbed params."""
    inputs = _inputs((level, strategy) == IMAGE_COMBO)
    model = jfu.MultiModalFusionNet(fusion_level=level,
                                    fusion_strategy=strategy,
                                    radiomics_dim=RAD_DIM, backbone=BACKBONE)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    vs = model.init(jax.random.PRNGKey(0), **jin, train=False)
    rng = np.random.RandomState(2)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.randn(*p.shape).astype(np.float32) * 0.05,
        vs["params"])
    stats = jax.tree_util.tree_map(np.asarray, vs.get("batch_stats", {}))
    return inputs, model, params, stats


def _port(level, strategy, sd):
    model = tfu.MultiModalFusionNet(fusion_level=level,
                                    fusion_strategy=strategy,
                                    radiomics_dim=RAD_DIM,
                                    backbone=BACKBONE).eval()
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected
    # without the image branch the JAX tree has no backbone weights
    assert all(k.startswith("image_model.") for k in missing)
    return model


def _logits(model, inputs):
    with torch.no_grad():
        return model(**{k: torch.from_numpy(v) for k, v in inputs.items()}
                     ).numpy()


@pytest.mark.parametrize("level,strategy", COMBOS)
def test_fusion_matches_jax(level, strategy):
    inputs, jmodel, params, stats = _jax_model(level, strategy)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    yj = np.asarray(jmodel.apply(
        variables, **{k: jnp.asarray(v) for k, v in inputs.items()},
        train=False))
    yt = _logits(_port(level, strategy, flax_to_state_dict(params, stats)),
                 inputs)
    assert yt.shape == (4, 7)
    assert np.abs(yj).max() > 1e-2
    np.testing.assert_allclose(yt, yj, rtol=2e-4, atol=2e-4)


def test_convert_reads_jax_checkpoint(tmp_path):
    level, strategy = IMAGE_COMBO
    inputs, jmodel, params, stats = _jax_model(level, strategy)
    path = save_checkpoint(str(tmp_path / "ckpt"),
                           {"params": params, "batch_stats": stats})
    direct = flax_to_state_dict(params, stats)
    from_disk = state_dict_from_checkpoint(path)
    assert from_disk.keys() == direct.keys()
    for k in direct:
        assert torch.equal(from_disk[k], direct[k]), k
    model = tfu.MultiModalFusionNet(fusion_level=level,
                                    fusion_strategy=strategy,
                                    radiomics_dim=RAD_DIM,
                                    backbone=BACKBONE).eval()
    model.load_state_dict(from_disk)  # strict: every weight came across
    yj = np.asarray(jmodel.apply(
        {"params": params, "batch_stats": stats},
        **{k: jnp.asarray(v) for k, v in inputs.items()}, train=False))
    np.testing.assert_allclose(_logits(model, inputs), yj,
                               rtol=2e-4, atol=2e-4)
