"""The port's ConvMAE against the JAX package: a tiny 128-aligned model on
the same weights (JAX params carried over by ``convmae_state_dict``) and the
same images, the encoder at mask ratio 0, the full model at 0.75 on JAX's
masking draws, each kernel flag on, the eval and encoder steps; the weight
converter's exact round trip with the JAX ``port_torch_state_dict``;
``load_pretrained``; masking; the initialisation's distributions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.models import convmae as J
from multimodal_isic_tpu.ops import patches as jpatch
from multimodal_isic_tpu.train import mae as jmae
from multimodal_isic_tpu_torch.models import convmae as T
from multimodal_isic_tpu_torch.models.convert import convmae_state_dict
from multimodal_isic_tpu_torch.ops import patches as tpatch
from multimodal_isic_tpu_torch.train import mae as tmae

# conv-stage dims lane-aligned (C and 4C multiples of 128) so every kernel
# flag applies, as tests/test_fused_mlp.py:110 builds it
CFG = dict(img_size=32, embed_dims=(128, 128, 128), depths=(1, 1, 1),
           num_heads=4, decoder_dim=128, decoder_depth=1, decoder_heads=4,
           norm_pix_loss=True)
FLAGS = [{}, {"use_fused_mlp": True}, {"use_fused_front": True},
         {"use_flash_attention": True}]
# float32: the same arithmetic in another order through ~10 layers (the
# measured gap is ~2e-6 on O(1) latents).  bfloat16: flax and the port round
# to bf16 at the same points, but a different f32 summation order flips some
# of those roundings and the flips carry through the blocks: a few bf16 ulps
# of O(1) values (measured ≤ 0.05 on latents up to ~3).
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=5e-2, atol=0.1)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_params(model, img_size, seed=1):
    """JAX params of ``model`` (numpy leaves) drawn from a seed, no bias or
    LN parameter at its trivial init: kernels N(0, 1/fan_in), scales
    1 + N(0, 0.02²), everything else N(0, 0.02²).  Only the shapes come from
    flax (``eval_shape``: no compile of ``init``)."""
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, jnp.zeros((1, img_size, img_size, 3)),
        mask_ratio=0.0), jax.random.PRNGKey(0))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        z = rng.randn(*leaf.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        return z * np.float32(0.02) + np.float32(name == "scale")
    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=1)
def _jax_params():
    return random_params(J.ConvMAE(**CFG), 32)


def _images(b=2, seed=0):
    return np.random.RandomState(seed).randn(b, 32, 32, 3).astype(np.float32)


def _port(dtype=torch.float32, **flags):
    model = T.ConvMAE(**CFG, dtype=dtype, **flags)
    model.load_state_dict(convmae_state_dict(_jax_params()))
    return model.eval()


def _jax_draws(key, b, n, ratio):
    ids_keep, mask, ids_restore = J.random_masking(key, b, n, ratio)
    return tuple(torch.from_numpy(np.array(a)) for a in
                 (ids_keep, mask, ids_restore))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **tol)


# the plain path in both dtypes and each flag in bf16, where the paths round
# at different points; each flag in float32 is held by the full model below
ENCODER_CASES = [(torch.float32, {})] + [(torch.bfloat16, f) for f in FLAGS]


@pytest.mark.parametrize(
    "dtype,flags", ENCODER_CASES,
    ids=lambda c: (str(c)[6:] if isinstance(c, torch.dtype)
                   else next(iter(c), "plain")))
def test_encoder_at_mask_zero_matches_jax(dtype, flags):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = J.ConvMAE(**CFG, dtype=jdt, **flags)
    imgs = _images()
    lat_j, mask_j, ids_j = jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, 0.0, method=J.ConvMAE.forward_encoder))(
        _jax_params(), jnp.asarray(imgs))
    lat, ids = tmae.make_encoder_step(_port(dtype, **flags))(
        torch.from_numpy(imgs))
    assert lat.dtype == torch.float32 and lat.shape == (2, 4, 128)
    _close(lat, lat_j, TOL[dtype])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: next(iter(f), "plain"))
def test_full_model_at_mask_075_on_jax_draws(flags):
    jm = J.ConvMAE(**CFG, **flags)
    imgs = _images(3, seed=1)
    key = jax.random.PRNGKey(3)
    loss_j, pred_j, mask_j = jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, 0.75, rng=key))(_jax_params(), jnp.asarray(imgs))
    draws = _jax_draws(key, 3, 4, 0.75)
    with torch.no_grad():
        loss, pred, mask = _port(**flags)(torch.from_numpy(imgs), 0.75,
                                          masking=draws)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    _close(pred, pred_j, TOL[torch.float32])
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)


def test_eval_steps_match_jax_and_each_other():
    jm = J.ConvMAE(**CFG)
    imgs = _images(4, seed=2)
    key = jax.random.PRNGKey(5)
    # JAX's scalar step is the mean of its per-sample step at a fixed ratio
    # (every sample masks the same count): one JAX compile serves both
    per_j = jmae.make_mae_eval_persample_step(jm, 0.75)(
        _jax_params(), jnp.asarray(imgs), key)
    loss_j = float(np.mean(np.asarray(per_j, np.float64)))
    model = _port()
    draws = _jax_draws(key, 4, 4, 0.75)
    x = torch.from_numpy(imgs)
    loss = tmae.make_mae_eval_step(model, 0.75)(x, masking=draws)
    per = tmae.make_mae_eval_persample_step(model, 0.75)(x, masking=draws)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    np.testing.assert_allclose(per.numpy(), np.asarray(per_j), rtol=1e-5)
    # a fixed ratio masks the same count in every sample: mean of per-sample
    np.testing.assert_allclose(float(per.mean()), float(loss), rtol=1e-6)
    # drawn masks: the same generator seed gives the same loss
    g = lambda: torch.Generator().manual_seed(11)
    step = tmae.make_mae_eval_step(model, 0.75)
    assert float(step(x, g())) == float(step(x, g()))


def test_converter_round_trips_exactly_with_the_jax_porter():
    params = _jax_params()
    sd = convmae_state_dict(params)
    model = T.ConvMAE(**CFG)
    assert set(sd) == set(model.state_dict())  # every parameter, no other
    model.load_state_dict(sd)  # strict: names and shapes agree
    back, missing = J.port_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, J.ConvMAE(**CFG))
    assert missing == []
    flat_p = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_p) == len(flat_b)
    for path, leaf in flat_p:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)
    # upstream naming
    for key in ("patch_embed1.proj.weight", "blocks1.0.attn.weight",
                "blocks1.0.mlp.fc1.weight", "blocks3.0.attn.qkv.weight",
                "decoder_blocks.0.mlp.fc2.bias", "norm.weight", "mask_token"):
        assert key in sd
    assert sd["pos_embed"].shape == (1, 4, 128)
    assert sd["blocks1.0.attn.weight"].shape == (128, 1, 5, 5)
    assert sd["blocks1.0.mlp.fc1.weight"].shape == (512, 128, 1, 1)


def test_load_pretrained_keeps_init_for_the_missing_and_mismatched():
    sd = convmae_state_dict(_jax_params())
    encoder_only = {k: v for k, v in sd.items()
                    if not k.startswith(("decoder", "mask_token"))}
    encoder_only["pos_embed"] = encoder_only["pos_embed"][0]  # [N, D] too
    encoder_only["blocks2.0.conv1.weight"] = torch.zeros(64, 128, 1, 1)
    encoder_only["stage1_output_decode.weight"] = torch.zeros(3)  # unknown
    model = T.build_convmae(torch.Generator().manual_seed(0), **CFG)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    logs = []
    missing, skipped = T.load_pretrained(model, encoder_only, log=logs.append)
    assert skipped == ["blocks2.0"]
    assert set(missing) == {"decoder_embed", "mask_token", "decoder_blocks.0",
                            "decoder_norm", "decoder_pred"}
    assert logs and "missing" in logs[0]
    for k, v in model.state_dict().items():
        if k.startswith(("decoder", "mask_token", "blocks2.0")):
            assert torch.equal(v, init[k]), k
        else:
            assert torch.equal(v, sd[k]), k


def test_random_masking_draws():
    g = torch.Generator().manual_seed(0)
    ids_keep, mask, ids_restore = T.random_masking(g, 5, 196, 0.75)
    assert ids_keep.shape == (5, 49) and mask.shape == (5, 196)
    np.testing.assert_array_equal(mask.sum(1).numpy(), 147.0)
    # ids_restore inverts the shuffle, and kept patches are the unmasked ones
    kept = torch.zeros(5, 196).scatter_(1, ids_keep, 1.0)
    torch.testing.assert_close(kept, 1.0 - mask)
    # lesion guidance: lesion patches (noise + 1) are masked first
    overlap = torch.zeros(5, 196, dtype=torch.bool)
    overlap[:, :100] = True
    _, mask_l, _ = T.random_masking(g, 5, 196, 0.75, overlap)
    assert bool(mask_l[:, :100].eq(1).all())
    ids, m0, ids_r = T.random_masking(g, 2, 196, 0.0)
    assert torch.equal(ids, ids_r) and float(m0.sum()) == 0.0


def test_patch_ops_and_sincos_match_jax():
    rng = np.random.RandomState(6)
    imgs = rng.randn(2, 64, 48, 3).astype(np.float32)
    p = tpatch.patchify(torch.from_numpy(imgs), 16)
    np.testing.assert_array_equal(p.numpy(),
                                  np.asarray(jpatch.patchify(imgs, 16)))
    sq = rng.randn(2, 16, 768).astype(np.float32)
    np.testing.assert_array_equal(
        tpatch.unpatchify(torch.from_numpy(sq)).numpy(),
        np.asarray(jpatch.unpatchify(jnp.asarray(sq))))
    mask = (rng.rand(2, 64, 48) > 0.995).astype(np.float32)
    np.testing.assert_array_equal(
        tpatch.patch_overlap_mask(torch.from_numpy(mask)).numpy(),
        np.asarray(jpatch.patch_overlap_mask(jnp.asarray(mask))))
    np.testing.assert_allclose(T.sincos_pos_embed(768, 14).numpy(),
                               np.asarray(J.sincos_pos_embed(768, 14)),
                               rtol=1e-6, atol=1e-6)


def test_build_convmae_initialises_like_flax():
    model = T.build_convmae(torch.Generator().manual_seed(0),
                            **{**CFG, "embed_dims": (128, 128, 256)})
    model.requires_grad_(False)
    np.testing.assert_array_equal(
        model.pos_embed[0].numpy(), T.sincos_pos_embed(256, 2).numpy())
    w = model.blocks3[0].mlp.fc1.weight  # lecun_normal, fan_in 256
    assert abs(float(w.std()) * 16 - 1.0) < 0.05
    assert float(w.abs().max()) <= 2 / 16 / 0.8796 + 1e-6  # truncated at 2σ
    assert abs(float(model.mask_token.std()) - 0.02) < 0.004
    assert float(model.blocks1[0].conv1.bias.abs().max()) == 0.0
    assert float(model.norm.weight.min()) == 1.0
    dw = model.blocks1[0].attn.weight  # depthwise fan_in 25
    assert abs(float(dw.std()) * 5 - 1.0) < 0.05


def test_fused_mlp_flag_follows_the_dims():
    """As the JAX config (config.py:92-94): the fused LN-MLP applies only
    where C and 4C are multiples of 128 — decided from the dims."""
    tiny = T.ConvMAE(img_size=32, embed_dims=(32, 48, 64), depths=(1, 1, 1),
                     num_heads=4, with_decoder=False, use_fused_mlp=True)
    assert not any(b.use_fused_mlp for b in (*tiny.blocks1, *tiny.blocks2))
    with torch.device("meta"):
        base = T.convmae_convvit_base_patch16_dec512d8b(with_decoder=False)
    assert all(b.use_fused_mlp for b in (*base.blocks1, *base.blocks2))
    assert not hasattr(base, "decoder_pred")
    assert len(base.blocks3) == 11 and base.embed_dims == (256, 384, 768)
