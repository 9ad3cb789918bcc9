"""Port parity for the fusion train-time augmentations
(``multimodal_isic_tpu_torch/data/augment.py``).

``jax.random`` and ``torch.Generator`` give different numbers, so every
apply function is fed the JAX package's own draws, rebuilt here with its
key splits (``augment.py:138-142, 227-233, 376-382, 419-422, 526-528``), and
must give the JAX result.  The draw functions are checked in distribution.

Colour jitter's hue has exact-equality branches (``r == maxc``) that can
flip on isolated pixels under float-rounding differences, so whole-policy
and jitter comparisons use the quantile-plus-max assertion of
``tests/test_pallas_warp.py:105-107``."""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.data import augment as jaug
from multimodal_isic_tpu_torch.data import augment as taug
from multimodal_isic_tpu_torch.ops import color_jitter as cj

NORM_Q, NORM_MAX = 0.05, 2.0        # on the normalized scale (test_pallas_warp)
PIX_Q, PIX_MAX = 1e-2, 2.0 * 255 * 0.225  # the same on the 0..255 scale



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs (a B0
    step here ran 10x slower oversubscribed than on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _close_q(got, want, q_tol, max_tol):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.quantile(diff, 0.999) < q_tol, np.quantile(diff, 0.999)
    assert diff.max() < max_tol, diff.max()


# ---------------------------------------------- JAX draws, rebuilt per image

def _flip_draws(keys):
    def one(k):
        k_h, k_v, k_r, k_rk = jax.random.split(k, 4)
        rot = jnp.where(jax.random.uniform(k_r) < 0.5,
                        jax.random.randint(k_rk, (), 0, 4), 0)
        return (jax.random.uniform(k_h) < 0.5, jax.random.uniform(k_v) < 0.5,
                rot)
    h, v, r = jax.vmap(one)(keys)
    return {"hflip": _t(h), "vflip": _t(v), "rot_k": _t(r, torch.long)}


def _ssr_draws(keys):
    a, dx, dy, sc, an = jax.vmap(lambda k: jaug._ssr_draw(
        k, 0.05, 0.1, 15.0, 0.5))(keys)
    return {"apply": _t(a), "dx": _t(dx), "dy": _t(dy), "scale": _t(sc),
            "angle": _t(an)}


def _jitter_draws(keys):
    def one(k):
        k_apply, k_perm, k_b, k_c, k_s, k_h = jax.random.split(k, 6)
        u = lambda kk, lo, hi: jax.random.uniform(kk, minval=lo, maxval=hi)
        return (jax.random.uniform(k_apply) < 0.5, u(k_b, 0.8, 1.2),
                u(k_c, 0.8, 1.2), u(k_s, 0.8, 1.2), u(k_h, -0.1, 0.1),
                jax.random.permutation(k_perm, 4))
    a, fb, fc, fs, fh, perm = jax.vmap(one)(keys)
    return {"apply": _t(a), "brightness": _t(fb), "contrast": _t(fc),
            "saturation": _t(fs), "hue": _t(fh), "perm": _t(perm, torch.long)}


def _noise_draws(keys, shape):
    def one(k):
        k_apply, k_var, k_noise = jax.random.split(k, 3)
        return (jax.random.uniform(k_apply) < 0.3,
                jax.random.uniform(k_var, minval=10.0, maxval=50.0),
                jax.random.normal(k_noise, shape, jnp.float32))
    a, var, noise = jax.vmap(one)(keys)
    return {"apply": _t(a), "var": _t(var), "noise": _t(noise)}


def _policy_draws(key, bsz, out_hw):
    """The draws of both fusion train policies for ``key``: one key per
    image, split in four (flips, SSR, jitter, noise)."""
    sub = jax.vmap(lambda k: jax.random.split(k, 4))(jax.random.split(key, bsz))
    return {"flips": _flip_draws(sub[:, 0]), "ssr": _ssr_draws(sub[:, 1]),
            "jitter": _jitter_draws(sub[:, 2]),
            "noise": _noise_draws(sub[:, 3], (*out_hw, 3))}


def _batch(seed, n, hw):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, *hw, 3)).astype(np.uint8)
    masks = (rng.randint(0, 2, (n, *hw)) * 255).astype(np.uint8)
    return imgs, masks


# ------------------------------------------------- each augmentation alone

def test_flips_rot90_match_jax():
    keys = jax.random.split(jax.random.PRNGKey(0), 24)
    draws = _flip_draws(keys)
    assert set(draws["rot_k"].tolist()) == {0, 1, 2, 3}
    assert 0 < int(draws["hflip"].sum()) < 24
    imgs, masks = _batch(1, 24, (9, 9))
    imgs = imgs.astype(np.float32)
    want = jax.vmap(lambda i, m, k: jaug.random_flips_rot90(i, m, k))(
        jnp.asarray(imgs), jnp.asarray(masks), keys)
    got = taug.random_flips_rot90(_t(imgs), _t(masks), draws)
    assert got[0].is_contiguous() and got[1].is_contiguous()  # warp input
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("hw", [(48, 48), (37, 53)])
def test_shift_scale_rotate_matches_jax(hw):
    keys = jax.random.split(jax.random.PRNGKey(1), 12)
    draws = _ssr_draws(keys)
    assert 0 < int(draws["apply"].sum()) < 12
    imgs, masks = _batch(2, 12, hw)
    imgs, masks = imgs.astype(np.float32), masks.astype(np.float32)
    want_i, want_m = jax.vmap(jaug.shift_scale_rotate)(
        jnp.asarray(imgs), jnp.asarray(masks), keys)
    got_i, got_m = taug.shift_scale_rotate(_t(imgs), _t(masks), draws)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=2e-2,
                               rtol=0)
    # nearest: a coordinate within rounding of .5 may pick the other pixel
    assert np.mean(got_m.numpy() != np.asarray(want_m)) < 1e-3


def _keys_for_every_permutation():
    """24 keys whose jitter draw applies, one per permutation order."""
    keys = jax.random.split(jax.random.PRNGKey(2), 4000)
    draws = _jitter_draws(keys)
    found = {}
    for i, (a, p) in enumerate(zip(draws["apply"].tolist(),
                                   draws["perm"].tolist())):
        if a:
            found.setdefault(tuple(p), i)
    assert len(found) == 24
    return keys[np.asarray([found[p] for p in
                            itertools.permutations(range(4))])]


def test_color_jitter_every_order_matches_jax():
    keys = _keys_for_every_permutation()
    draws = _jitter_draws(keys)
    imgs = _batch(3, 24, (16, 16))[0].astype(np.float32)
    want = jax.vmap(jaug.color_jitter)(jnp.asarray(imgs), keys)
    got = taug.color_jitter(_t(imgs), draws)
    _close_q(got.numpy(), want, PIX_Q, PIX_MAX)
    # the orders matter: a fixed order differs from JAX's random one
    fixed = dict(draws, perm=torch.arange(4).repeat(24, 1))
    assert np.abs(taug.color_jitter(_t(imgs), fixed).numpy()
                  - np.asarray(want)).max() > 1.0


def test_color_jitter_not_applied_passes_through():
    keys = jax.random.split(jax.random.PRNGKey(4), 16)
    draws = _jitter_draws(keys)
    imgs = _batch(4, 16, (8, 8))[0].astype(np.float32)
    got = taug.color_jitter(_t(imgs), draws).numpy()
    off = ~draws["apply"].numpy()
    assert off.any()
    np.testing.assert_array_equal(got[off], imgs[off])


def test_hsv_roundtrip_matches_jax():
    rgb = np.random.RandomState(5).rand(500, 3).astype(np.float32)
    rgb[:50] = rgb[:50, :1]  # grey pixels: delta 0
    hsv_t = taug._rgb_to_hsv(_t(rgb))
    np.testing.assert_allclose(hsv_t.numpy(),
                               np.asarray(jaug._rgb_to_hsv(jnp.asarray(rgb))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        taug._hsv_to_rgb(hsv_t).numpy(),
        np.asarray(jaug._hsv_to_rgb(jnp.asarray(hsv_t.numpy()))),
        atol=1e-6, rtol=0)


def _cpu_jitter_args(bsz, seed=12):
    g = torch.Generator().manual_seed(seed)
    return taug.color_jitter_draw(g, bsz)


@pytest.mark.parametrize("hw", [(16, 16), (37, 45)])
def test_color_jitter_wrapper_on_the_cpu_is_the_plain_version(hw):
    """On a CPU tensor the wrapper (and ``data.augment.color_jitter``)
    returns the plain version's result bit for bit and launches nothing."""
    d = _cpu_jitter_args(12)
    assert 0 < int(d["apply"].sum()) < 12
    imgs = torch.from_numpy(_batch(12, 12, hw)[0]).float()
    before = cj.color_jitter_batch.launches
    got = cj.color_jitter_batch(imgs, d["apply"], d["brightness"],
                                d["contrast"], d["saturation"], d["hue"],
                                d["perm"])
    want = cj.color_jitter_reference(imgs, d)
    assert torch.equal(got, want)
    assert torch.equal(taug.color_jitter(imgs, d), want)
    assert cj.color_jitter_batch.launches == before


JITTER_BAD = {
    "imgs dtype": lambda i, d: (i.double(), d),
    "imgs channels": lambda i, d: (torch.zeros(*i.shape[:3], 4), d),
    "imgs rank": lambda i, d: (i[0], d),
    "apply dtype": lambda i, d: (i, {**d, "apply": d["apply"].int()}),
    "apply shape": lambda i, d: (i, {**d, "apply": d["apply"][:-1]}),
    "factor dtype": lambda i, d: (i, {**d, "hue": d["hue"].double()}),
    "factor shape": lambda i, d: (i, {**d, "contrast": d["contrast"][:, None]}),
    "perm dtype": lambda i, d: (i, {**d, "perm": d["perm"].int()}),
    "perm shape": lambda i, d: (i, {**d, "perm": d["perm"][:, :3]}),
    "device": lambda i, d: (i, {**d, "saturation": d["saturation"].to("meta")}),
}


@pytest.mark.parametrize("bad", sorted(JITTER_BAD))
def test_color_jitter_wrapper_checks_its_arguments(bad):
    """The wrapper's checks of dtype, shape and device raise on the CPU as
    on the card."""
    imgs = torch.from_numpy(_batch(13, 4, (8, 8))[0]).float()
    imgs, d = JITTER_BAD[bad](imgs, _cpu_jitter_args(4))
    with pytest.raises(ValueError):
        cj.color_jitter_batch(imgs, d["apply"], d["brightness"],
                              d["contrast"], d["saturation"], d["hue"],
                              d["perm"])


def test_gauss_noise_matches_jax():
    keys = jax.random.split(jax.random.PRNGKey(6), 16)
    imgs = _batch(6, 16, (10, 10))[0].astype(np.float32)
    draws = _noise_draws(keys, (10, 10, 3))
    assert 0 < int(draws["apply"].sum()) < 16
    want = jax.vmap(jaug.gauss_noise)(jnp.asarray(imgs), keys)
    got = taug.gauss_noise(_t(imgs), draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_resize_nearest_matches_jax():
    masks = _batch(7, 2, (45, 61))[1]
    want = jax.vmap(lambda m: jaug.resize_nearest(m, (38, 29)))(
        jnp.asarray(masks))
    got = taug.resize_nearest(_t(masks), (38, 29))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ the policies

def test_fast_policy_matches_jax_fast():
    """The port's fast policy (its warp wrapper, plain on the CPU) against
    the JAX fast policy (Pallas warp in f32, interpret mode) for one key,
    at a size inside the JAX pad budget."""
    key = jax.random.PRNGKey(7)
    imgs, masks = _batch(8, 4, (240, 240))
    out_hw = (176, 176)
    draws = _policy_draws(key, 4, out_hw)
    assert draws["ssr"]["apply"].any()
    fast = jaug.make_fusion_train_fast(out_hw, warp_dtype=jnp.float32,
                                       interpret=True)
    want_i, want_m = fast(jnp.asarray(imgs), jnp.asarray(masks), key)
    got_i, got_m = taug.fusion_train_fast_transform(_t(imgs), _t(masks),
                                                    draws, out_hw)
    assert got_i.shape == (4, *out_hw, 3) and got_i.dtype == torch.float32
    _close_q(got_i.numpy(), want_i, NORM_Q, NORM_MAX)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("policy", ["faithful", "fast"])
def test_policy_matches_jax_faithful(policy):
    """Both port policies against the JAX faithful policy at 48²: the
    faithful one also on its masks; the fast one, whose warp reflects in
    place, at a size where the JAX fast policy's pad budget fails."""
    key = jax.random.PRNGKey(8)
    imgs, masks = _batch(9, 6, (60, 60))
    out_hw = (48, 48)
    draws = _policy_draws(key, 6, out_hw)
    assert draws["ssr"]["apply"].any()
    # jaug.fusion_train_batch at out_hw (its jit fixes 380²)
    faithful = jax.vmap(functools.partial(jaug.fusion_train_transform,
                                          out_hw=out_hw))
    want_i, want_m = faithful(jnp.asarray(imgs, jnp.float32),
                              jnp.asarray(masks, jnp.float32),
                              jax.random.split(key, 6))
    fn = (taug.fusion_train_transform if policy == "faithful"
          else taug.fusion_train_fast_transform)
    got_i, got_m = fn(_t(imgs), _t(masks), draws, out_hw)
    _close_q(got_i.numpy(), want_i, NORM_Q, NORM_MAX)
    if policy == "faithful":
        assert got_m.dtype == torch.float32
        assert np.mean(got_m.numpy() != np.asarray(want_m)) < 1e-3


def test_policies_take_draws_from_a_generator():
    imgs, masks = _batch(10, 3, (40, 40))
    out = {}
    for name in ("fusion_train", "fusion_train_fast"):
        g = torch.Generator().manual_seed(0)
        out[name] = taug.POLICIES[name](_t(imgs), _t(masks), g)[0]
    assert out["fusion_train"].shape == (3, 380, 380, 3)
    # the same generator seed gives the same draws: the two policies agree
    _close_q(out["fusion_train"].numpy(), out["fusion_train_fast"].numpy(),
             NORM_Q, NORM_MAX)
    ev = taug.POLICIES["fusion_eval"](_t(imgs), _t(masks))
    assert ev[0].shape == (3, 380, 380, 3) and ev[1].shape == (3, 380, 380)


# ------------------------------------------------------ draws in distribution

def test_draws_in_distribution():
    g = torch.Generator().manual_seed(11)
    n = 20000
    flips = taug.flips_rot90_draw(g, n)
    ssr = taug.ssr_draw(g, n)
    jit = taug.color_jitter_draw(g, n)
    noise = taug.gauss_noise_draw(g, (n, 2, 2, 3))
    tol = 4 * np.sqrt(0.25 / n)
    for rate, flag in ((0.5, flips["hflip"]), (0.5, flips["vflip"]),
                       (0.5, ssr["apply"]), (0.5, jit["apply"]),
                       (0.3, noise["apply"])):
        assert abs(float(flag.float().mean()) - rate) < tol
    # rot_k: 0 with p 0.5 + 0.5/4, else uniform over 1..3
    counts = torch.bincount(flips["rot_k"], minlength=4).numpy() / n
    np.testing.assert_allclose(counts, [0.625, 0.125, 0.125, 0.125], atol=0.02)
    for key, lo, hi in (("dx", -0.05, 0.05), ("dy", -0.05, 0.05),
                        ("scale", 0.9, 1.1), ("angle", -15, 15)):
        v = ssr[key].numpy()
        assert v.min() >= lo and v.max() <= hi
        assert v.min() < lo + (hi - lo) * 0.01 and v.max() > hi - (hi - lo) * 0.01
    for key, lo, hi in (("brightness", 0.8, 1.2), ("contrast", 0.8, 1.2),
                        ("saturation", 0.8, 1.2), ("hue", -0.1, 0.1)):
        v = jit[key].numpy()
        assert v.min() >= lo and v.max() <= hi
    v = noise["var"].numpy()
    assert v.min() >= 10 and v.max() <= 50
    assert abs(float(noise["noise"].std()) - 1.0) < 0.02
    # every permutation of the four adjustments, uniformly
    perms = jit["perm"]
    assert all(sorted(p) == [0, 1, 2, 3] for p in perms[:100].tolist())
    codes = (perms * torch.tensor([64, 16, 4, 1])).sum(1)
    freq = torch.bincount(codes, minlength=256).numpy()
    freq = freq[freq > 0] / n
    assert len(freq) == 24
    np.testing.assert_allclose(freq, 1 / 24, atol=0.006)
