"""ConvMAE training's pieces below the model, port against the JAX package:
the fused LN-MLP backward's plain version against ``jax.vjp`` of the Pallas
kernel (interpret mode, its hand-written backward), the attention and
fused-front Functions' gradients against ``jax.vjp`` of the JAX kernels, the
MAE train policy on JAX's own draws and its draw in distribution,
``weighted_sample_indices`` bit for bit, and the MBConv wrappers' refusal to
run under autograd.

On the CPU every wrapper runs its plain version; the kernels are held
against these plain versions on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.core import splits as jsplits
from multimodal_isic_tpu.data import augment as jaug
from multimodal_isic_tpu.ops import attention as jattn
from multimodal_isic_tpu.ops import fused_convblock as jfront
from multimodal_isic_tpu.ops import fused_mlp as jmlp
from multimodal_isic_tpu_torch.core import splits as tsplits
from multimodal_isic_tpu_torch.data import augment as taug
from multimodal_isic_tpu_torch.ops import attention as tattn
from multimodal_isic_tpu_torch.ops import fused_convblock as tfront
from multimodal_isic_tpu_torch.ops import fused_dwconv as tfd
from multimodal_isic_tpu_torch.ops import fused_mlp as tmlp

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# Backward, port plain version vs the Pallas backward in interpret mode.
# float32: the same arithmetic in another summation order (as
# tests/test_fused_mlp.py:103 holds the JAX kernel to its XLA twin).
# bfloat16: dh is rounded to bf16 at the same point, but an f32 sum in
# another order (or the JAX kernel's A&S erf) can flip that rounding, and
# the weight gradients come back rounded to bf16: each gradient's worst
# error is held to 1% of its largest magnitude (about two bf16 ulps there)
# and its relative Frobenius error to 1e-3.
F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = {"of_max": 1e-2, "rel_fro": 1e-3}
GRAD_NAMES = ("dx", "dls", "dlb", "dw1", "db1", "dw2", "db2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a, dtype):
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype[0])
    return t, jnp.asarray(a, jnp.float32).astype(dtype[1])


def _close(name, got, want, dt):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    if dt == "float32":
        np.testing.assert_allclose(got, want, err_msg=name, **F32_TOL)
        return
    err = np.abs(got - want)
    scale = float(np.abs(want).max())
    assert err.max() <= BF16_TOL["of_max"] * scale, (name, err.max(), scale)
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert rel <= BF16_TOL["rel_fro"], (name, rel)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [128, 256])
def test_fused_ln_mlp_backward_matches_pallas_backward(dt, c):
    rng = np.random.RandomState(c)
    m, f = 300, 4 * c  # 300 rows: not a multiple of the row block
    arrays = [rng.randn(m, c) * 2 + 0.5, 1 + 0.1 * rng.randn(c),
              0.1 * rng.randn(c), rng.randn(c, f) / np.sqrt(c),
              0.1 * rng.randn(f), rng.randn(f, c) / np.sqrt(f),
              0.1 * rng.randn(c)]
    # LN scale/shift stay float32, as the model hands them over
    t, j = zip(*[_pair(a, DTYPES[dt] if i not in (1, 2) else DTYPES["float32"])
                 for i, a in enumerate(arrays)])
    tg, jg = _pair(rng.randn(m, c), DTYPES[dt])
    _, vjp = jax.vjp(lambda *a: jmlp.fused_ln_mlp(*a, interpret=True), *j)
    want = vjp(jg)
    before = tmlp.fused_ln_mlp_backward.launches
    got = tmlp.fused_ln_mlp_backward(t[0], tg, *t[1:])
    assert tmlp.fused_ln_mlp_backward.launches == before  # CPU: no kernel
    for name, a, w, inp in zip(GRAD_NAMES, got, want, t):
        assert a.dtype == inp.dtype, name  # each input's dtype
        _close(name, a, w, dt)
    # the Function's backward is that plain version, not autograd through
    # the plain forward
    leaves = [x.clone().requires_grad_() for x in t]
    out = tmlp.fused_ln_mlp(*leaves)
    via = torch.autograd.grad(out, leaves, tg)
    for name, a, b in zip(GRAD_NAMES, via, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_fused_ln_mlp_backward_reference_rounds_where_the_kernel_does():
    """In float32, where no rounding point changes a value, the plain
    backward equals autograd through the plain forward."""
    rng = np.random.RandomState(9)
    m, c, f = 40, 32, 128
    arrays = [rng.randn(m, c), 1 + 0.1 * rng.randn(c), 0.1 * rng.randn(c),
              rng.randn(c, f) / np.sqrt(c), 0.1 * rng.randn(f),
              rng.randn(f, c) / np.sqrt(f), 0.1 * rng.randn(c)]
    t = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
         for a in arrays]
    g = torch.tensor(rng.randn(m, c), dtype=torch.float32)
    auto = torch.autograd.grad(tmlp.fused_ln_mlp_reference(*t), t, g)
    plain = tmlp.fused_ln_mlp_backward_reference(t[0], g, *t[1:])
    for name, a, b in zip(GRAD_NAMES, plain, auto):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("n,d", [(49, 64), (196, 32)])
def test_attention_gradients_match_jax(n, d):
    rng = np.random.RandomState(n + d)
    q, k, v, g = (rng.randn(2, 3, n, d).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(lambda *a: jattn.flash_attention(*a, interpret=True),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(tattn.flash_attention(*leaves), leaves,
                              torch.from_numpy(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_attention_gradients_reach_the_qkv_views():
    """bf16 q, k, v as the model passes them, strided views of one
    [B, N, 3, H, D] projection: the gradient lands on the projection in its
    layout, equal to autograd through the plain version."""
    rng = np.random.RandomState(3)
    base = torch.tensor(rng.randn(2, 49, 3, 4, 32), dtype=torch.bfloat16)
    g = torch.tensor(rng.randn(2, 4, 49, 32), dtype=torch.bfloat16)
    grads = []
    for fn in (tattn.flash_attention, tattn.flash_attention_reference):
        qkv = base.clone().requires_grad_()
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        fn(q, k, v).backward(g)
        grads.append(qkv.grad)
    assert grads[0].shape == base.shape and grads[0].dtype == torch.bfloat16
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


@pytest.mark.parametrize("with_keep", [False, True])
def test_fused_front_gradients_match_jax(with_keep):
    rng = np.random.RandomState(5)
    c = 128
    arrays = [rng.randn(2, 8, 12, c) * 2 + 0.5, 1 + 0.1 * rng.randn(c),
              0.1 * rng.randn(c), rng.randn(c, c) / np.sqrt(c),
              0.1 * rng.randn(c), rng.randn(5, 5, c) / 5, 0.1 * rng.randn(c),
              rng.randn(c, c) / np.sqrt(c), 0.1 * rng.randn(c)]
    arrays = [np.asarray(a, np.float32) for a in arrays]
    keep = ((rng.rand(2, 8, 12, 1) > 0.6).astype(np.float32)
            if with_keep else None)
    g = rng.randn(2, 8, 12, c).astype(np.float32)
    jk = None if keep is None else jnp.asarray(keep)
    _, vjp = jax.vjp(lambda *a: jfront.fused_front(*a, jk, interpret=True),
                     *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tk = None if keep is None else torch.from_numpy(keep)
    got = torch.autograd.grad(tfront.fused_front(*leaves, keep=tk), leaves,
                              torch.from_numpy(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


def _jax_mae_draws(key, bsz, hw):
    """The draws ``jaug.mae_train_batch`` makes from ``key``, replayed with
    its own jax.random calls (``augment.py:286-309,138-142,447-454``)."""
    h, w = hw
    out = {k: [] for k in ("y0", "x0", "crop_h", "crop_w", "hflip", "vflip",
                           "rot_k")}
    for k in jax.random.split(key, bsz):
        k1, k2 = jax.random.split(k)
        k_area, k_ratio, k_i, k_j, _ = jax.random.split(k1, 5)
        area = jax.random.uniform(k_area, (10,), minval=0.5,
                                  maxval=1.0) * float(h * w)
        ar = jnp.exp(jax.random.uniform(k_ratio, (10,), minval=jnp.log(0.75),
                                        maxval=jnp.log(4.0 / 3.0)))
        ws, hs = jnp.round(jnp.sqrt(area * ar)), jnp.round(jnp.sqrt(area / ar))
        valid = (ws > 0) & (ws <= w) & (hs > 0) & (hs <= h)
        idx, found = jnp.argmax(valid), jnp.any(valid)
        cw = jnp.where(found, ws[idx], float(min(h, w)))
        ch = jnp.where(found, hs[idx], float(min(h, w)))
        ri = jax.random.randint(k_i, (), 0, jnp.maximum(
            (h - ch).astype(jnp.int32), 0) + 1)
        rj = jax.random.randint(k_j, (), 0, jnp.maximum(
            (w - cw).astype(jnp.int32), 0) + 1)
        out["y0"].append(float(jnp.where(found, ri, (h - ch) // 2)))
        out["x0"].append(float(jnp.where(found, rj, (w - cw) // 2)))
        out["crop_h"].append(float(ch))
        out["crop_w"].append(float(cw))
        kh, kv, kr, krk = jax.random.split(k2, 4)
        out["hflip"].append(bool(jax.random.uniform(kh) < 0.5))
        out["vflip"].append(bool(jax.random.uniform(kv) < 0.5))
        rot = jax.random.uniform(kr) < 0.5
        out["rot_k"].append(int(jnp.where(rot, jax.random.randint(
            krk, (), 0, 4), 0)))
    crop = {k: torch.tensor(out[k], dtype=torch.float32)
            for k in ("y0", "x0", "crop_h", "crop_w")}
    flips = {"hflip": torch.tensor(out["hflip"]),
             "vflip": torch.tensor(out["vflip"]),
             "rot_k": torch.tensor(out["rot_k"])}
    return {"crop": crop, "flips": flips}


def test_mae_train_transform_matches_jax_on_its_draws():
    rng = np.random.RandomState(11)
    imgs = rng.randint(0, 256, (4, 45, 60, 3)).astype(np.uint8)
    masks = (rng.rand(4, 45, 60) > 0.5).astype(np.uint8) * 255
    key = jax.random.PRNGKey(2)
    ji, jm = jax.jit(lambda i, m, k: jaug.mae_train_batch(i, m, k))(
        jnp.asarray(imgs), jnp.asarray(masks), key)
    draws = _jax_mae_draws(key, 4, (45, 60))
    ti, tm = taug.mae_train_transform(torch.from_numpy(imgs),
                                      torch.from_numpy(masks), draws)
    assert ti.shape == (4, 224, 224, 3) and tm.shape == (4, 224, 224)
    # the same f32 weights; the two contractions (up to 450 terms each of
    # 0..255 values) run in another order than JAX's einsum: ~1e-5 of 255,
    # i.e. ~5e-5 after the ImageNet normalisation's division by ~58
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert taug.POLICIES["mae_train"] is taug.mae_train_batch


def test_random_resized_crop_draw_in_distribution():
    g = torch.Generator().manual_seed(0)
    d = taug.random_resized_crop_draw(g, 4000, (450, 450))
    ch, cw, y0, x0 = d["crop_h"], d["crop_w"], d["y0"], d["x0"]
    frac = ch * cw / 450.0 ** 2
    # area fraction in [0.5, 1] up to the rounding of the sides, aspect in
    # [3/4, 4/3] likewise; offsets integers inside the image
    assert float(frac.min()) > 0.49 and float(frac.max()) <= 1.0
    # the mean fraction of the same rule in numpy (attempts that do not fit
    # are rejected, so it is below 0.75); standard error of 4000 draws ~0.002
    r = np.random.RandomState(0)
    area = r.uniform(0.5, 1.0, (20000, 10)) * 450.0 ** 2
    asp = np.exp(r.uniform(np.log(0.75), np.log(4 / 3), (20000, 10)))
    w_, h_ = np.round(np.sqrt(area * asp)), np.round(np.sqrt(area / asp))
    ok = (w_ <= 450) & (h_ <= 450)
    first = ok.argmax(1)[:, None]
    want = np.take_along_axis(w_ * h_, first, 1)[:, 0] / 450.0 ** 2
    assert abs(float(frac.mean()) - want.mean()) < 0.01
    ar = cw / ch
    assert float(ar.min()) > 0.74 and float(ar.max()) < 1.35
    for off, size in ((y0, ch), (x0, cw)):
        assert torch.equal(off, off.floor())
        assert float(off.min()) >= 0 and bool((off + size <= 450).all())
    # offsets spread over their whole range
    u = y0 / (450 - ch).clamp_min(1)
    assert abs(float(u[ch < 440].mean()) - 0.5) < 0.03
    # no attempt fits an 8 x 400 image: the centred 8 x 8 square
    d = taug.random_resized_crop_draw(g, 16, (8, 400))
    assert bool((d["crop_h"] == 8).all() and (d["crop_w"] == 8).all())
    assert bool((d["y0"] == 0).all() and (d["x0"] == 196).all())


@pytest.mark.parametrize("seed,n", [(0, None), (7, 500)])
def test_weighted_sample_indices_bit_equal(seed, n):
    labels = np.random.RandomState(1).choice(7, 300, p=[.5, .2, .1, .1, .05,
                                                        .03, .02])
    want = jsplits.weighted_sample_indices(labels, n,
                                           np.random.RandomState(seed))
    got = tsplits.weighted_sample_indices(labels, n,
                                          np.random.RandomState(seed))
    np.testing.assert_array_equal(got, want)


def test_mbconv_wrappers_refuse_autograd():
    """The MBConv kernels have no backward (the JAX kernels no VJP): under
    grad with an input that requires it, the wrappers raise; under
    no_grad, or with nothing requiring grad, they run."""
    x = torch.randn(1, 6, 6, 8, requires_grad=True)
    wd, bd = torch.randn(3, 3, 1, 8), torch.randn(8)
    we, be = torch.randn(8, 16), torch.randn(16)
    wd2, bd2 = torch.randn(3, 3, 1, 16), torch.randn(16)
    with pytest.raises(RuntimeError, match="no backward"):
        tfd.dw_silu_pool(x, wd, bd)
    with pytest.raises(RuntimeError, match="no backward"):
        tfd.expand_dw_silu_pool(x.detach(), we.requires_grad_(), be, wd2, bd2)
    with torch.no_grad():
        y, _ = tfd.expand_dw_silu_pool(x, we, be, wd2, bd2)
    assert not y.requires_grad
    y, _ = tfd.dw_silu_pool(x.detach(), wd, bd)
    assert not y.requires_grad


# ------------------------------------------ the backward kernels' host side

@pytest.mark.parametrize("m,c,f,plan", [
    (50176, 256, 1024, (264, 8, 6272)),     # stage 1, bs 16
    (12544, 384, 1536, (264, 3, 4192)),     # stage 2, bs 16
    (200704, 256, 1024, (264, 8, 25088)),   # stage 1, bs 64
    (50176, 384, 1536, (264, 3, 16736)),    # stage 2, bs 64
    (1000, 256, 1024, (125, 8, 128)),       # the ragged edge
    (77, 256, 96, (10, 3, 32))])
def test_ln_mlp_bwd_plan_at_the_path_geometries(m, c, f, plan):
    """The weight GEMMs' [F/128 × C/128 × 2] tiles times their row splits
    stay at most 264 blocks (two an SM): 32 × 8 at stage 1, 72 × 3 at stage
    2; the LayerNorm backward runs a persistent grid of at most 264."""
    p = tmlp.ln_mlp_bwd_plan(m, c, f)
    assert (p["norm_blocks"], p["nsplit"], p["rows_per"]) == plan


def test_ln_mlp_bwd_plan_splits_cover_the_rows():
    for c, f in ((256, 1024), (384, 1536), (256, 96)):
        tiles = 2 * -(-f // 128) * -(-c // 128)
        for m in list(range(1, 600)) + [12543, 12544, 50175, 50177, 200704]:
            p = tmlp.ln_mlp_bwd_plan(m, c, f)
            n, per = p["nsplit"], p["rows_per"]
            assert per % 32 == 0
            assert n * per >= m > (n - 1) * per  # every row, no empty split
            assert n * tiles <= max(264, tiles)
            assert 1 <= p["norm_blocks"] <= 264


def test_ln_mlp_bwd_workspace_bytes():
    """y [M, C], round(a) and round(dh) [M, F] in the dtype; dy [M, C] and
    the row statistics in float32; the two partial buffers; 256-byte
    segments.  At stage 1 bs 16 f32 the [M, F] pair is 411 MB of the 532."""
    m, c, f = 50176, 256, 1024
    sizes = [m * c * 4, m * f * 4, m * f * 4, m * c * 4, m * 8,
             264 * 3 * c * 4, 8 * (2 * f * c + f) * 4]
    offs, total = tmlp.ln_mlp_bwd_workspace(m, c, f, torch.float32)
    assert total == sum(sizes)
    assert offs == list(np.cumsum([0] + sizes[:-1]))
    assert 2 * m * f * 4 == 411041792
    # in bf16, y, round(a) and round(dh) take half the bytes
    assert tmlp.ln_mlp_bwd_workspace(m, c, f, torch.bfloat16)[1] == \
        total - (m * c * 2 + 2 * m * f * 2)
    # odd sizes: every segment starts 256-byte aligned, past the one before
    offs, total = tmlp.ln_mlp_bwd_workspace(77, 256, 96, torch.bfloat16)
    ends = offs[1:] + [total]
    assert all(o % 256 == 0 for o in offs + [total])
    assert ends[:3] == [o + 256 * -(-77 * n * 2 // 256)
                        for o, n in zip(offs, (256, 96, 96))]


def test_ln_mlp_kernel_shape_checks():
    for c in tmlp.CHANNELS:
        tmlp.check_ln_mlp_kernel_shape(c, 4 * c)
    tmlp.check_ln_mlp_kernel_shape(256, 96)
    with pytest.raises(ValueError, match="C in"):
        tmlp.check_ln_mlp_kernel_shape(192, 768)
    with pytest.raises(ValueError, match="multiple of"):
        tmlp.check_ln_mlp_kernel_shape(256, 100)
