"""The plain versions of the port's three ConvMAE kernels (fused LN-MLP,
attention, fused ConvBlock front) against the JAX package's Pallas kernels
in interpret mode and their XLA references, on the same inputs (numpy, one
seed), in float32 and bfloat16.

On the CPU each wrapper runs its plain version and counts no launch; the
kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.ops import attention as jattn
from multimodal_isic_tpu.ops import fused_convblock as jfront
from multimodal_isic_tpu.ops import fused_mlp as jmlp
from multimodal_isic_tpu_torch.ops import attention as tattn
from multimodal_isic_tpu_torch.ops import fused_convblock as tfront
from multimodal_isic_tpu_torch.ops import fused_mlp as tmlp

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# |port − JAX| <= atol + rtol·|JAX|.  float32: the same arithmetic in another
# summation order.  bfloat16: the intermediates are rounded to bf16 at the
# same points, but an f32 sum in another order (or the JAX kernel's A&S erf
# against the exact erf) can flip one of those roundings, 2^-8 relative,
# which the following products carry on: allow ~2 bf16 ulps of the O(1)
# outputs.
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a, dtype):
    """The same values as a torch tensor and a jax array in ``dtype``."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype[0])
    return t, jnp.asarray(a, jnp.float32).astype(dtype[1])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _mlp_arrays(rng, m, c, f):
    return (rng.randn(m, c) * 2 + 0.5, 1 + 0.1 * rng.randn(c),
            0.1 * rng.randn(c), rng.randn(c, f) / np.sqrt(c),
            0.1 * rng.randn(f), rng.randn(f, c) / np.sqrt(f),
            0.1 * rng.randn(c))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_ln_mlp_plain_matches_pallas_and_xla(dt):
    rng = np.random.RandomState(0)
    arrays = _mlp_arrays(rng, 300, 128, 512)  # 300: not a row-block multiple
    # LN scale/shift stay float32, as the model hands them over
    t, j = zip(*[_pair(a, DTYPES[dt] if i not in (1, 2) else DTYPES["float32"])
                 for i, a in enumerate(arrays)])
    before = tmlp.fused_ln_mlp.launches
    got = tmlp.fused_ln_mlp(*t)
    assert tmlp.fused_ln_mlp.launches == before  # the CPU runs no kernel
    assert got.dtype == DTYPES[dt][0] and got.shape == (300, 128)
    _close(got, jmlp.fused_ln_mlp(*j, interpret=True), TOL[dt])
    _close(got, jax.jit(jmlp._reference_ln_mlp)(*j), TOL[dt])
    torch.testing.assert_close(got, tmlp.fused_ln_mlp_reference(*t))


@pytest.mark.parametrize("n,d", [(196, 64), (49, 64), (196, 32), (49, 32)])
def test_attention_plain_matches_pallas_and_xla(n, d):
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(2, 3, n, d).astype(np.float32) * 1.5
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = tattn.flash_attention.launches
    got = tattn.flash_attention(tq, tk, tv)
    assert tattn.flash_attention.launches == before
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _close(got, jattn.flash_attention(jq, jk, jv, interpret=True),
           TOL["float32"])
    _close(got, jax.jit(jattn._reference_attention)(jq, jk, jv),
           TOL["float32"])


@pytest.mark.parametrize("d", [32, 64])
def test_attention_plain_bf16_reads_views_of_qkv(d):
    """bf16 operands as the model hands them over (views of a
    [B, N, 3, H, D] projection): computed in float32, as the JAX model casts
    them, and rounded once to bf16."""
    rng = np.random.RandomState(2)
    qkv = rng.randn(2, 49, 3, 4, d).astype(np.float32)
    t = torch.from_numpy(qkv).to(torch.bfloat16)
    q, k, v = (x.transpose(1, 2) for x in t.unbind(2))
    got = tattn.flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 4, 49, d)
    jq, jk, jv = (jnp.asarray(x.float().contiguous().numpy())
                  for x in (q, k, v))
    want = jattn.flash_attention(jq, jk, jv, interpret=True).astype(
        jnp.bfloat16)
    # one rounding of the same f32 values: at most one bf16 ulp apart
    _close(got, want, dict(rtol=8e-3, atol=8e-3))


def _front_arrays(rng, b, h, w, c, with_keep):
    arrays = [rng.randn(b, h, w, c) * 2 + 0.5, 1 + 0.1 * rng.randn(c),
              0.1 * rng.randn(c), rng.randn(c, c) / np.sqrt(c),
              0.1 * rng.randn(c), rng.randn(5, 5, c) / 5, 0.1 * rng.randn(c),
              rng.randn(c, c) / np.sqrt(c), 0.1 * rng.randn(c)]
    keep = ((rng.rand(b, h, w, 1) > 0.6).astype(np.float32)
            if with_keep else None)
    return arrays, keep


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_keep", [False, True])
def test_fused_front_plain_matches_pallas_and_xla(dt, with_keep):
    rng = np.random.RandomState(3)
    arrays, keep = _front_arrays(rng, 2, 8, 12, 128, with_keep)
    t, j = zip(*[_pair(a, DTYPES[dt]) for a in arrays])
    tk = jk = None
    if with_keep:
        tk, jk = _pair(keep, DTYPES[dt])
    before = tfront.fused_front.launches
    got = tfront.fused_front(*t, keep=tk)
    assert tfront.fused_front.launches == before
    assert got.dtype == DTYPES[dt][0] and got.shape == (2, 8, 12, 128)
    _close(got, jfront.fused_front(*j, jk, interpret=True), TOL[dt])
    _close(got, jax.jit(jfront._reference_front)(*j, jk), TOL[dt])


def test_plain_versions_keep_the_kernels_rounding_points():
    """bf16: the plain fused LN-MLP rounds h and a to bf16 where the kernel
    does, so it equals a float64 evaluation with those roundings made."""
    rng = np.random.RandomState(4)
    x, ls, lb, w1, b1, w2, b2 = _mlp_arrays(rng, 64, 128, 256)
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16)
    got = tmlp.fused_ln_mlp_reference(bf(x), torch.tensor(ls).float(),
                                      torch.tensor(lb).float(), bf(w1),
                                      bf(b1), bf(w2), bf(b2))
    r = lambda a: a.to(torch.bfloat16).double()
    xd = r(torch.tensor(x))
    mean = xd.mean(-1, keepdim=True)
    var = (xd * xd).mean(-1, keepdim=True) - mean * mean
    y = r((xd - mean) / torch.sqrt(var + 1e-6) * torch.tensor(ls)
          + torch.tensor(lb))
    h = r(y @ r(torch.tensor(w1)) + r(torch.tensor(b1)))
    a = r(torch.nn.functional.gelu(h))
    out = r(a @ r(torch.tensor(w2)) + r(torch.tensor(b2)))
    want = r(xd + out)
    # float32 stats and sums against float64: an ulp flip at most
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               rtol=1.6e-2, atol=1.6e-2)
    assert float((got.double() - want).abs().gt(1e-9).float().mean()) < 0.05


# ------------------------------------------------- the kernels' host side

@pytest.mark.parametrize("n,dtype,plan", [
    (196, torch.bfloat16, (7, 2)), (197, torch.bfloat16, (7, 2)),
    (49, torch.bfloat16, (4, 1)), (1, torch.bfloat16, (1, 1)),
    (49, torch.float32, (7, 1)), (196, torch.float32, (7, 4)),
    (300, torch.float32, (8, 5))])
def test_attention_plan_fills_whole_warps(n, dtype, plan):
    """The latent geometry (N 196 bf16) runs as 2 blocks of 7 warps a (b, h)
    pair and the validation encoder's (N 49 f32) as one block of 7."""
    assert tattn.attention_plan(n, dtype) == plan


def test_attention_plan_idles_fewer_warps_than_blocks():
    for dtype, rows in ((torch.bfloat16, 16), (torch.float32, 8)):
        for n in range(1, 1200):
            warps, blocks = tattn.attention_plan(n, dtype)
            assert 1 <= warps <= tattn.MAX_WARPS
            covered = warps * blocks * rows
            assert covered >= n  # every query has a warp
            assert covered - n < rows * blocks  # idle: < one warp a block


def test_attention_smem_budget():
    """One block's shared memory (query tile, 2-stage K/V ring, float32 p
    tiles) at every head dim, dtype and block width stays under the H100's
    227 KB, and two blocks fit an SM."""
    assert tattn.attention_smem_bytes(64, 7, torch.bfloat16) == (
        7 * 16 * 72 * 2 + 2 * 2 * 64 * 72 * 2)
    assert tattn.attention_smem_bytes(64, 7, torch.float32) == (
        7 * 8 * 68 * 4 + 2 * 2 * 64 * 68 * 4 + 7 * 8 * 68 * 4)
    for d in tattn.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for w in range(1, tattn.MAX_WARPS + 1):
                assert 2 * tattn.attention_smem_bytes(d, w, dtype) \
                    <= tmlp.SMEM_LIMIT


def test_attention_kernel_shape_checks():
    tattn.check_attention_kernel_shape(128, 12, 64)
    tattn.check_attention_kernel_shape(16, 16, 32)
    with pytest.raises(ValueError, match="head dim"):
        tattn.check_attention_kernel_shape(2, 2, 48)
    with pytest.raises(ValueError, match="B·H"):
        tattn.check_attention_kernel_shape(65536, 1, 64)


def _attention_bf16_emulation(q, k, v):
    """The bf16 kernel's arithmetic in torch: float32 scores of the bf16
    operands scaled after the product, an online softmax over 64-key
    tiles, p split into bf16 hi + lo for p·v (float32 sums), one rounding."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    o = torch.zeros(qf.shape)
    for t in range(0, k.shape[-2], 64):
        s = (qf @ kf[..., t:t + 64, :].transpose(-1, -2)) * np.float32(scale)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        al = torch.exp(m - mx)
        p = torch.exp(s - mx)
        hi, lo = tattn.split_bf16(p)
        o = o * al + hi.float() @ vf[..., t:t + 64, :] \
            + lo.float() @ vf[..., t:t + 64, :]
        l = l * al + p.sum(-1, keepdim=True)
        m = mx
    return o / l


def test_attention_bf16_split_stays_inside_tol_at_the_latent_geometry():
    """The bf16 kernel's p·v as hi.v + lo.v, at the latent extraction's
    [128, 12, 196, 64] on views of a bf16 qkv projection: before the final
    rounding it is within 2^-14 of |out| of the float32 plain version, and
    after it inside ``attention.TOL[bf16]`` of the plain version."""
    rng = np.random.RandomState(5)
    atol, rtol = tattn.TOL[torch.bfloat16]
    worst_f32, worst = 0.0, 0.0
    for _ in range(8):  # 8 chunks of 16 images
        qkv = torch.from_numpy(
            rng.randn(16, 196, 3, 12, 64).astype(np.float32) * 1.5
        ).to(torch.bfloat16)
        q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
        got = _attention_bf16_emulation(q, k, v)
        exact = torch.softmax(
            (q.float() / 8.0) @ k.float().transpose(-1, -2), -1) @ v.float()
        want = tattn.flash_attention_reference(q, k, v)
        worst_f32 = max(worst_f32, float(
            ((got - exact).abs() / exact.abs().amax()).max()))
        err = (got.to(torch.bfloat16).float() - want.float()).abs()
        assert bool((err <= atol + rtol * want.float().abs()).all())
        worst = max(worst, float(err.max()))
    assert worst_f32 < 2.0 ** -14
    assert worst <= 2.0 ** -6  # one bf16 ulp of |out| < 2


# ------------------------- the conv-stage kernels' launch plans (host side)

BF, F32 = torch.bfloat16, torch.float32
# (M, C) of the slice's LN-MLP calls (latents bs 128 bf16, validation and
# training bs 16 f32, training bs 64 bf16) and M ragged against every row
# block of the plans (64, 96, 128)
LN_MLP_M = (128 * 56 * 56, 128 * 28 * 28, 16 * 56 * 56, 16 * 28 * 28,
            64 * 56 * 56, 64 * 28 * 28, 1, 5, 31, 33, 65, 97, 129, 300,
            777, 1000, 12545, 50177)


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("c", tmlp.CHANNELS)
def test_ln_mlp_plan_covers_every_row_once(dtype, c):
    """Every row lies in exactly one row block (the last one ragged), the F
    chunk divides F, the plan is one the library is built for and its
    shared memory fits one block."""
    built = tmlp._LN_MLP_TILES[(dtype, c)]
    for m in LN_MLP_M:
        for f in (4 * c, 96, 512):
            p = tmlp.ln_mlp_plan(m, c, f, dtype)
            assert (p["bm"], p["fc"], p["stages"]) in built
            assert p["blocks"] * p["bm"] >= m > (p["blocks"] - 1) * p["bm"]
            assert f % p["fc"] == 0
            assert p["smem"] == tmlp.ln_mlp_smem_bytes(
                c, p["bm"], p["fc"], p["stages"], dtype) <= tmlp.SMEM_LIMIT


def test_ln_mlp_plan_at_the_slice_geometries():
    """bf16: 128-row blocks and 64-wide chunks at C 256, 96 rows at C 384
    (the f32 accumulator of a 32-row x C/4 warp tile: C/4 registers a
    thread); f32: 64 rows; 32-wide chunks where 64 does not divide F."""
    plan = lambda m, c, dt: tuple(tmlp.ln_mlp_plan(m, c, 4 * c, dt)[k]
                                  for k in ("bm", "fc", "stages", "blocks"))
    assert plan(128 * 56 * 56, 256, BF) == (128, 64, 2, 3136)
    assert plan(128 * 28 * 28, 384, BF) == (96, 32, 2, 1046)
    assert plan(16 * 56 * 56, 256, F32) == (64, 32, 2, 784)
    assert plan(16 * 28 * 28, 384, F32) == (64, 16, 2, 196)
    assert tmlp.ln_mlp_plan(5, 256, 96, BF)["fc"] == 32
    # the layout: y, two or three stages of (w1 chunk, w2 chunk), the a tile
    assert tmlp.ln_mlp_smem_bytes(256, 128, 64, 2, BF) == (
        128 * 264 * 2 + 2 * (64 * 264 * 2 + 256 * 72 * 2) + 128 * 72 * 2)
    assert tmlp.ln_mlp_smem_bytes(384, 64, 16, 2, F32) == (
        64 * 388 * 4 + 2 * (16 * 388 * 4 + 384 * 20 * 4) + 64 * 20 * 4)
    for (dtype, c), tiles in tmlp._LN_MLP_TILES.items():
        for bm, fc, stages in tiles:
            assert tmlp.ln_mlp_smem_bytes(c, bm, fc, stages, dtype) \
                <= tmlp.SMEM_LIMIT


def test_ln_mlp_shape_checks_refuse_what_the_kernel_cannot_take():
    tmlp.check_ln_mlp_kernel_shape(256, 1024)
    tmlp.check_ln_mlp_kernel_shape(384, 96)
    for c, f in ((192, 768), (512, 2048), (256, 100), (384, 16)):
        with pytest.raises(ValueError, match="the kernel takes C in"):
            tmlp.check_ln_mlp_kernel_shape(c, f)
    for m, c, dtype in ((0, 256, BF), (8, 192, BF), (8, 256, torch.float16)):
        with pytest.raises(ValueError, match="no kernel plan"):
            tmlp.ln_mlp_plan(m, c, 4 * c, dtype)
    with pytest.raises(ValueError, match="not a multiple"):
        tmlp.ln_mlp_plan(64, 384, 1544, F32)


def _coverage(p, b, h, w):
    """How many blocks of plan ``p`` write each output pixel [B, H, W], as
    the kernel walks them: block (bx, by, image) writes columns
    [bx·band_w, +band_w) ∩ [0, W) of rows [by·rows, +rows) ∩ [0, H)."""
    n = np.zeros((b, h, w), np.int64)
    for img in range(b):
        for by in range(p["n_by"]):
            for bx in range(p["n_bx"]):
                n[img, by * p["rows"]:min(h, (by + 1) * p["rows"]),
                  bx * p["band_w"]:min(w, (bx + 1) * p["band_w"])] += 1
    return n


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("c", tfront.CHANNELS)
def test_front_plan_covers_every_pixel_once(dtype, c):
    """At the slice's geometries and ragged ones (H, W in 56, 28, 7 and 1
    and others not multiples of the band, B 1 to 128), every output pixel
    lies in exactly one block, no band is wider than the kernel's tile and
    none is empty, the rows a block are at least 4 (or H), and the shared
    memory fits one block."""
    width, kc, stages = tfront._FRONT_TILES[(dtype, c)]
    for b in (1, 2, 16, 128):
        for h, w in ((56, 56), (28, 28), (7, 7), (1, 1), (57, 61), (9, 13),
                     (5, 30), (1, 56), (56, 1), (29, 15)):
            p = tfront.front_plan(b, h, w, c, dtype)
            assert 1 <= p["band_w"] <= width and 1 <= p["rows"]
            assert (p["n_bx"] - 1) * p["band_w"] < w <= p["n_bx"] * p["band_w"]
            assert (p["n_by"] - 1) * p["rows"] < h <= p["n_by"] * p["rows"]
            assert p["rows"] >= min(4, h)
            assert p["blocks"] == b * p["n_bx"] * p["n_by"]
            assert (p["kc"], p["stages"]) == (kc, stages)
            assert p["smem"] == tfront.front_smem_bytes(
                c, width, kc, stages, dtype) <= tmlp.SMEM_LIMIT
            if b <= 2:  # exactly once, counted
                assert (_coverage(p, b, h, w) == 1).all()


def test_front_plan_at_the_slice_geometries():
    """bf16 bs 128: one block an image (the whole 56- and 28-wide rows, 128
    blocks on 132 SMs); f32 bs 16: 14-wide bands and row bands enough for
    128 blocks."""
    keys = ("band_w", "n_bx", "rows", "n_by", "blocks")
    plan = lambda *a: tuple(tfront.front_plan(*a)[k] for k in keys)
    assert plan(128, 56, 56, 256, BF) == (56, 1, 56, 1, 128)
    assert plan(128, 28, 28, 384, BF) == (28, 1, 28, 1, 128)
    assert plan(16, 56, 56, 256, F32) == (14, 4, 28, 2, 128)
    assert plan(16, 28, 28, 384, F32) == (14, 2, 7, 4, 128)
    # the layout: the ring of 5 h1 rows, the y/g tile, keep, weight tiles
    assert tfront.front_smem_bytes(256, 56, 32, 2, BF) == (
        5 * 60 * 256 * 2 + 64 * 264 * 2 + 64 * 4 + 2 * 256 * 40 * 2)
    assert tfront.front_smem_bytes(384, 14, 16, 2, F32) == (
        5 * 18 * 384 * 4 + 20 * 388 * 4 + 80 + 2 * 384 * 20 * 4)


def test_front_shape_checks_refuse_what_the_kernel_cannot_take():
    for args in ((1, 8, 8, 192, BF), (0, 8, 8, 256, BF), (1, 0, 8, 256, F32),
                 (1, 8, 8, 256, torch.float16)):
        with pytest.raises(ValueError, match="no kernel plan"):
            tfront.front_plan(*args)
