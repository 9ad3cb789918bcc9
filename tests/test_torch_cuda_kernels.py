"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (with its reason) where no CUDA device is
present.  Run them on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

This file imports no JAX (and ``--noconftest`` skips the JAX conftest), so
it runs where JAX is not installed."""

import itertools
import math

import pytest
import torch

from multimodal_isic_tpu_torch.ops import affine_warp as aw
from multimodal_isic_tpu_torch.ops import attention as attn
from multimodal_isic_tpu_torch.ops import color_jitter as cj
from multimodal_isic_tpu_torch.ops import connected_components as cc
from multimodal_isic_tpu_torch.ops import fused_convblock as fcb
from multimodal_isic_tpu_torch.ops import fused_dwconv as fd
from multimodal_isic_tpu_torch.ops import fused_mlp as fm
from multimodal_isic_tpu_torch.ops import glcm
from multimodal_isic_tpu_torch.ops import glrlm_runs as runs
from multimodal_isic_tpu_torch.ops import histogram as hist

pytestmark = pytest.mark.cuda

# |err| <= atol + rtol·|plain|: f32 differs only in summation order (atomics
# in the pool); bf16 may flip one rounding of the expand output or y.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
POOL_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-3, 1e-3)}
# warp, 0..255 scale: the kernel and the plain gather share coordinates
# (explicitly rounded, JAX order); the four-tap blend rounds in another order
WARP_ATOL = 2e-2
# grid_sample works in normalised coordinates (|x_n| up to ~3 here): their
# f32 rounding, times (n-1)/2 px, times up to 255 per px, reaches ~0.05 at
# 380² with a large overhang
GRID_SAMPLE_ATOL = 0.1
# colour jitter, 0..255 scale: the kernel rounds each operation as the plain
# version does.  What differs: gray's three products are summed in another
# order than the plain version's matrix product (1 ulp of gray, 1.5e-5 at
# 255); the mean is a float64 sum against a float32 reduction (~1e-6 of the
# mean, 2.6e-4 at 255, times 1 - fc <= 0.2); on the card the plain version
# divides by 255 and 6 as a product with the float32 reciprocal (1 ulp).
# A step carries an error in at most x1.2 (the factors) or about x2 (hue:
# the RGB moves by ~6·delta·dh and h by <= 2·dx / (6·delta), so the
# near-grey pixels whose hue is ill-conditioned move little), so four steps
# keep the largest source, ~6e-5, within ~1e-3.  The hue's exact-equality
# branches (r == maxc) and its sectors agree at their boundaries: a 1-ulp
# difference there moves the result by ulps, not by a branch.
JITTER_ATOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, want, tol):
    atol, rtol = tol
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


# odd sizes, channel counts that leave a partial 32-channel chunk, multiple
# row tiles (190 rows), and both kernel sizes
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,k", [(2, 13, 11, 40, 3), (3, 9, 17, 24, 5),
                                       (2, 190, 190, 24, 3)])
def test_dw_kernel_matches_plain(cuda, dtype, b, h, w, c, k):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(b, h, w, c, generator=g, device=cuda).to(dtype)
    wd = (torch.randn(k, k, 1, c, generator=g, device=cuda) / k).to(dtype)
    bd = torch.randn(c, generator=g, device=cuda) * 0.1
    before = fd.dw_silu_pool.launches
    y, pool = fd.dw_silu_pool(x, wd, bd)
    assert fd.dw_silu_pool.launches == before + 1
    y_ref, pool_ref = fd.dw_silu_pool_reference(x, wd, bd)
    _close(y, y_ref, TOL[dtype])
    _close(pool, pool_ref, POOL_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,cin,cmid,k", [(2, 13, 11, 32, 192, 3),
                                              (2, 15, 9, 136, 816, 5),
                                              (2, 95, 95, 32, 192, 3),
                                              (2, 12, 12, 384, 2304, 3)])
def test_expand_kernel_matches_plain(cuda, dtype, b, h, w, cin, cmid, k):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(b, h, w, cin, generator=g, device=cuda).to(dtype)
    we = (torch.randn(cin, cmid, generator=g, device=cuda) / cin ** 0.5).to(dtype)
    be = torch.randn(cmid, generator=g, device=cuda) * 0.5
    wd = (torch.randn(k, k, 1, cmid, generator=g, device=cuda) / k).to(dtype)
    bd = torch.randn(cmid, generator=g, device=cuda) * 0.1
    before = fd.expand_dw_silu_pool.launches
    y, pool = fd.expand_dw_silu_pool(x, we, be, wd, bd)
    assert fd.expand_dw_silu_pool.launches == before + 1
    y_ref, pool_ref = fd.expand_dw_silu_pool_reference(x, we, be, wd, bd)
    _close(y, y_ref, TOL[dtype])
    _close(pool, pool_ref, POOL_TOL[dtype])


def test_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.randn(1, 8, 8, 32, device=cuda).permute(0, 2, 1, 3)
    with pytest.raises(ValueError):  # not contiguous NHWC
        fd.dw_silu_pool(x, torch.randn(3, 3, 1, 32, device=cuda),
                        torch.randn(32, device=cuda))
    x = torch.randn(1, 8, 8, 20, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError):  # 20 channels: not a multiple of 8
        fd.dw_silu_pool(x, torch.randn(3, 3, 1, 20, device=cuda),
                        torch.randn(20, device=cuda))
    before = fd.dw_silu_pool.launches
    x = torch.randn(1, 8, 8, 16, device="cpu")
    fd.dw_silu_pool(x, torch.randn(3, 3, 1, 16), torch.randn(16))
    assert fd.dw_silu_pool.launches == before  # CPU: the plain version



def _dw_args(g, b, h, w, c, k, dtype, device):
    x = torch.randn(b, h, w, c, generator=g, device=device).to(dtype)
    wd = (torch.randn(k, k, 1, c, generator=g, device=device) / k).to(dtype)
    bd = torch.randn(c, generator=g, device=device) * 0.1
    return x, wd, bd


def _expand_args(g, b, h, w, cin, cmid, k, dtype, device):
    x = torch.randn(b, h, w, cin, generator=g, device=device).to(dtype)
    we = (torch.randn(cin, cmid, generator=g, device=device)
          / cin ** 0.5).to(dtype)
    be = torch.randn(cmid, generator=g, device=device) * 0.5
    wd = (torch.randn(k, k, 1, cmid, generator=g, device=device) / k).to(dtype)
    bd = torch.randn(cmid, generator=g, device=device) * 0.1
    return x, we, be, wd, bd


# ragged against the launch plan: C 24 and 40 against the channel pairs and
# C 72 against the 64-channel chunk; W not a multiple of the 6-column run; H
# below one band or tile; H over several bands or tiles with a short last
# one (41 rows in bands of 4; 50 rows of width 95 in tiles of 4 in bf16);
# batch 1; Cmid 1392 (a 48-channel last chunk); both K.  A rerun gives the
# same bits of y and pool (no float atomics).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geo", [
    ("dw", 1, 5, 7, 24, 24, 3), ("dw", 3, 41, 29, 40, 40, 5),
    ("dw", 2, 190, 190, 40, 40, 3), ("dw", 1, 9, 13, 72, 72, 3),
    ("expand", 1, 12, 12, 232, 1392, 5), ("expand", 1, 50, 95, 32, 192, 3),
    ("expand", 3, 5, 11, 40, 240, 5), ("expand", 2, 24, 24, 136, 816, 3)])
def test_mbconv_kernels_ragged_plans_and_rerun_bits(cuda, dtype, geo):
    kind, b, h, w, cin, cmid, k = geo
    g = torch.Generator(device=cuda).manual_seed(14)
    if kind == "dw":
        args = _dw_args(g, b, h, w, cmid, k, dtype, cuda)
        fn, ref = fd.dw_silu_pool, fd.dw_silu_pool_reference
    else:
        args = _expand_args(g, b, h, w, cin, cmid, k, dtype, cuda)
        fn, ref = fd.expand_dw_silu_pool, fd.expand_dw_silu_pool_reference
    before = fn.launches
    y, pool = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    y_ref, pool_ref = ref(*args)
    _close(y, y_ref, TOL[dtype])
    _close(pool, pool_ref, POOL_TOL[dtype])
    y2, pool2 = fn(*args)
    assert torch.equal(y2, y) and torch.equal(pool2, pool)


def test_mbconv_kernels_make_one_launch_and_no_memset(cuda):
    # weights as the model passes them: views of OIHW parameters (no copy)
    g = torch.Generator(device=cuda).manual_seed(15)
    bf = torch.bfloat16
    x, _, bd = _dw_args(g, 2, 41, 29, 40, 3, bf, cuda)
    wd = torch.randn(40, 1, 3, 3, generator=g, device=cuda).to(bf)
    calls = [(fd.dw_silu_pool, (x, wd.permute(2, 3, 1, 0), bd))]
    x, _, be, _, bd = _expand_args(g, 2, 24, 24, 96, 576, 5, bf, cuda)
    we = torch.randn(576, 96, generator=g, device=cuda).to(bf)
    wd = torch.randn(576, 1, 5, 5, generator=g, device=cuda).to(bf)
    calls.append((fd.expand_dw_silu_pool,
                  (x, we.t(), be, wd.permute(2, 3, 1, 0), bd)))
    for fn, args in calls:
        names = _profile_kernels(lambda: fn(*args))
        assert len(names) == 1 and "mbconv" in names[0], names


@pytest.mark.parametrize("bad", ["smem", "rows", "n_tiles", "cc"])
def test_mbconv_kernels_refuse_a_plan_that_is_not_theirs(cuda, monkeypatch,
                                                         bad):
    """The kernel checks the wrapper's plan: a shared-memory size other than
    its layout's, tiles that do not cover H once, or another channel chunk
    are refused."""
    g = torch.Generator(device=cuda).manual_seed(16)
    calls = [(fd.dw_silu_pool, _dw_args(g, 2, 41, 29, 40, 3, torch.bfloat16,
                                        cuda)),
             (fd.expand_dw_silu_pool,
              _expand_args(g, 2, 24, 24, 96, 576, 5, torch.bfloat16, cuda))]
    plan = fd.mbconv_plan
    change = {"smem": 16, "rows": -1, "n_tiles": -1, "cc": -8}[bad]
    for fn, args in calls:
        fn(*args)
        monkeypatch.setattr(fd, "mbconv_plan", lambda *a: {
            **plan(*a), bad: plan(*a)[bad] + change})
        with pytest.raises(RuntimeError, match="launch failed"):
            fn(*args)
        monkeypatch.setattr(fd, "mbconv_plan", plan)

def _affines(cases, h, w, device):
    """(dx, dy, scale, angle°) → inverse affines [B, 6] about the centre."""
    rows = []
    for dx, dy, s, a in cases:
        t = math.radians(a)
        al, be = s * math.cos(t), s * math.sin(t)
        cx, cy = (w - 1) / 2, (h - 1) / 2
        a13 = (1 - al) * cx - be * cy + dx * w
        a23 = be * cx + (1 - al) * cy + dy * h
        det = al * al + be * be
        i11, i12, i21, i22 = al / det, -be / det, be / det, al / det
        rows.append([i11, i12, -(i11 * a13 + i12 * a23),
                     i21, i22, -(i21 * a13 + i22 * a23)])
    return torch.tensor(rows, dtype=torch.float32, device=device)


# the policy's domain corners, the identity, overhangs far beyond the JAX
# pad budget, at odd and non-square sizes and the slice's 380²
@pytest.mark.parametrize("h,w,out_hw", [(97, 131, (97, 131)), (1, 7, (3, 5)),
                                        (50, 70, (40, 90)),
                                        (380, 380, (380, 380)),
                                        (61, 203, (61, 203)),
                                        (33, 129, (35, 131)),
                                        (40, 90, (45, 257))])
def test_warp_kernel_matches_plain_and_grid_sample(cuda, h, w, out_hw):
    cases = [(0.05, 0.05, 0.9, 15.0), (-0.05, -0.05, 1.1, -15.0),
             (0.0, 0.0, 1.0, 0.0), (0.45, -0.4, 0.6, 170.0),
             (-0.6, 0.3, 1.4, -95.0)]
    g = torch.Generator(device=cuda).manual_seed(2)
    imgs = torch.randint(0, 256, (len(cases), h, w, 3), generator=g,
                         device=cuda).float()
    inv = _affines(cases, h, w, cuda)
    before = aw.affine_warp_batch.launches
    out = aw.affine_warp_batch(imgs, inv, out_hw)
    torch.cuda.synchronize()
    assert aw.affine_warp_batch.launches == before + 1
    assert out.shape == (len(cases), *out_hw, 3)
    ref = aw.affine_warp_batch_reference(imgs, inv, out_hw)
    torch.testing.assert_close(out, ref, atol=WARP_ATOL, rtol=0)
    if min(h, w) > 1:  # grid_sample's normalisation divides by n - 1
        lib = aw.affine_warp_grid_sample(imgs, inv, out_hw)
        torch.testing.assert_close(out, lib, atol=GRID_SAMPLE_ATOL, rtol=0)


def test_warp_kernel_apply_flags_mixed(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    imgs = torch.rand(6, 64, 48, 3, generator=g, device=cuda) * 255
    inv = _affines([(0.05, -0.02, 1.05, 12.0)] * 6, 64, 48, cuda)
    apply = torch.tensor([True, False, True, True, False, False], device=cuda)
    out = aw.affine_warp_batch(imgs, inv, (64, 48), apply=apply)
    ref = aw.affine_warp_batch_reference(imgs, inv, (64, 48), apply=apply)
    torch.testing.assert_close(out, ref, atol=WARP_ATOL, rtol=0)
    assert torch.equal(out[~apply], imgs[~apply])


@pytest.mark.parametrize("bsz", [16, 128])
def test_warp_kernel_on_the_policy_draws_and_reruns(cuda, bsz):
    """The fast policy's draws at bs 16 and 128 (380², C = 3): within
    WARP_ATOL of the plain version and GRID_SAMPLE_ATOL of grid_sample, the
    images not drawn copied exactly, the same bits on a rerun."""
    from multimodal_isic_tpu_torch.data.augment import ssr_draw, ssr_inverse
    g = torch.Generator(device=cuda).manual_seed(30 + bsz)
    d = ssr_draw(g, bsz)
    inv = ssr_inverse(380, 380, d["dx"], d["dy"], d["scale"], d["angle"])
    imgs = torch.randint(0, 256, (bsz, 380, 380, 3), generator=g,
                         device=cuda).float()
    out = aw.affine_warp_batch(imgs, inv, (380, 380), apply=d["apply"])
    again = aw.affine_warp_batch(imgs, inv, (380, 380), apply=d["apply"])
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref = aw.affine_warp_batch_reference(imgs, inv, (380, 380), d["apply"])
    torch.testing.assert_close(out, ref, atol=WARP_ATOL, rtol=0)
    lib = aw.affine_warp_grid_sample(imgs, inv, (380, 380))
    lib = torch.where(d["apply"][:, None, None, None], lib, imgs)
    torch.testing.assert_close(out, lib, atol=GRID_SAMPLE_ATOL, rtol=0)
    assert torch.equal(out[~d["apply"]], imgs[~d["apply"]])


@pytest.mark.parametrize("h,w", [(64, 48), (37, 45), (9, 130)])
def test_warp_kernel_at_multiples_of_the_period(cuda, h, w):
    """Translations by whole periods (2n - 2 px), by multiples of them and
    by just under them, both signs, identity scale: source coordinates that
    land on, just below and far beyond the reflection's folds, where the
    kernel's fast reflection (no fmod below one period) must agree with
    the plain version's fmod everywhere."""
    px, py = 2.0 * (w - 1), 2.0 * (h - 1)
    shifts = [(px, py), (-px, 2 * py), (3 * px, -py), (px - 0.5, py - 0.25),
              (2 * px - 2 ** -10, -(py - 2 ** -10)), (0.0, 0.0)]
    inv = torch.tensor([[1.0, 0.0, sx, 0.0, 1.0, sy] for sx, sy in shifts],
                       dtype=torch.float32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(31)
    imgs = torch.rand(len(shifts), h, w, 3, generator=g, device=cuda) * 255
    out = aw.affine_warp_batch(imgs, inv, (h, w))
    ref = aw.affine_warp_batch_reference(imgs, inv, (h, w))
    torch.testing.assert_close(out, ref, atol=WARP_ATOL, rtol=0)
    # whole periods and the identity are the image itself
    for k in (0, 1, 2, 5):
        torch.testing.assert_close(out[k], imgs[k], atol=WARP_ATOL, rtol=0)


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("h,w,out_hw", [(37, 45, (37, 45)), (50, 70, (41, 93))])
def test_warp_kernel_other_channel_counts(cuda, c, h, w, out_hw):
    g = torch.Generator(device=cuda).manual_seed(32)
    imgs = torch.rand(3, h, w, c, generator=g, device=cuda) * 255
    inv = _affines([(0.05, -0.02, 1.05, 12.0), (-0.3, 0.2, 0.8, -60.0),
                    (0.0, 0.0, 1.0, 0.0)], h, w, cuda)
    out = aw.affine_warp_batch(imgs, inv, out_hw)
    ref = aw.affine_warp_batch_reference(imgs, inv, out_hw)
    torch.testing.assert_close(out, ref, atol=WARP_ATOL, rtol=0)
    assert torch.equal(aw.affine_warp_batch(imgs, inv, out_hw), out)


def test_warp_kernel_channel_paths_give_the_same_bits(cuda):
    """Three channels take the kernel built for C = 3, four the one for any
    C; the blend's roundings are explicit, so the same pixels through each,
    at the policy's corners, a large overhang and the identity, are the
    same bits; and a batch of another size gives the same bits a pixel."""
    g = torch.Generator(device=cuda).manual_seed(34)
    imgs4 = torch.rand(4, 97, 131, 4, generator=g, device=cuda) * 255
    imgs3 = imgs4[..., :3].contiguous()
    inv = _affines([(0.05, 0.05, 0.9, 15.0), (-0.05, -0.05, 1.1, -15.0),
                    (0.45, -0.4, 0.6, 170.0), (0.0, 0.0, 1.0, 0.0)], 97, 131,
                   cuda)
    out3 = aw.affine_warp_batch(imgs3, inv, (97, 131))
    out4 = aw.affine_warp_batch(imgs4, inv, (97, 131))
    three = aw.affine_warp_batch(imgs3[:3].contiguous(), inv[:3], (97, 131))
    assert torch.equal(out4[..., :3], out3)
    assert torch.equal(three, out3[:3])


def test_warp_kernel_apply_flags_mixed_at_a_ragged_width(cuda):
    """37 × 45 × 3: a row is 135 floats, so the 16-byte copies and stores
    of the strips have scalar heads and tails."""
    g = torch.Generator(device=cuda).manual_seed(33)
    imgs = torch.rand(5, 37, 45, 3, generator=g, device=cuda) * 255
    inv = _affines([(0.05, -0.02, 1.05, 12.0)] * 5, 37, 45, cuda)
    apply = torch.tensor([False, True, False, True, True], device=cuda)
    out = aw.affine_warp_batch(imgs, inv, (37, 45), apply=apply)
    ref = aw.affine_warp_batch_reference(imgs, inv, (37, 45), apply=apply)
    torch.testing.assert_close(out, ref, atol=WARP_ATOL, rtol=0)
    assert torch.equal(out[~apply], imgs[~apply])


@pytest.mark.parametrize("bad", ["px_lane", "threads", "blocks", "stage",
                                 "smem"])
def test_warp_kernel_refuses_a_plan_that_is_not_its(cuda, monkeypatch, bad):
    imgs = torch.zeros(2, 40, 41, 3, device=cuda)
    inv = _affines([(0, 0, 1, 0)] * 2, 40, 41, cuda)
    plan = aw.warp_plan
    change = {"px_lane": 1, "threads": 32, "blocks": -1, "stage": 16,
              "smem": 16}[bad]
    monkeypatch.setattr(aw, "warp_plan", lambda *a: {
        **plan(*a), bad: plan(*a)[bad] + change})
    with pytest.raises(RuntimeError, match="launch failed"):
        aw.affine_warp_batch(imgs, inv, (40, 41))


def test_warp_kernel_rejects_what_it_cannot_take(cuda):
    imgs = torch.zeros(2, 8, 8, 3, device=cuda)
    inv = _affines([(0, 0, 1, 0)] * 2, 8, 8, cuda)
    with pytest.raises(ValueError):  # not contiguous
        aw.affine_warp_batch(imgs.transpose(1, 2), inv, (8, 8))
    with pytest.raises(ValueError):  # inv on another device
        aw.affine_warp_batch(imgs, inv.cpu(), (8, 8))
    with pytest.raises(ValueError):  # not 16-byte aligned
        aw.affine_warp_batch(torch.zeros(2 * 8 * 8 * 3 + 1, device=cuda)[1:]
                             .view(2, 8, 8, 3), inv, (8, 8))
    with pytest.raises(ValueError):  # more channels than a row buffer holds
        aw.affine_warp_batch(torch.zeros(2, 8, 8, aw.MAX_C + 1, device=cuda),
                             inv, (8, 8))


# ------------------------------------------------------------ colour jitter

ORDERS = list(itertools.permutations(range(4)))


def _jitter_args(g, bsz, device, apply):
    """The fast policy's factor draws for ``bsz`` images; image i takes
    order ``ORDERS[i % 24]`` and the flag ``apply[i]``."""
    from multimodal_isic_tpu_torch.data.augment import color_jitter_draw
    d = color_jitter_draw(g, bsz)
    d["perm"] = torch.tensor([ORDERS[i % 24] for i in range(bsz)],
                             device=device)
    d["apply"] = torch.tensor(apply, device=device)
    return d


def _jitter_imgs(g, bsz, h, w, device):
    """Images on the 0..255 scale: whole values (ties between channels,
    grey pixels, 0 and 255) in even images, continuous ones in odd."""
    imgs = torch.randint(0, 256, (bsz, h, w, 3), generator=g,
                         device=device).float()
    imgs[1::2] = torch.rand(imgs[1::2].shape, generator=g, device=device) * 255
    imgs[0, : h // 2, :, 1:] = imgs[0, : h // 2, :, :1]  # grey rows
    return imgs


def _jitter(imgs, d):
    return cj.color_jitter_batch(imgs, d["apply"], d["brightness"],
                                 d["contrast"], d["saturation"], d["hue"],
                                 d["perm"])


@pytest.mark.parametrize("bsz,h,w", [(64, 380, 380), (48, 37, 45),
                                     (48, 97, 131)])
def test_jitter_kernel_every_order_matches_plain(cuda, bsz, h, w):
    """All 24 orders, each drawn and not drawn, at the train step's bs 64 ×
    380² and at two ragged sizes (a slice and a chunk end mid-image):
    within JITTER_ATOL of the plain version, the images not drawn copied bit
    for bit, one launch a call, the same bits on a rerun."""
    g = torch.Generator(device=cuda).manual_seed(40 + h)
    apply = [(i // 24) % 2 == 0 if i < 48 else i % 3 > 0 for i in range(bsz)]
    d = _jitter_args(g, bsz, cuda, apply)
    imgs = _jitter_imgs(g, bsz, h, w, cuda)
    before = cj.color_jitter_batch.launches
    out = _jitter(imgs, d)
    again = _jitter(imgs, d)
    torch.cuda.synchronize()
    assert cj.color_jitter_batch.launches == before + 2
    assert out.shape == imgs.shape and out.dtype == torch.float32
    assert torch.equal(out, again)
    assert torch.equal(out[~d["apply"]], imgs[~d["apply"]])
    ref = cj.color_jitter_reference(imgs, d)
    err = (out - ref).abs().amax(dim=(1, 2, 3))
    print(f"jitter {bsz}x{h}x{w}: max |kernel - plain| {float(err.max()):.3e}"
          f" (image {int(err.argmax())}), mean "
          f"{float((out - ref).abs().mean()):.3e}")
    torch.testing.assert_close(out, ref, atol=JITTER_ATOL, rtol=0)
    moved = (out != imgs).flatten(1).any(1)
    assert bool(moved[d["apply"]].all())


def test_jitter_kernel_matches_the_cpu_plain_version(cuda):
    """Against the plain version on the CPU, which divides by 255 and 6 as
    the kernel does (on the card the plain version multiplies by the
    reciprocal)."""
    g = torch.Generator(device=cuda).manual_seed(44)
    d = _jitter_args(g, 24, cuda, [True] * 24)
    imgs = _jitter_imgs(g, 24, 37, 45, cuda)
    out = _jitter(imgs, d).cpu()
    ref = cj.color_jitter_reference(imgs.cpu(), {k: v.cpu()
                                                  for k, v in d.items()})
    print(f"jitter vs the CPU: max {float((out - ref).abs().max()):.3e}, "
          f"{float((out == ref).float().mean()):.4f} of the values equal")
    torch.testing.assert_close(out, ref, atol=JITTER_ATOL, rtol=0)


def test_jitter_kernel_on_the_fast_policy_once_a_batch(cuda):
    """The fast policy at 380² (uint8 450² crops, draws from a generator on
    the card): one jitter launch and one warp launch a batch."""
    from multimodal_isic_tpu_torch.data.augment import make_fusion_train_fast
    policy = make_fusion_train_fast((380, 380))
    g = torch.Generator(device=cuda).manual_seed(45)
    imgs = torch.randint(0, 256, (8, 450, 450, 3), generator=g, device=cuda,
                         dtype=torch.uint8)
    before = (cj.color_jitter_batch.launches, aw.affine_warp_batch.launches)
    for _ in range(3):
        out, _ = policy(imgs, None, g)
    torch.cuda.synchronize()
    assert out.shape == (8, 380, 380, 3) and bool(out.isfinite().all())
    assert (cj.color_jitter_batch.launches - before[0],
            aw.affine_warp_batch.launches - before[1]) == (3, 3)


@pytest.mark.parametrize("bad", ["cluster", "threads", "slice"])
def test_jitter_kernel_refuses_a_plan_that_is_not_its(cuda, monkeypatch, bad):
    g = torch.Generator(device=cuda).manual_seed(47)
    d = _jitter_args(g, 2, cuda, [True, False])
    imgs = _jitter_imgs(g, 2, 40, 41, cuda)
    plan = cj.jitter_plan
    change = {"cluster": 8, "threads": 32, "slice": 128}[bad]
    monkeypatch.setattr(cj, "jitter_plan", lambda *a: {
        **plan(*a), bad: plan(*a)[bad] + change})
    with pytest.raises(RuntimeError, match="launch failed"):
        _jitter(imgs, d)


def test_jitter_kernel_rejects_what_it_cannot_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(48)
    d = _jitter_args(g, 2, cuda, [True, True])
    imgs = _jitter_imgs(g, 2, 8, 8, cuda)
    with pytest.raises(ValueError):  # dtype
        _jitter(imgs.double(), d)
    with pytest.raises(ValueError):  # shape: four channels
        _jitter(torch.zeros(2, 8, 8, 4, device=cuda), d)
    with pytest.raises(ValueError):  # perm on another device
        _jitter(imgs, {**d, "perm": d["perm"].cpu()})
    with pytest.raises(ValueError):  # not contiguous
        _jitter(imgs.transpose(1, 2), d)
    with pytest.raises(ValueError):  # perm not contiguous
        _jitter(imgs, {**d, "perm": d["perm"].t().contiguous().t()})
    before = cj.color_jitter_batch.launches
    assert _jitter(imgs[:0], {k: v[:0] for k, v in d.items()}).shape == (
        0, 8, 8, 3)
    assert cj.color_jitter_batch.launches == before  # nothing to launch


# ----------------------------------------------------- radiomics kernels
# All four compute integers: each must equal its plain version bit for bit.

def _maps(g, m, h, w, vmax, device):
    """[m, h, w] int32 levels 1..vmax inside an ROI (one map with an empty
    mask, one full frame, the rest random), 0 outside; the mask as bool."""
    lv = torch.randint(1, vmax + 1, (m, h, w), generator=g, device=device,
                       dtype=torch.int32)
    inside = torch.rand(m, h, w, generator=g, device=device) < 0.8
    inside[0] = False
    if m > 1:
        inside[1] = True
    return torch.where(inside, lv, 0), inside


RADIOMICS_SIZES = [(4, 14, 13), (3, 45, 60), (3, 40, 129), (2, 1, 7),
                   (2, 7, 1), (3, 450, 600)]


@pytest.mark.parametrize("m,h,w", RADIOMICS_SIZES)
@pytest.mark.parametrize("vmax", [3, 64])
def test_glcm_kernel_matches_plain(cuda, m, h, w, vmax):
    g = torch.Generator(device=cuda).manual_seed(4)
    lv, inside = _maps(g, m, h, w, vmax, cuda)
    before = glcm.glcm_matrices.launches
    got = glcm.glcm_matrices(lv, inside.to(torch.uint8) * 255)
    torch.cuda.synchronize()
    assert glcm.glcm_matrices.launches == before + 1
    assert torch.equal(got, glcm.glcm_matrices_reference(lv, inside))


# Ragged against the plan: W no multiple of 4 (cell-by-cell loads), W over
# one 128-column strip by one, bands of one row (H < cluster), and a map of
# three rounds of bands (2048 × 600: bands of 109 rows, 65,400 pixels).
GLCM_SIZES = [(2, 15, 600), (1, 451, 603), (2, 33, 129), (1, 9, 130),
              (2, 450, 1), (2, 3, 257), (1, 2048, 600)]


@pytest.mark.parametrize("m,h,w", GLCM_SIZES)
@pytest.mark.parametrize("vmax", [2, 64])
def test_glcm_kernel_ragged_plans_and_rerun_bits(cuda, m, h, w, vmax):
    g = torch.Generator(device=cuda).manual_seed(24)
    lv, inside = _maps(g, m, h, w, vmax, cuda)
    want = glcm.glcm_matrices_reference(lv, inside)
    got = [glcm.glcm_matrices(lv, inside) for _ in range(3)]
    torch.cuda.synchronize()
    for k in range(3):
        assert torch.equal(got[k], want), k


def test_glcm_kernel_on_flat_maps_and_a_band_at_the_16_bit_limit(cuda):
    """One level over the whole frame, so every pair of an angle falls in
    one bin: 450 × 600 (bands of 57 rows), and 2040 × 257, whose bands hold
    255 × 257 = 65,535 pixels, so the vertical angle's bin takes exactly
    65,535 counts in each of the first seven bands."""
    for m, h, w in ((2, 450, 600), (1, 2040, 257)):
        assert glcm.glcm_plan(m, h, w)["band_h"] * w <= glcm.MAX_BAND_PX
        lv = torch.full((m, h, w), 7, dtype=torch.int32, device=cuda)
        inside = torch.ones_like(lv, dtype=torch.bool)
        got = glcm.glcm_matrices(lv, inside)
        assert torch.equal(got, glcm.glcm_matrices_reference(lv, inside))
        assert int(got[0, 2, 6, 6]) == 2 * (h - 1) * w
    p = glcm.glcm_plan(1, 2040, 257)
    assert p["band_h"] * 257 == glcm.MAX_BAND_PX and p["rounds"] == 1


def test_glcm_kernel_on_unaligned_maps(cuda):
    """Contiguous maps whose levels start 4 bytes past a 16-byte boundary
    and whose mask starts 1 byte past a 4-byte one: the cell-by-cell loads."""
    g = torch.Generator(device=cuda).manual_seed(25)
    lv, inside = _maps(g, 2, 45, 600, 64, cuda)
    lv_u = torch.empty(lv.numel() + 1, dtype=torch.int32, device=cuda)[1:]
    lv_u.copy_(lv.flatten())
    mk_u = torch.empty(lv.numel() + 1, dtype=torch.uint8, device=cuda)[1:]
    mk_u.copy_(inside.flatten())
    got = glcm.glcm_matrices(lv_u.view(lv.shape), mk_u.view(lv.shape))
    assert torch.equal(got, glcm.glcm_matrices_reference(lv, inside))


def test_glcm_kernel_makes_one_launch_and_no_memset(cuda):
    g = torch.Generator(device=cuda).manual_seed(26)
    lv, inside = _maps(g, 4, 450, 600, 64, cuda)
    before = glcm.glcm_matrices.launches
    glcm.glcm_matrices(lv, inside)
    assert glcm.glcm_matrices.launches == before + 1
    names = _profile_kernels(lambda: glcm.glcm_matrices(lv, inside))
    assert len(names) == 1 and "glcm" in names[0], names


@pytest.mark.parametrize("bad", ["smem", "band_h", "rounds", "threads",
                                 "cluster"])
def test_glcm_kernel_refuses_a_plan_that_is_not_its(cuda, monkeypatch, bad):
    """The library checks the wrapper's plan: another band height, round
    count, cluster, thread count or shared-memory size is refused."""
    g = torch.Generator(device=cuda).manual_seed(27)
    lv, inside = _maps(g, 2, 45, 130, 3, cuda)
    plan = glcm.glcm_plan
    change = {"smem": 16, "band_h": -1, "rounds": 1, "threads": 32,
              "cluster": 8}[bad]
    monkeypatch.setattr(glcm, "glcm_plan", lambda *a: {
        **plan(*a), bad: plan(*a)[bad] + change})
    with pytest.raises(RuntimeError, match="launch failed"):
        glcm.glcm_matrices(lv, inside)


@pytest.mark.parametrize("m,h,w", RADIOMICS_SIZES)
@pytest.mark.parametrize("vmax", [2, 64])
def test_glrlm_runs_kernel_matches_plain(cuda, m, h, w, vmax):
    g = torch.Generator(device=cuda).manual_seed(5)
    lv, inside = _maps(g, m, h, w, vmax, cuda)
    before = runs.glrlm_runs.launches
    got = runs.glrlm_runs(lv, inside)
    torch.cuda.synchronize()
    assert runs.glrlm_runs.launches == before + 1
    assert torch.equal(got, runs.glrlm_runs_reference(lv, inside))


@pytest.mark.parametrize("rows,n,na,nb,offset", [(3, 5000, 9, 29, 0),
                                                 (5, 3001, 64, 640, 0),
                                                 (8, 270000, 64, 640, 0),
                                                 (4, 4096, 64, 640, 1)])
def test_joint_histogram_kernel_matches_plain(cuda, rows, n, na, nb, offset):
    """Codes beyond na / nb and 0 are skipped; ``offset`` makes the rows
    start off a 16-byte boundary (the scalar-load path)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    a = torch.randint(0, na + 3, (rows * n + offset,), generator=g,
                      device=cuda, dtype=torch.int32)[offset:].view(rows, n)
    b = torch.randint(0, nb + 5, (rows * n + offset,), generator=g,
                      device=cuda, dtype=torch.int32)[offset:].view(rows, n)
    before = hist.joint_histogram.launches
    got = hist.joint_histogram(a, b, na, nb)
    torch.cuda.synchronize()
    assert hist.joint_histogram.launches == before + 1
    assert torch.equal(got, hist.joint_histogram_reference(a, b, na, nb))
    assert torch.equal(got, hist.library_joint_histogram(a, b, na, nb))


def test_joint_histogram_kernel_rejects_what_it_cannot_take(cuda):
    a = torch.ones(2, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # 250 x 250 int32 > one block's smem
        hist.joint_histogram(a, a, 250, 250)
    with pytest.raises(ValueError):  # not contiguous
        hist.joint_histogram(a.t(), a.t(), 4, 4)



def _firstorder_maps(g, b, n, offset, device):
    """[b, n] float32 image and int32 levels (rows ``offset`` elements off a
    16-byte boundary when offset > 0): map 0 an empty ROI, map 1 one valid
    pixel, the rest ~60% valid with codes 1..64, codes in (64, 128], codes
    above 128 and negative codes."""
    x = (torch.randn(b * n + offset, generator=g, device=device) * 40
         + 90)[offset:].view(b, n)
    lv = torch.randint(-3, 200, (b * n + offset,), generator=g, device=device,
                       dtype=torch.int32)[offset:].view(b, n)
    keep = torch.rand(b, n, generator=g, device=device) < 0.6
    lv = torch.where(keep, lv, 0)
    lv[0] = 0
    if b > 1:
        lv[1] = 0
        lv[1, n // 2] = 5
    return x, lv


@pytest.mark.parametrize("b,n,offset", [(3, 4800, 0), (64, 270000, 0),
                                        (2, 4801, 0), (3, 4096, 1),
                                        (1, 3, 0)])
def test_firstorder_kernel_matches_plain(cuda, b, n, offset):
    """n, min, max and hist equal to the plain version, the sums within
    SUM_TOL of their magnitude; a rerun gives the same bits.  ``offset`` and
    odd n take the scalar-load path."""
    g = torch.Generator(device=cuda).manual_seed(14)
    x, lv = _firstorder_maps(g, b, n, offset, cuda)
    before = hist.firstorder_accumulate.launches
    got = hist.firstorder_accumulate(x, lv)
    torch.cuda.synchronize()
    assert hist.firstorder_accumulate.launches == before + 1
    assert got[0].shape == (b, 9) and got[1].shape == (b, hist.NG)
    want = hist.firstorder_accumulate_reference(x, lv)
    exact, ratio = hist.firstorder_disagreement(x, lv, got, want)
    assert exact and ratio <= 1.0, ratio
    big = torch.tensor(3.4e38, device=cuda)  # map 0 is empty: the sentinels
    assert got[0][0, 2] == big and got[0][0, 3] == -big
    again = hist.firstorder_accumulate(x, lv)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.parametrize("b,n,path", [(64, 450 * 600, "cluster"),
                                      (2, 884736, "cluster"),
                                      (2, 884737, "two_pass"),
                                      (4, 1000 * 1000, "two_pass")])
def test_firstorder_kernel_paths(cuda, b, n, path):
    """Both paths of the plan: the radiomics chunk's maps and the cluster's
    capacity read once by one launch, larger maps by the two-pass kernels;
    each equal to the plain version in n, min, max and hist, its sums within
    SUM_TOL, the same bits on a rerun."""
    assert hist.firstorder_plan(b, n)["path"] == path
    g = torch.Generator(device=cuda).manual_seed(18)
    x, lv = _firstorder_maps(g, b, n, 0, cuda)
    got = hist.firstorder_accumulate(x, lv)
    want = hist.firstorder_accumulate_reference(x, lv)
    exact, ratio = hist.firstorder_disagreement(x, lv, got, want)
    assert exact and ratio <= 1.0, ratio
    again = hist.firstorder_accumulate(x, lv)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    names = [n for n in _profile_kernels(
        lambda: hist.firstorder_accumulate(x, lv)) if "firstorder" in n]
    assert len(names) == hist.firstorder_plan(b, n)["launches"], names


def test_firstorder_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.zeros(4, 8, device=cuda)
    lv = torch.ones(4, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # not contiguous
        hist.firstorder_accumulate(x.t(), lv.t())
    with pytest.raises(ValueError):  # int64 levels
        hist.firstorder_accumulate(x, lv.long())
    with pytest.raises(ValueError):  # one device
        hist.firstorder_accumulate(x, lv.cpu())


def _serpentine(h, w, device):
    lv = torch.full((h, w), 2, dtype=torch.int32)
    snake = torch.zeros((h, w), dtype=torch.bool)
    snake[0::2] = True
    for r in range(1, h, 2):
        snake[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    lv[snake] = 7
    return lv[None].to(device), snake[None].to(device)


@pytest.mark.parametrize("m,h,w", RADIOMICS_SIZES)
@pytest.mark.parametrize("vmax", [2, 64])
def test_cc_kernel_matches_plain(cuda, m, h, w, vmax):
    g = torch.Generator(device=cuda).manual_seed(7)
    lv, inside = _maps(g, m, h, w, vmax, cuda)
    before = cc.connected_components.launches
    got = cc.connected_components(lv, inside)
    torch.cuda.synchronize()
    assert cc.connected_components.launches == before + 1
    assert torch.equal(got, cc.connected_components_reference(lv, inside))


@pytest.mark.parametrize("h,w", [(40, 41), (450, 600)])
def test_cc_kernel_serpentine_is_one_zone(cuda, h, w):
    lv, snake = _serpentine(h, w, cuda)
    inside = torch.ones_like(snake)
    got = cc.connected_components(lv, inside)
    assert torch.equal(got, cc.connected_components_reference(lv, inside))
    assert got[snake].unique().numel() == 1 and int(got[snake][0]) == 0


# Sizes that straddle the plans' tiles (16 rows by up to 128 columns) and
# bands (16 rows) by one: one row, one column, one band, H under one band,
# widths that are no multiple of 4 (the scalar paths).
RAGGED_SIZES = [(2, 15, 600), (2, 16, 600), (2, 17, 600), (2, 31, 128),
                (2, 33, 129), (2, 1, 600), (2, 450, 1), (2, 5, 601),
                (1, 449, 127), (1, 451, 603), (3, 32, 257)]


@pytest.mark.parametrize("m,h,w", RAGGED_SIZES)
@pytest.mark.parametrize("vmax", [2, 64])
def test_cc_and_runs_kernels_ragged_plans_and_rerun_bits(cuda, m, h, w, vmax):
    g = torch.Generator(device=cuda).manual_seed(20)
    lv, inside = _maps(g, m, h, w, vmax, cuda)
    for fn, ref in ((cc.connected_components, cc.connected_components_reference),
                    (runs.glrlm_runs, runs.glrlm_runs_reference)):
        before = fn.launches
        got = fn(lv, inside)
        again = fn(lv, inside)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        assert torch.equal(got, ref(lv, inside))
        assert torch.equal(again, got)


def _vertical_serpentine(h, w, device):
    lv, snake = _serpentine(w, h, device)
    return lv.transpose(1, 2).contiguous(), snake.transpose(1, 2).contiguous()


@pytest.mark.parametrize("h,w", [(40, 41), (450, 600)])
def test_cc_and_runs_kernels_on_both_serpentines(cuda, h, w):
    """Each serpentine is one zone that crosses every tile border: the
    horizontal one every tile row, the vertical one every tile column."""
    for lv, snake in (_serpentine(h, w, cuda), _vertical_serpentine(h, w, cuda)):
        inside = torch.ones_like(snake)
        got = cc.connected_components(lv, inside)
        assert torch.equal(got, cc.connected_components_reference(lv, inside))
        assert got[snake].unique().numel() == 1 and int(got[snake][0]) == 0
        assert torch.equal(runs.glrlm_runs(lv, inside),
                           runs.glrlm_runs_reference(lv, inside))


def test_cc_and_runs_kernels_on_one_component_over_the_frame(cuda):
    """One level over the whole 450×600 frame: one zone labelled 0, runs as
    long as the frame's rows, columns and diagonals."""
    lv = torch.full((2, 450, 600), 5, dtype=torch.int32, device=cuda)
    inside = torch.ones_like(lv, dtype=torch.bool)
    got = cc.connected_components(lv, inside)
    assert (got == 0).all()
    assert torch.equal(runs.glrlm_runs(lv, inside),
                       runs.glrlm_runs_reference(lv, inside))


def test_cc_and_runs_kernels_launch_counts(cuda):
    """At the radiomics chunk's map size B7 makes three device launches a
    call and B5 one; one map under one tile makes one B7 launch."""
    g = torch.Generator(device=cuda).manual_seed(21)
    for (m, h, w), n_cc, n_runs in (((2, 450, 600), 3, 1), ((2, 9, 40), 1, 1)):
        lv, inside = _maps(g, m, h, w, 3, cuda)
        names = _profile_kernels(lambda: cc.connected_components(lv, inside))
        assert len(names) == n_cc and all("cc_" in n for n in names), names
        names = _profile_kernels(lambda: runs.glrlm_runs(lv, inside))
        assert len(names) == n_runs and all("runs_" in n for n in names), names


@pytest.mark.parametrize("bad", ["smem", "tile_h", "tile_w", "n_ty", "threads"])
def test_cc_kernel_refuses_a_plan_that_is_not_its(cuda, monkeypatch, bad):
    """The library checks the wrapper's plan: another shared-memory size or
    thread count, or tiles that do not cover the map once, are refused."""
    g = torch.Generator(device=cuda).manual_seed(22)
    lv, inside = _maps(g, 2, 45, 130, 3, cuda)
    plan = cc.cc_plan
    change = {"smem": 16, "tile_h": -1, "tile_w": 4, "n_ty": 1,
              "threads": 32}[bad]
    monkeypatch.setattr(cc, "cc_plan", lambda *a: {
        **plan(*a), bad: plan(*a)[bad] + change})
    with pytest.raises(RuntimeError, match="launch failed"):
        cc.connected_components(lv, inside)


@pytest.mark.parametrize("bad", ["smem", "band_h", "n_bands", "threads"])
def test_runs_kernel_refuses_a_plan_that_is_not_its(cuda, monkeypatch, bad):
    """The library checks the wrapper's plan: other shared-memory sizes or
    thread counts, or bands that do not cover H once, are refused."""
    g = torch.Generator(device=cuda).manual_seed(23)
    lv, inside = _maps(g, 2, 45, 130, 3, cuda)
    plan = runs.runs_plan
    change = {"smem": 16, "band_h": -1, "n_bands": 1, "threads": 1}[bad]
    monkeypatch.setattr(runs, "runs_plan", lambda *a: {
        **plan(*a), bad: plan(*a)[bad] + change})
    with pytest.raises(RuntimeError, match="launch failed"):
        runs.glrlm_runs(lv, inside)


def _capture(fn, stream):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = fn()
    return graph, out


def test_radiomics_kernels_under_cuda_graph_capture(cuda):
    """B4, B5 and B7 captured in one CUDA graph on a stream that has had no
    eager call (so B5's stream state is first made inside the capture),
    replayed 3 times: each replay bit for bit equal to the plain versions.
    Then a second graph on the same stream with other maps, replayed before
    and between the first's replays, and an eager B5 call on that stream
    after both: B5's per-stream state must not leak between them."""
    g = torch.Generator(device=cuda).manual_seed(28)
    maps = [_maps(g, 3, 45, 130, v, cuda) for v in (5, 64)]
    want = [(glcm.glcm_matrices_reference(lv, ins),
             runs.glrlm_runs_reference(lv, ins),
             cc.connected_components_reference(lv, ins)) for lv, ins in maps]
    for lv, ins in maps:  # load the libraries; eager calls on another stream
        glcm.glcm_matrices(lv, ins), runs.glrlm_runs(lv, ins)
        cc.connected_components(lv, ins)
    torch.cuda.synchronize()
    fresh = torch.cuda.Stream()
    graphs = [_capture(lambda lv=lv, ins=ins: (
        glcm.glcm_matrices(lv, ins), runs.glrlm_runs(lv, ins),
        cc.connected_components(lv, ins)), fresh) for lv, ins in maps]
    for k in (1, 0, 1, 0, 0, 1):
        graph, outs = graphs[k]
        graph.replay()
        torch.cuda.synchronize()
        for got, ref in zip(outs, want[k]):
            assert torch.equal(got, ref), k
    with torch.cuda.stream(fresh):
        lv, ins = maps[1]
        got = runs.glrlm_runs(lv, ins)
    torch.cuda.synchronize()
    assert torch.equal(got, want[1][1])
    graphs[0][0].replay()
    torch.cuda.synchronize()
    assert torch.equal(graphs[0][1][1], want[0][1])


# ---------------------------------------------------------------- ConvMAE
# kernel vs plain tolerances: each ops module's ``TOL`` (chip_smoke.py holds
# the kernels to the same tables)


def _convblock_params(g, c, f, dtype, device):
    """LN scale/shift, w1 [C, F], b1, w2 [F, C], b2 as the model passes
    them: weights in ``dtype``, vectors rounded to it."""
    ls = (1.0 + 0.1 * torch.randn(c, generator=g, device=device))
    lb = 0.1 * torch.randn(c, generator=g, device=device)
    w1 = (torch.randn(c, f, generator=g, device=device) / c ** 0.5).to(dtype)
    b1 = (0.1 * torch.randn(f, generator=g, device=device)).to(dtype)
    w2 = (torch.randn(f, c, generator=g, device=device) / f ** 0.5).to(dtype)
    b2 = (0.1 * torch.randn(c, generator=g, device=device)).to(dtype)
    return ls, lb, w1, b1, w2, b2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c,f", [(300, 384, 512), (1000, 256, 1024),
                                   (777, 384, 1536), (5, 256, 96)])
def test_fused_ln_mlp_kernel_matches_plain(cuda, dtype, m, c, f):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = (torch.randn(m, c, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    args = (x, *_convblock_params(g, c, f, dtype, cuda))
    before = fm.fused_ln_mlp.launches
    got = fm.fused_ln_mlp(*args)
    assert fm.fused_ln_mlp.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (m, c)
    _close(got, fm.fused_ln_mlp_reference(*args), fm.TOL[dtype])


def test_fused_ln_mlp_kernel_rejects_what_it_cannot_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(8, 192, generator=g, device=cuda)
    with pytest.raises(ValueError, match="C in"):
        fm.fused_ln_mlp(x, *_convblock_params(g, 192, 768, torch.float32,
                                              cuda))
    x = torch.randn(8, 256, generator=g, device=cuda)
    with pytest.raises(ValueError, match="multiple of"):
        fm.fused_ln_mlp(x, *_convblock_params(g, 256, 100, torch.float32,
                                              cuda))


# ragged against the launch plans: M one past a row block (bf16 128 at C
# 256, 96 at C 384; f32 64), M below one block and 1, many blocks with a
# short last one, and F 96 (the 32-wide chunk where 64 does not divide F).
# A rerun gives the same bits.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c,f", [(129, 256, 1024), (97, 384, 1536),
                                   (65, 256, 96), (33, 384, 1536),
                                   (1, 256, 1024), (12545, 384, 1536),
                                   (50177, 256, 1024)])
def test_fused_ln_mlp_kernel_ragged_plans_and_rerun_bits(cuda, dtype, m, c,
                                                         f):
    g = torch.Generator(device=cuda).manual_seed(17)
    x = (torch.randn(m, c, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    args = (x, *_convblock_params(g, c, f, dtype, cuda))
    before = fm.fused_ln_mlp.launches
    got = fm.fused_ln_mlp(*args)
    torch.cuda.synchronize()
    assert fm.fused_ln_mlp.launches == before + 1
    _close(got, fm.fused_ln_mlp_reference(*args), fm.TOL[dtype])
    assert torch.equal(fm.fused_ln_mlp(*args), got)


def _profile_kernels(fn, traces=5):
    """Names of the device activities one call of ``fn`` launches, after a
    call that makes any one-time allocation.  A trace that recorded no
    device activity at all lost the call's (torch.profiler sometimes
    records nothing for a traced call), so the call is traced again, up to
    ``traces`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(traces):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


def test_conv_stage_kernels_make_one_launch_a_call(cuda):
    """Weights as the model passes them (views of [out, in] conv weights in
    the compute dtype), float32 vectors: the LN-MLP call is its kernel and
    nothing else (no memset, no copy); the front call launches its kernel
    once (its taps are converted to float32 values by the wrapper)."""
    g = torch.Generator(device=cuda).manual_seed(18)
    bf = torch.bfloat16
    x = (torch.randn(300, 256, generator=g, device=cuda)).to(bf)
    ls, lb, _, b1, _, b2 = _convblock_params(g, 256, 1024, torch.float32,
                                             cuda)
    w1 = torch.randn(1024, 256, generator=g, device=cuda).to(bf)
    w2 = torch.randn(256, 1024, generator=g, device=cuda).to(bf)
    names = _profile_kernels(lambda: fm.fused_ln_mlp(
        x, ls, lb, w1.t(), b1, w2.t(), b2))
    assert len(names) == 1 and "fused_ln_mlp" in names[0], names
    args = list(_front_args(g, 2, 28, 28, 384, bf, cuda, True))
    args[3] = torch.randn(384, 384, generator=g, device=cuda).to(bf).t()
    names = _profile_kernels(lambda: fcb.fused_front(*args))
    assert sum("fused_front" in n for n in names) == 1, names
    assert not any("memset" in n.lower() for n in names), names


@pytest.mark.parametrize("bad", ["smem", "bm", "fc", "stages"])
def test_fused_ln_mlp_kernel_refuses_a_plan_that_is_not_its(cuda, monkeypatch,
                                                          bad):
    """The library checks the wrapper's plan: another shared-memory size, or
    a row block, chunk or ring depth it is not built for, is refused."""
    g = torch.Generator(device=cuda).manual_seed(19)
    for dtype, c in ((torch.bfloat16, 256), (torch.float32, 384)):
        x = torch.randn(200, c, generator=g, device=cuda).to(dtype)
        args = (x, *_convblock_params(g, c, 4 * c, dtype, cuda))
        fm.fused_ln_mlp(*args)
        plan = fm.ln_mlp_plan
        change = {"smem": 16, "bm": 8, "fc": -8, "stages": 1}[bad]
        monkeypatch.setattr(fm, "ln_mlp_plan", lambda *a: {
            **plan(*a), bad: plan(*a)[bad] + change})
        with pytest.raises(RuntimeError, match="launch failed"):
            fm.fused_ln_mlp(*args)
        monkeypatch.setattr(fm, "ln_mlp_plan", plan)


@pytest.mark.parametrize("bad", ["smem", "band_w", "n_bx", "rows", "n_by",
                                 "kc"])
def test_fused_front_kernel_refuses_a_plan_that_is_not_its(cuda, monkeypatch,
                                                         bad):
    """The library checks the wrapper's plan: another shared-memory size or K
    chunk, bands or row bands that do not cover the image exactly once, are
    refused."""
    g = torch.Generator(device=cuda).manual_seed(20)
    for dtype in (torch.bfloat16, torch.float32):
        args = _front_args(g, 2, 28, 28, 384, dtype, cuda, True)
        fcb.fused_front(*args)
        plan = fcb.front_plan
        change = {"smem": 16, "band_w": -1, "n_bx": 1, "rows": -1, "n_by": 1,
                  "kc": -8}[bad]
        monkeypatch.setattr(fcb, "front_plan", lambda *a: {
            **plan(*a), bad: plan(*a)[bad] + change})
        with pytest.raises(RuntimeError, match="launch failed"):
            fcb.fused_front(*args)
        monkeypatch.setattr(fcb, "front_plan", plan)


# N 1, 49, 196 and 197 (a ragged last warp and key tile) at D 32 and 64,
# and N 300 (three query blocks, five key tiles)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,n,d", [(2, 3, 196, 64), (3, 12, 49, 64),
                                     (2, 16, 196, 32), (1, 2, 1, 64),
                                     (2, 2, 300, 32), (2, 3, 197, 64),
                                     (2, 3, 197, 32), (3, 4, 49, 32),
                                     (1, 2, 1, 32)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, h, n, d):
    g = torch.Generator(device=cuda).manual_seed(7)
    # q, k, v as the model hands them over: views of a [B, N, 3, H, D] qkv
    qkv = (torch.randn(b, n, 3, h, d, generator=g, device=cuda) * 1.5
           ).to(dtype)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    before = attn.flash_attention.launches
    got = attn.flash_attention(q, k, v)
    assert attn.flash_attention.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, h, n, d)
    _close(got, attn.flash_attention_reference(q, k, v), attn.TOL[dtype])
    # contiguous operands give the same bits, and so does a rerun
    assert torch.equal(attn.flash_attention(q.contiguous(), k.contiguous(),
                                            v.contiguous()), got)
    assert torch.equal(attn.flash_attention(q, k, v), got)


def test_flash_attention_kernel_refuses_a_wrong_smem_size(cuda, monkeypatch):
    """The kernel checks the wrapper's shared-memory size against its own
    layout and refuses a launch where they differ."""
    q = torch.randn(1, 2, 49, 64, device=cuda)
    attn.flash_attention(q, q, q)
    size = attn.attention_smem_bytes
    monkeypatch.setattr(attn, "attention_smem_bytes",
                        lambda d, w, dt: size(d, w, dt) + 16)
    with pytest.raises(RuntimeError, match="launch failed"):
        attn.flash_attention(q, q, q)


def test_flash_attention_matches_sdpa(cuda):
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn(2, 12, 196, 64, generator=g, device=cuda)
               for _ in range(3))
    want = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    _close(attn.flash_attention(q, k, v), want, attn.TOL[torch.float32])


def test_flash_attention_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        attn.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 64, 8, device=cuda).transpose(2, 3)  # D strided
    with pytest.raises(ValueError, match="contiguous"):
        attn.flash_attention(q, q, q)


def _front_args(g, b, h, w, c, dtype, device, with_keep):
    x = (torch.randn(b, h, w, c, generator=g, device=device) * 2 + 0.5
         ).to(dtype)
    ls, lb, w1, b1, _, _ = _convblock_params(g, c, c, dtype, device)
    w2 = (torch.randn(c, c, generator=g, device=device) / c ** 0.5).to(dtype)
    b2 = (0.1 * torch.randn(c, generator=g, device=device)).to(dtype)
    wd = (torch.randn(5, 5, c, generator=g, device=device) / 5).to(dtype)
    bd = (0.1 * torch.randn(c, generator=g, device=device)).to(dtype)
    keep = None
    if with_keep:
        keep = (torch.rand(b, h, w, 1, generator=g, device=device) > 0.6
                ).to(dtype)
    return (x, ls.to(dtype), lb.to(dtype), w1, b1, wd, bd, w2, b2, keep)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("b,h,w,c", [(2, 14, 14, 256), (2, 28, 28, 384),
                                     (1, 9, 13, 256), (2, 56, 56, 256)])
def test_fused_front_kernel_matches_plain(cuda, dtype, with_keep, b, h, w, c):
    g = torch.Generator(device=cuda).manual_seed(9)
    args = _front_args(g, b, h, w, c, dtype, cuda, with_keep)
    before = fcb.fused_front.launches
    got = fcb.fused_front(*args)
    assert fcb.fused_front.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, h, w, c)
    _close(got, fcb.fused_front_reference(*args), fcb.TOL[dtype])


# ragged against the plans: H and W not multiples of the band (several
# bands with a short last one, the 2-column seams), W and H 1 and 7, B 1
# (many row bands of a few rows), with and without keep; a rerun gives the
# same bits
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("b,h,w,c", [(1, 1, 1, 256), (1, 7, 7, 384),
                                     (3, 57, 61, 384), (2, 5, 30, 256),
                                     (1, 56, 56, 256), (2, 29, 15, 384)])
def test_fused_front_kernel_ragged_plans_and_rerun_bits(cuda, dtype,
                                                        with_keep, b, h, w,
                                                        c):
    g = torch.Generator(device=cuda).manual_seed(21)
    args = _front_args(g, b, h, w, c, dtype, cuda, with_keep)
    before = fcb.fused_front.launches
    got = fcb.fused_front(*args)
    torch.cuda.synchronize()
    assert fcb.fused_front.launches == before + 1
    _close(got, fcb.fused_front_reference(*args), fcb.TOL[dtype])
    assert torch.equal(fcb.fused_front(*args), got)


def test_fused_front_kernel_rejects_what_it_cannot_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(10)
    args = _front_args(g, 1, 8, 8, 192, torch.float32, cuda, False)
    with pytest.raises(ValueError, match="C in"):
        fcb.fused_front(*args)


# M past the 128-row tiles and the weight GEMMs' row splits (300, 1000,
# 2049, 77), both stages' C, a ragged F tile (96)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c,f", [(300, 384, 1536), (1000, 256, 1024),
                                   (77, 256, 96), (12544, 384, 1536),
                                   (2049, 256, 1024), (1000, 384, 1536)])
def test_fused_ln_mlp_backward_kernel_matches_plain(cuda, dtype, m, c, f):
    g = torch.Generator(device=cuda).manual_seed(11)
    x = (torch.randn(m, c, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    gy = torch.randn(m, c, generator=g, device=cuda).to(dtype)
    ls, lb, w1, b1, w2, b2 = _convblock_params(g, c, f, dtype, cuda)
    args = (x, gy, ls, lb, w1, b1, w2, b2)
    before = fm.fused_ln_mlp_backward.launches
    got = fm.fused_ln_mlp_backward(*args)
    assert fm.fused_ln_mlp_backward.launches == before + 1
    torch.cuda.synchronize()
    want = fm.fused_ln_mlp_backward_reference(*args)
    tol = fm.BWD_TOL[dtype]
    _close(got[0], want[0], tol["dx"])
    for a, b, inp in zip(got[1:], want[1:], args[2:]):
        assert a.shape == b.shape and a.dtype == inp.dtype
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        assert rel <= tol["rel_fro"], rel
    # the weight sums are the kernel's own fixed-order reduction: the same
    # bits every run
    again = fm.fused_ln_mlp_backward(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_fused_ln_mlp_backward_kernel_refuses_a_plan_short_of_the_rows(
        cuda, monkeypatch):
    """The library checks the wrapper's launch plan: row splits that do not
    cover M, or are not whole 32-row units, are refused."""
    g = torch.Generator(device=cuda).manual_seed(11)
    m, c, f = 1000, 256, 1024
    x = torch.randn(m, c, generator=g, device=cuda)
    args = (x, x.clone(), *_convblock_params(g, c, f, torch.float32, cuda))
    fm.fused_ln_mlp_backward(*args)
    plan = fm.ln_mlp_bwd_plan
    for bad in ({"nsplit": plan(m, c, f)["nsplit"] - 1},
                {"rows_per": plan(m, c, f)["rows_per"] - 1}):
        monkeypatch.setattr(fm, "ln_mlp_bwd_plan",
                            lambda *a, bad=bad: {**plan(*a), **bad})
        with pytest.raises(RuntimeError, match="launch failed"):
            fm.fused_ln_mlp_backward(*args)


def _mlp_args(g, m, c, f, c2, dtype, device):
    x = torch.randn(m, c, generator=g, device=device).to(dtype)
    w1 = (torch.randn(c, f, generator=g, device=device) / c ** 0.5).to(dtype)
    b1 = (0.1 * torch.randn(f, generator=g, device=device)).to(dtype)
    w2 = (torch.randn(f, c2, generator=g, device=device) / f ** 0.5).to(dtype)
    b2 = (0.1 * torch.randn(c2, generator=g, device=device)).to(dtype)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c,f,c2", [(300, 128, 256, 128),
                                      (1000, 256, 1024, 256),
                                      (777, 384, 1536, 384),
                                      (1000, 128, 512, 256),
                                      (5, 512, 128, 512),
                                      (33, 256, 384, 128)])
def test_fused_mlp_kernel_matches_plain(cuda, dtype, m, c, f, c2):
    g = torch.Generator(device=cuda).manual_seed(15)
    args = _mlp_args(g, m, c, f, c2, dtype, cuda)
    before = fm.fused_mlp.launches
    got = fm.fused_mlp(*args)
    assert fm.fused_mlp.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (m, c2)
    _close(got, fm.fused_mlp_reference(*args), fm.TOL[dtype])
    assert torch.equal(got, fm.fused_mlp(*args))  # the same bits on a rerun


# one shape a configuration of the plan: (dtype, M, C, F, C2) → (bm, fc,
# stages); ragged M throughout
CONFIGS = [(torch.bfloat16, 129, 256, 384, 128, (128, 64, 2)),
           (torch.bfloat16, 1000, 384, 512, 256, (128, 32, 3)),
           (torch.bfloat16, 777, 384, 1536, 384, (64, 32, 3)),
           (torch.bfloat16, 300, 1024, 512, 256, (64, 16, 2)),
           (torch.bfloat16, 999, 896, 256, 512, (64, 16, 2)),
           (torch.float32, 1000, 256, 1024, 256, (64, 32, 2)),
           (torch.float32, 777, 384, 1536, 384, (64, 16, 2)),
           (torch.float32, 200, 768, 256, 128, (32, 16, 2))]


@pytest.mark.parametrize("dtype,m,c,f,c2,cfg", CONFIGS,
                         ids=[f"{str(t[0])[6:]}-{t[1]}-{t[2]}-{t[4]}"
                              for t in CONFIGS])
def test_fused_mlp_kernel_every_configuration(cuda, dtype, m, c, f, c2, cfg):
    """Each configuration the plan picks (row tiles, F chunk, ring stages)
    against the plain version within ``fused_mlp.TOL``, the same bits on a
    rerun, one launch a call and one device kernel."""
    p = fm.mlp_plan(m, c, f, c2, dtype)
    assert (p["bm"], p["fc"], p["stages"]) == cfg
    g = torch.Generator(device=cuda).manual_seed(19)
    args = _mlp_args(g, m, c, f, c2, dtype, cuda)
    before = fm.fused_mlp.launches
    got = fm.fused_mlp(*args)
    assert fm.fused_mlp.launches == before + 1
    torch.cuda.synchronize()
    _close(got, fm.fused_mlp_reference(*args), fm.TOL[dtype])
    assert torch.equal(got, fm.fused_mlp(*args))
    names = [n for n in _profile_kernels(lambda: fm.fused_mlp(*args))
             if "mlp_" in n]
    assert len(names) == 1, names


def test_fused_mlp_kernel_stays_on_the_autograd_graph(cuda):
    g = torch.Generator(device=cuda).manual_seed(16)
    args = [t.requires_grad_() for t in
            _mlp_args(g, 200, 128, 512, 256, torch.float32, cuda)]
    gy = torch.randn(200, 256, generator=g, device=cuda)
    out = fm.fused_mlp(*args)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, args, gy)
    want = torch.autograd.grad(fm.fused_mlp_reference(*args), args, gy)
    for a, b in zip(got, want):
        assert torch.equal(a, b)  # both recompute the plain version


def test_fused_mlp_kernel_rejects_what_it_cannot_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(17)
    with pytest.raises(ValueError, match="C2 in"):  # accumulator > registers
        fm.fused_mlp(*_mlp_args(g, 8, 128, 128, 640, torch.float32, cuda))
    with pytest.raises(ValueError, match="shared memory"):
        fm.fused_mlp(*_mlp_args(g, 8, 640, 128, 512, torch.float32, cuda))
    with pytest.raises(ValueError, match="lane-aligned"):
        fm.fused_mlp(*_mlp_args(g, 8, 192, 256, 128, torch.float32, cuda))


@pytest.mark.parametrize("flags", [
    dict(use_fused_mlp=True),
    dict(use_fused_mlp=True, use_flash_attention=True, use_fused_front=True)],
    ids=["fused_mlp", "all"])
def test_convmae_backward_on_the_card_reaches_every_parameter(cuda, flags):
    """loss.backward() of a card ConvMAE (full width, depth cut to one block
    a stage) through the kernels' Functions: every parameter, patch_embed1
    included, gets a finite gradient, within float32 summation order of the
    plain path's."""
    from multimodal_isic_tpu_torch.core.rng import generator
    from multimodal_isic_tpu_torch.models.convmae import ConvMAE, build_convmae
    cfg = dict(depths=(1, 1, 1), decoder_depth=1, norm_pix_loss=True)
    plain = build_convmae(generator(1, cuda), **cfg)
    kern = ConvMAE(**cfg, **flags).to(cuda)
    kern.load_state_dict(plain.state_dict())
    g = torch.Generator(device=cuda).manual_seed(12)
    imgs = torch.randn(2, 224, 224, 3, generator=g, device=cuda)
    draws = plain.masking(2, 0.75, generator(2, cuda))
    grads = {}
    before = fm.fused_ln_mlp_backward.launches
    for name, model in (("plain", plain), ("kernel", kern)):
        loss, _, _ = model(imgs, 0.75, masking=draws)
        loss.backward()
        grads[name] = dict(model.named_parameters())
    # one backward launch for each fused block (one a conv stage)
    assert fm.fused_ln_mlp_backward.launches == before + 2
    for k, p in grads["kernel"].items():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), k
        want = grads["plain"][k].grad
        rel = float((p.grad - want).norm() / want.norm().clamp_min(1e-30))
        assert rel <= 1e-3, (k, rel)
    assert float(grads["kernel"]["patch_embed1.proj.weight"].grad.norm()) > 0


def test_mbconv_kernels_refuse_autograd(cuda):
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn(2, 9, 9, 32, generator=g, device=cuda)
    we = torch.randn(32, 64, generator=g, device=cuda).requires_grad_()
    be = torch.randn(64, generator=g, device=cuda)
    wd = torch.randn(3, 3, 1, 64, generator=g, device=cuda)
    bd = torch.randn(64, generator=g, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        fd.expand_dw_silu_pool(x, we, be, wd, bd)
    with pytest.raises(RuntimeError, match="no backward"):
        fd.dw_silu_pool(x.requires_grad_(), wd[..., :32], bd[:32])
    with torch.inference_mode():
        y, pool = fd.expand_dw_silu_pool(x, we, be, wd, bd)
    assert not y.requires_grad and y.shape == (2, 9, 9, 64)
