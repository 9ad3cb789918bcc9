"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (with its reason) where no CUDA device is
present.  Run them on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

This file imports no JAX (and ``--noconftest`` skips the JAX conftest), so
it runs where JAX is not installed."""

import math

import pytest
import torch

from multimodal_isic_tpu_torch.ops import affine_warp as aw
from multimodal_isic_tpu_torch.ops import attention as attn
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
                                        (380, 380, (380, 380))])
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


def test_warp_kernel_rejects_what_it_cannot_take(cuda):
    imgs = torch.zeros(2, 8, 8, 3, device=cuda)
    inv = _affines([(0, 0, 1, 0)] * 2, 8, 8, cuda)
    with pytest.raises(ValueError):  # not contiguous
        aw.affine_warp_batch(imgs.transpose(1, 2), inv, (8, 8))
    with pytest.raises(ValueError):  # inv on another device
        aw.affine_warp_batch(imgs, inv.cpu(), (8, 8))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,n,d", [(2, 3, 196, 64), (3, 12, 49, 64),
                                     (2, 16, 196, 32), (1, 2, 1, 64),
                                     (2, 2, 300, 32)])
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
    # contiguous operands give the same result
    _close(attn.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous()), got, attn.TOL[dtype])


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


def test_fused_front_kernel_rejects_what_it_cannot_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(10)
    args = _front_args(g, 1, 8, 8, 192, torch.float32, cuda, False)
    with pytest.raises(ValueError, match="C in"):
        fcb.fused_front(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c,f", [(300, 384, 1536), (1000, 256, 1024),
                                   (77, 256, 96), (12544, 384, 1536)])
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
