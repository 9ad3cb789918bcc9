"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (with its reason) where no CUDA device is
present.  Run them on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

This file imports no JAX (and ``--noconftest`` skips the JAX conftest), so
it runs where JAX is not installed."""

import pytest
import torch

from multimodal_isic_tpu_torch.ops import fused_dwconv as fd

pytestmark = pytest.mark.cuda

# |err| <= atol + rtol·|plain|: f32 differs only in summation order (atomics
# in the pool); bf16 may flip one rounding of the expand output or y.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
POOL_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-3, 1e-3)}


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
