"""Port parity: the PyTorch fused MBConv serving functions
(``multimodal_isic_tpu_torch.ops.fused_dwconv``) against the JAX package's
Pallas kernels in interpret mode, on the CPU, where the port's wrappers run
their plain versions.  The CUDA kernels themselves are held against those
plain versions on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.ops import fused_dwconv as jfd
from multimodal_isic_tpu_torch.ops import fused_dwconv as tfd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


# same grid as tests/test_fused_dwconv.py; the JAX row tiles (t) exercise the
# Pallas multi-tile path, the port has no row-tile argument
@pytest.mark.parametrize("k,h,w,c,t", [(3, 13, 13, 40, None),
                                       (5, 9, 11, 24, None),
                                       (3, 12, 13, 40, 4),
                                       (5, 15, 9, 24, 5)])
def test_dw_silu_pool_matches_jax(rng, k, h, w, c, t):
    x = rng.randn(3, h, w, c).astype(np.float32)
    wd = (rng.randn(k, k, 1, c) * 0.2).astype(np.float32)
    bd = (rng.randn(c) * 0.1).astype(np.float32)
    yj, pj = jfd.dw_silu_pool(jnp.asarray(x), jnp.asarray(wd), jnp.asarray(bd),
                              row_tile=t, interpret=True)
    before = tfd.dw_silu_pool.launches
    yt, pt = tfd.dw_silu_pool(torch.from_numpy(x), torch.from_numpy(wd),
                              torch.from_numpy(bd))
    assert tfd.dw_silu_pool.launches == before  # CPU call: no kernel launch
    assert yt.dtype == torch.float32 and pt.dtype == torch.float32
    assert yt.shape == (3, h, w, c) and pt.shape == (3, c)
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(pt), _np(pj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,h,w,cin,cmid,t", [(3, 13, 13, 32, 192, None),
                                              (5, 9, 11, 48, 288, None),
                                              (3, 12, 13, 32, 192, 4),
                                              (5, 15, 9, 16, 96, 3)])
def test_expand_dw_silu_pool_matches_jax(rng, k, h, w, cin, cmid, t):
    x = rng.randn(2, h, w, cin).astype(np.float32)
    we = (rng.randn(1, 1, cin, cmid) * 0.1).astype(np.float32)
    be = (rng.randn(cmid) * 0.1).astype(np.float32)
    wd = (rng.randn(k, k, 1, cmid) * 0.2).astype(np.float32)
    bd = (rng.randn(cmid) * 0.1).astype(np.float32)
    yj, pj = jfd.expand_dw_silu_pool(*map(jnp.asarray, (x, we, be, wd, bd)),
                                     row_tile=t, interpret=True)
    before = tfd.expand_dw_silu_pool.launches
    yt, pt = tfd.expand_dw_silu_pool(*map(torch.from_numpy, (x, we, be, wd, bd)))
    assert tfd.expand_dw_silu_pool.launches == before
    # bias be outside the image must not leak into the halo: the border
    # pixels are where a pad-then-expand formulation would differ
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(pt), _np(pj), rtol=1e-5, atol=1e-5)


def test_expand_dw_bf16_matches_jax_loosely(rng):
    """bf16: both round the expand output and y to bf16 at the same places;
    summation order differs, so one bf16 ulp (2^-8 relative) may flip."""
    x = rng.randn(2, 13, 13, 32).astype(np.float32)
    we = (rng.randn(32, 192) * 0.1).astype(np.float32)
    be = (rng.randn(192) * 0.1).astype(np.float32)
    wd = (rng.randn(3, 3, 1, 192) * 0.2).astype(np.float32)
    bd = (rng.randn(192) * 0.1).astype(np.float32)
    yj, pj = jfd.expand_dw_silu_pool(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(we, jnp.bfloat16),
        jnp.asarray(be), jnp.asarray(wd, jnp.bfloat16), jnp.asarray(bd),
        interpret=True)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    yt, pt = tfd.expand_dw_silu_pool(bf(x), bf(we), torch.from_numpy(be),
                                     bf(wd), torch.from_numpy(bd))
    assert yt.dtype == torch.bfloat16 and pt.dtype == torch.float32
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(pt), _np(pj), rtol=1e-2, atol=1e-3)


def test_wrappers_reject_bad_input(rng):
    x = torch.zeros(1, 8, 8, 16)
    with pytest.raises(ValueError):
        tfd.dw_silu_pool(x, torch.zeros(7, 7, 1, 16), torch.zeros(16))
    with pytest.raises(ValueError):
        tfd.dw_silu_pool(x, torch.zeros(3, 3, 1, 8), torch.zeros(8))
    with pytest.raises(TypeError):
        tfd.dw_silu_pool(x.double(), torch.zeros(3, 3, 1, 16), torch.zeros(16))
    with pytest.raises(ValueError):
        tfd.expand_dw_silu_pool(x, torch.zeros(8, 32), torch.zeros(32),
                                torch.zeros(3, 3, 1, 32), torch.zeros(32))
    with pytest.raises(ValueError):
        tfd.expand_dw_silu_pool(x, torch.zeros(16, 32), torch.zeros(16),
                                torch.zeros(3, 3, 1, 32), torch.zeros(32))


def test_import_needs_no_nvcc_or_triton():
    """Importing the kernel module (and the model that uses it) builds
    nothing: no nvcc on PATH, triton never imported, no build directory
    touched."""
    code = ("import sys; import multimodal_isic_tpu_torch.ops.fused_dwconv, "
            "multimodal_isic_tpu_torch.models.efficientnet; "
            "assert 'triton' not in sys.modules; "
            "from multimodal_isic_tpu_torch.ops import _build; "
            "assert _build.load.cache_info().currsize == 0")
    env = dict(os.environ, PATH="/nonexistent", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _serving_geometries():
    """(kind, H, Cin, Cmid, K) of every stride-1 MBConv block of the B3@380
    serving forward (as ``chip_smoke.serving_geometries``), distinct."""
    from multimodal_isic_tpu_torch.models.efficientnet import block_args
    h, out = -(-380 // 2), []
    for expand, k, stride, cin, _ in block_args("efficientnet-b3"):
        if stride == 1:
            out.append(("dw" if expand == 1 else "expand", h, cin,
                        cin * expand, k))
        else:
            h = -(-h // stride)
    return sorted(set(out))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bsz", [1, 16, 128])
def test_mbconv_plan_fits_and_covers(bsz, dtype):
    """The card's launch plan at every serving geometry: a block's shared
    memory within the H100's 232,448 bytes (and the kernel's layout), row
    tiles and channel chunks that cover H and Cmid exactly once, and a pool
    path that matches the tile count."""
    esz = torch.finfo(dtype).bits // 8
    geos = _serving_geometries()
    assert len(geos) == 10
    for kind, h, cin, cmid, k in geos:
        plan = tfd.mbconv_plan(bsz, h, h, cin, cmid, k, dtype,
                               kind == "expand")
        cc, rows, n_tiles = plan["cc"], plan["rows"], plan["n_tiles"]
        assert plan["smem"] <= tfd.MAX_SMEM == 232448
        if kind == "expand":
            assert cc in (64, 128)
            assert plan["smem"] == tfd.expand_smem_bytes(rows, h, k, cin,
                                                         esz, cc)
            if cc == 64 and plan["smem"] > tfd.TWO_BLOCKS:
                # one block an SM only where two would leave < 4 rows
                assert tfd.expand_smem_bytes(min(h, 4), h, k, cin, esz,
                                             cc) > tfd.TWO_BLOCKS
        else:
            assert cc <= 64 and cc % (16 // esz) == 0
            assert plan["smem"] == tfd.dw_smem_bytes(cc, h, k, esz)
        assert (n_tiles - 1) * rows < h <= n_tiles * rows
        assert plan["n_chunks"] == -(-cmid // cc)
        assert (plan["n_chunks"] - 1) * cc < cmid <= plan["n_chunks"] * cc
        assert plan["pool"] == ("direct" if n_tiles == 1 else "partials")


def test_mbconv_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        tfd.mbconv_plan(1, 16, 4000, 32, 192, 5, torch.float32)


def test_wrapper_allocates_no_zeroed_pool():
    """The kernels write every pool entry (in the same order on every run),
    so the wrapper takes the pool and the partials from ``torch.empty``:
    there is no memset launch a call."""
    import inspect
    src = inspect.getsource(tfd._launch)
    assert "torch.zeros" not in src and "zero_" not in src
    assert "pool = torch.empty((bsz, c), dtype=torch.float32" in src
