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
