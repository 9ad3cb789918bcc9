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
