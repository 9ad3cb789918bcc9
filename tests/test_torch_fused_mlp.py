"""Port parity for the bare fused MLP (``ops/fused_mlp.py::fused_mlp``): its
plain version, which the CUDA kernel is held against on the card, against
the JAX package's Pallas ``fused_mlp`` in interpret mode on the same seeded
inputs, forward in float32 and bfloat16 (C2 = C and C2 ≠ C, M not a multiple
of the 512-row block), and the gradients of the port's autograd Function
against ``jax.vjp`` of the Pallas function in float32.  Plus the wrapper's
CPU behaviour and what it refuses.

Tolerances: the forward is held to ``fused_mlp.TOL`` (the kernel-vs-plain
table): the two differ in summation order and in the erf (A&S 7.1.26,
|err| 1.5e-7, in the Pallas kernel; exact here), which in bf16 may flip one
rounding of h or of the output.  The gradients (float32, both recomputing
the plain MLP) to the JAX package's own fused-vs-reference gradient
tolerance, ``tests/test_fused_mlp.py`` (rtol 2e-4, atol 2e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from multimodal_isic_tpu_torch.ops import fused_mlp as tfm

GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
# (M, C, F, C2): M not a multiple of the 512-row block; C2 = C and C2 != C
SHAPES = [(300, 128, 256, 128), (200, 128, 512, 256)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, m, c, f, c2):
    """x [M, C] and the MLP's weights as numpy float32, from a seed."""
    rng = np.random.RandomState(seed)
    return (rng.randn(m, c).astype(np.float32),
            (rng.randn(c, f) / np.sqrt(c)).astype(np.float32),
            (0.1 * rng.randn(f)).astype(np.float32),
            (rng.randn(f, c2) / np.sqrt(f)).astype(np.float32),
            (0.1 * rng.randn(c2)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["c2_eq_c", "c2_ne_c"])
def test_fused_mlp_plain_matches_pallas(dtype, shape):
    args = _inputs(1, *shape)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_fused_mlp(*(jnp.asarray(a, jdt) for a in args),
                         interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    got = tfm.fused_mlp_reference(*(torch.from_numpy(a).to(tdt)
                                    for a in args))
    assert got.dtype == tdt and got.shape == (shape[0], shape[3])
    atol, rtol = tfm.TOL[tdt]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


def test_fused_mlp_gradients_match_jax_vjp():
    args = _inputs(2, 300, 128, 256, 256)
    g = np.random.RandomState(3).randn(300, 256).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jax_fused_mlp(*a, interpret=True),
                       *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    got_out = tfm.fused_mlp(*leaves)
    assert got_out.grad_fn is not None
    got = torch.autograd.grad(got_out, leaves, torch.from_numpy(g))
    torch.testing.assert_close(got_out.detach(),
                               torch.from_numpy(np.array(out)),
                               atol=tfm.TOL[torch.float32][0],
                               rtol=tfm.TOL[torch.float32][1])
    for name, a, b in zip(("x", "w1", "b1", "w2", "b2"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **GRAD_TOL)


def test_wrapper_on_cpu_runs_plain_version():
    args = [torch.from_numpy(a) for a in _inputs(4, 37, 128, 256, 256)]
    before = tfm.fused_mlp.launches
    got = tfm.fused_mlp(*args)
    assert tfm.fused_mlp.launches == before
    assert torch.equal(got, tfm.fused_mlp_reference(*args))


@pytest.mark.parametrize("dims", [(100, 256, 128), (128, 200, 128),
                                  (128, 256, 100)],
                         ids=["c", "f", "c2"])
def test_fused_mlp_rejects_unaligned_dims(dims):
    c, f, c2 = dims
    with pytest.raises(ValueError, match="lane-aligned"):
        tfm.fused_mlp(torch.zeros(8, c), torch.zeros(c, f), torch.zeros(f),
                      torch.zeros(f, c2), torch.zeros(c2))


def test_fused_mlp_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        tfm.fused_mlp(torch.zeros(8, 128), torch.zeros(128, 256),
                      torch.zeros(128), torch.zeros(256, 128),
                      torch.zeros(128))
    with pytest.raises(ValueError):
        tfm.fused_mlp(torch.zeros(8, 128), torch.zeros(256, 256),
                      torch.zeros(256), torch.zeros(256, 128),
                      torch.zeros(128))


@pytest.mark.parametrize("c,c2,dtype,ok", [
    (384, 384, torch.float32, True), (512, 512, torch.float32, True),
    (640, 512, torch.float32, False), (896, 512, torch.bfloat16, True),
    (1024, 512, torch.bfloat16, False), (256, 640, torch.bfloat16, False)])
def test_kernel_shape_limits(c, c2, dtype, ok):
    """The card's kernel: C2 in MLP_C2 (registers), the block's shared
    memory within SMEM_LIMIT (C)."""
    if ok:
        tfm.check_mlp_kernel_shape(c, c2, dtype)
        assert tfm.fused_mlp_smem_bytes(c, c2, dtype) <= tfm.SMEM_LIMIT
    else:
        with pytest.raises(ValueError):
            tfm.check_mlp_kernel_shape(c, c2, dtype)
