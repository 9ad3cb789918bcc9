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


# The bare MLP's calls on the card (chip_smoke.mlp_geometries): ConvViT-Base's
# conv stages at bs 16 float32 and bs 128 bf16, and C2 != C at a ragged M.
GEOMETRIES = [(torch.float32, 16 * 56 * 56, 256, 1024, 256),
              (torch.float32, 16 * 28 * 28, 384, 1536, 384),
              (torch.bfloat16, 128 * 56 * 56, 256, 1024, 256),
              (torch.bfloat16, 128 * 28 * 28, 384, 1536, 384),
              (torch.float32, 1000, 128, 512, 256),
              (torch.bfloat16, 1000, 128, 512, 256)]


def _first_cut_smem(c, c2, dtype):
    """Shared memory of the first-cut kernel's block (rows 64 bf16 / 32
    float32, pad 8 / 4, F chunks of 32): the shapes it took, which the
    redesign must take too."""
    rows, pad = (64, 8) if dtype == torch.bfloat16 else (32, 4)
    esz = 2 if dtype == torch.bfloat16 else 4
    a16 = lambda n: (n + 15) & ~15  # noqa: E731
    return (a16(rows * (c + pad) * esz) + a16(32 * (c + pad) * esz)
            + a16(c2 * (32 + pad) * esz) + a16(rows * (32 + pad) * esz))


@pytest.mark.parametrize("geo", GEOMETRIES,
                         ids=lambda g: f"{str(g[0])[6:]}-{g[1]}-{g[2]}-{g[4]}")
def test_mlp_plan_at_the_geometries(geo):
    """Every row in one tile, F walked in whole chunks, a block's shared
    memory and a thread's sums within the card's limits; bf16 keeps at least
    96 columns of F in flight (chunks of 64 in two stages, or of 32 in three
    or more), 128-row tiles (64 rows a consumer warpgroup) where C2 <= 256
    and 64-row tiles split over C2 beyond."""
    dtype, m, c, f, c2 = geo
    p = tfm.mlp_plan(m, c, f, c2, dtype)
    assert p["tiles"] * p["bm"] >= m > (p["tiles"] - 1) * p["bm"]
    assert f % p["fc"] == 0 and p["smem"] <= tfm.SMEM_LIMIT
    assert p["smem"] == tfm.mlp_smem_bytes(c, c2, p["bm"], p["fc"],
                                           p["stages"], dtype)
    if dtype == torch.bfloat16:
        assert p["stages"] * p["fc"] >= 96 and p["stages"] >= 2
        assert (p["bm"], p["split"]) == ((128, 1) if c2 <= 256 else (64, 2))
        assert p["regs"] <= tfm.WG_CONSUMER_REGS - tfm.REG_MARGIN
    else:
        assert p["stages"] == 2 and p["bm"] == 64
        assert p["regs"] <= tfm.F32_MAX_REGS - tfm.REG_MARGIN


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c2", [128, 256, 384, 512])
def test_mlp_plan_takes_what_the_first_cut_took(dtype, c2):
    """The plan takes exactly the C the first-cut kernel took at each
    (C2, dtype), each with a configuration that fits one block; it refuses
    the others."""
    for c in range(128, 2049, 128):
        took = _first_cut_smem(c, c2, dtype) <= tfm.SMEM_LIMIT
        if took:
            p = tfm.mlp_plan(777, c, 512, c2, dtype)
            assert p["smem"] <= tfm.SMEM_LIMIT
            assert tfm.fused_mlp_smem_bytes(c, c2, dtype) == p["smem"]
        else:
            with pytest.raises(ValueError):
                tfm.mlp_plan(777, c, 512, c2, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_plans_are_the_librarys_configurations(dtype):
    """Every (C2, rows, F chunk) the plan gives over the shapes it takes is
    one the library instantiates (``csrc/fused_mlp.cu``'s MLP_PLANS_*)."""
    import re
    from pathlib import Path
    src = (Path(tfm.__file__).parents[1] / "csrc" / "fused_mlp.cu").read_text()
    macro = "MLP_PLANS_BF16" if dtype == torch.bfloat16 else "MLP_PLANS_F32"
    body = src.split(f"#define {macro}(X)")[1].split("\n\n")[0].split("#define")[0]
    built = {tuple(map(int, t)) for t in
             re.findall(r"X\((\d+), (\d+), (\d+)\)", body)}
    used = set()
    for c2 in tfm.MLP_C2:
        for c in range(128, tfm.MLP_C_MAX[(dtype, c2)] + 1, 128):
            for f in (128, 384, 1024, 1536):
                p = tfm.mlp_plan(300, c, f, c2, dtype)
                used.add((c2, p["bm"], p["fc"]))
    assert used <= built, used - built


def test_mlp_plan_refuses_what_no_configuration_takes():
    with pytest.raises(ValueError, match="C2 in"):
        tfm.mlp_plan(8, 128, 128, 640, torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        tfm.mlp_plan(8, 640, 128, 512, torch.float32)
    with pytest.raises(ValueError, match="F="):
        tfm.mlp_plan(8, 128, 200, 128, torch.float32)
