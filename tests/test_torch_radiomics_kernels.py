"""Port parity for the radiomics kernels' plain versions: GLCM counts
(``ops/glcm.py``), GLRLM run bookkeeping (``ops/glrlm_runs.py``), the joint
histogram (``ops/histogram.py``) and connected components
(``ops/connected_components.py``).  Each plain version is what the CUDA
kernel is held against on the card; here it is held against the JAX
package's Pallas kernel in interpret mode and against its XLA formulation,
on the same integer inputs.  All four compute integers, so every comparison
is exact (``assert_array_equal``).  Plus the wrappers' CPU behaviour: the
plain version runs, no launch is counted, bad arguments raise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.ops import texture as JT
from multimodal_isic_tpu.ops import texture_extra as JX
from multimodal_isic_tpu.ops.pallas_cc import connected_components_pallas
from multimodal_isic_tpu.ops.pallas_glcm import glcm_matrices_pallas
from multimodal_isic_tpu.ops.pallas_glrlm import glrlm_runs_pallas
from multimodal_isic_tpu.ops.pallas_hist import joint_histogram_pallas
from multimodal_isic_tpu_torch.ops import connected_components as tcc
from multimodal_isic_tpu_torch.ops import glcm as tglcm
from multimodal_isic_tpu_torch.ops import glrlm_runs as truns
from multimodal_isic_tpu_torch.ops import histogram as thist
from multimodal_isic_tpu_torch.ops import texture as TT
from tests.test_texture import _case, np_discretize

SIZES = [(14, 13), (45, 60), (40, 129)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _levels_case(rng, h, w, kind="roi", vmax=30):
    """(levels int32 [H, W], mask uint8 [H, W]) of one map: an ROI with a
    hole, the empty mask, the full frame, or a single gray level."""
    img, mask = _case(rng, h=h, w=w, vmax=vmax)
    if kind == "empty":
        mask[:] = 0
        return np.zeros((h, w), np.int32), mask
    if kind == "full":
        mask[:] = 255
    lv, _ = np_discretize(img, mask, 10.0)
    if kind == "single":
        lv = np.where(mask > 0, 3, 0)
    return lv.astype(np.int32), mask


def _batch(rng, h, w, kinds=("roi", "empty", "full", "single", "roi")):
    cases = [_levels_case(rng, h, w, k) for k in kinds]
    return (np.stack([c[0] for c in cases]), np.stack([c[1] for c in cases]))


# ------------------------------------------------------------------- GLCM

@pytest.mark.parametrize("hw", SIZES)
def test_glcm_plain_matches_pallas_and_xla(rng, hw):
    lv, mask = _batch(rng, *hw)
    got = tglcm.glcm_matrices_reference(torch.from_numpy(lv),
                                        torch.from_numpy(mask)).numpy()
    assert got.shape == (len(lv), 4, TT.NG, TT.NG) and got.dtype == np.float32
    for i in range(len(lv)):
        want = np.asarray(glcm_matrices_pallas(jnp.asarray(lv[i]),
                                               jnp.asarray(mask[i]),
                                               interpret=True))
        np.testing.assert_array_equal(got[i], want, err_msg=f"map {i}")
        xla = np.asarray(JT.glcm_matrices(jnp.asarray(lv[i]),
                                          jnp.asarray(mask[i])))
        np.testing.assert_array_equal(got[i], xla, err_msg=f"map {i}")


def test_glcm_wrapper_on_cpu_runs_plain_version(rng):
    lv, mask = _batch(rng, 14, 13)
    before = tglcm.glcm_matrices.launches
    got = tglcm.glcm_matrices(torch.from_numpy(lv), torch.from_numpy(mask) > 0)
    want = tglcm.glcm_matrices_reference(torch.from_numpy(lv),
                                         torch.from_numpy(mask))
    assert torch.equal(got, want)
    assert tglcm.glcm_matrices.launches == before
    with pytest.raises(ValueError):  # int64 levels
        tglcm.glcm_matrices(torch.from_numpy(lv).long(), torch.from_numpy(mask))
    with pytest.raises(ValueError):  # mask of another shape
        tglcm.glcm_matrices(torch.from_numpy(lv), torch.from_numpy(mask)[:, 1:])


# ------------------------------------------------------------ GLRLM runs

@pytest.mark.parametrize("hw", SIZES)
def test_glrlm_runs_plain_matches_pallas_and_xla(rng, hw):
    lv, mask = _batch(rng, *hw)
    ins = mask > 0
    got = truns.glrlm_runs_reference(torch.from_numpy(lv),
                                     torch.from_numpy(ins)).numpy()
    assert got.shape == (len(lv), 4, *hw) and got.dtype == np.int32
    for i in range(len(lv)):
        want = np.asarray(glrlm_runs_pallas(jnp.asarray(lv[i]),
                                            jnp.asarray(ins[i]),
                                            interpret=True))
        np.testing.assert_array_equal(got[i], want, err_msg=f"map {i}")
        start, gray, length = truns.unpack_runs(torch.from_numpy(got[i]))
        for a, (dy, dx) in enumerate(JT.ANGLES_2D):
            s, g, ln = (np.asarray(v) for v in JT.run_starts_and_lengths(
                jnp.asarray(lv[i]), jnp.asarray(ins[i]), dy, dx))
            np.testing.assert_array_equal(start[a].numpy(), s)
            np.testing.assert_array_equal(gray[a].numpy()[s], g[s])
            np.testing.assert_array_equal(length[a].numpy()[s], ln[s])


def test_glrlm_run_longer_than_max_len_saturates():
    """Runs of 16 with max_len 8 land in the top length bin, through the
    runs and the histogram, as the JAX XLA matrix does."""
    lv = np.ones((1, 2, 16), np.int32)
    mask = np.full((1, 2, 16), 255, np.uint8)
    got = TT.glrlm_matrices(torch.from_numpy(lv), torch.from_numpy(mask),
                            8).numpy()[0]
    for a, (dy, dx) in enumerate(JT.ANGLES_2D):
        want = np.asarray(JT.glrlm_matrix_for_angle(
            jnp.asarray(lv[0]), jnp.asarray(mask[0]) > 0, dy, dx, 8))
        np.testing.assert_array_equal(got[a], want, err_msg=f"angle {a}")
    assert got[0, 0, 7] == 2 and got[0].sum() == 2


def test_glrlm_runs_wrapper_on_cpu_and_size_check(rng):
    lv, mask = _batch(rng, 14, 13)
    before = truns.glrlm_runs.launches
    got = truns.glrlm_runs(torch.from_numpy(lv), torch.from_numpy(mask > 0))
    assert torch.equal(got, truns.glrlm_runs_reference(
        torch.from_numpy(lv), torch.from_numpy(mask > 0)))
    assert truns.glrlm_runs.launches == before
    with pytest.raises(ValueError):  # lengths would overflow 11 bits
        truns.glrlm_runs(torch.zeros((1, 2, 2048), dtype=torch.int32),
                         torch.zeros((1, 2, 2048), dtype=torch.bool))


# -------------------------------------------------------- joint histogram

@pytest.mark.parametrize("na,nb,n", [(9, 29, 5000), (64, 640, 3001)])
def test_joint_histogram_plain_matches_pallas(rng, na, nb, n):
    """Batched rows, codes beyond na / nb and 0 (all skipped)."""
    a = rng.randint(0, na + 3, (3, n)).astype(np.int32)
    b = rng.randint(0, nb + 5, (3, n)).astype(np.int32)
    got = thist.joint_histogram_reference(torch.from_numpy(a),
                                          torch.from_numpy(b), na, nb).numpy()
    assert got.shape == (3, na, nb) and got.dtype == np.float32
    for r in range(3):
        want = np.asarray(joint_histogram_pallas(jnp.asarray(a[r]),
                                                 jnp.asarray(b[r]), na, nb,
                                                 interpret=True))
        np.testing.assert_array_equal(got[r], want, err_msg=f"row {r}")
    ok = (a >= 1) & (a <= na) & (b >= 1) & (b <= nb)
    assert got.sum() == ok.sum()


def test_glrlm_matrices_match_jax_xla(rng):
    """Runs + histogram, batched over maps × angles, equal the JAX XLA
    matrices (``glrlm_matrix_for_angle``) map by map."""
    lv, mask = _batch(rng, 24, 31)
    got = TT.glrlm_matrices(torch.from_numpy(lv), torch.from_numpy(mask),
                            32).numpy()
    for i in range(len(lv)):
        for a, (dy, dx) in enumerate(JT.ANGLES_2D):
            want = np.asarray(JT.glrlm_matrix_for_angle(
                jnp.asarray(lv[i]), jnp.asarray(mask[i]) > 0, dy, dx, 32))
            np.testing.assert_array_equal(got[i, a], want,
                                          err_msg=f"map {i} angle {a}")


def test_joint_histogram_wrapper_on_cpu(rng):
    a = torch.from_numpy(rng.randint(0, 5, (2, 100)).astype(np.int32))
    before = thist.joint_histogram.launches
    got = thist.joint_histogram(a, a, 4, 4)
    assert torch.equal(got, thist.joint_histogram_reference(a, a, 4, 4))
    assert thist.joint_histogram.launches == before
    assert torch.equal(thist.library_joint_histogram(a, a, 4, 4), got)
    with pytest.raises(ValueError):  # int64 codes
        thist.joint_histogram(a.long(), a.long(), 4, 4)


# ------------------------------------------------- connected components

@pytest.mark.parametrize("hw", SIZES)
def test_cc_plain_matches_pallas_and_xla(rng, hw):
    lv, mask = _batch(rng, *hw)
    ins = mask > 0
    got = tcc.connected_components_reference(torch.from_numpy(lv),
                                             torch.from_numpy(ins)).numpy()
    assert got.dtype == np.int32
    for i in range(len(lv)):
        want = np.asarray(connected_components_pallas(
            jnp.asarray(lv[i]), jnp.asarray(ins[i]), interpret=True))
        np.testing.assert_array_equal(got[i], want, err_msg=f"map {i}")
        xla = np.asarray(JX.connected_components(jnp.asarray(lv[i]),
                                                 jnp.asarray(ins[i])))
        np.testing.assert_array_equal(got[i], xla, err_msg=f"map {i}")
    assert (got[1] == hw[0] * hw[1]).all()   # empty mask: all outside
    assert (got[3][ins[3]] == np.argmax(ins[3].reshape(-1))).all()


def serpentine(h, w):
    """Boustrophedon snake of level 7 on level 2 (tests/test_pallas_cc.py):
    one long geodesic that bends every row."""
    levels = np.full((h, w), 2, np.int32)
    snake = np.zeros((h, w), bool)
    snake[0::2, :] = True
    for r in range(1, h, 2):
        snake[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    levels[snake] = 7
    return levels, snake


def test_cc_serpentine_is_one_zone():
    levels, snake = serpentine(40, 41)
    ins = np.ones_like(snake)
    got = tcc.connected_components_reference(
        torch.from_numpy(levels)[None], torch.from_numpy(ins)[None]).numpy()[0]
    assert np.unique(got[snake]).size == 1
    assert int(snake.sum()) == int((got == got[snake][0]).sum())
    want = np.asarray(connected_components_pallas(
        jnp.asarray(levels), jnp.asarray(ins), interpret=True))
    np.testing.assert_array_equal(got, want)


def test_cc_wrapper_on_cpu(rng):
    lv, mask = _batch(rng, 14, 13)
    before = tcc.connected_components.launches
    got = tcc.connected_components(torch.from_numpy(lv),
                                   torch.from_numpy(mask > 0))
    assert torch.equal(got, tcc.connected_components_reference(
        torch.from_numpy(lv), torch.from_numpy(mask > 0)))
    assert tcc.connected_components.launches == before
    with pytest.raises(ValueError):  # float levels
        tcc.connected_components(torch.from_numpy(lv).float(),
                                 torch.from_numpy(mask > 0))
