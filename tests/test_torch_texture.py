"""Port parity for the radiomics feature classes and the filter bank:
``ops/texture.py`` (discretize, first order, GLCM, GLRLM),
``ops/texture_extra.py`` (GLSZM, GLDM, NGTDM, shape2D) and ``ops/filters.py``
against the JAX package on the same inputs.  The texture classes get the
same ``levels`` on both sides (JAX's own ``discretize`` output, which the
port's must equal exactly), so they differ only in float summation order.

Tolerances, |port − jax| ≤ atol + rtol·|jax|:
- default rtol 1e-5: float32 sums over up to 64×640 bins or H·W pixels in
  another order (measured ≤ 5e-6);
- features that subtract nearly equal sums get an atol on the scale of the
  terms they cancel: Skewness, Correlation and Imc1/Imc2 (entropy
  differences, also through XLA's approximate log2) and ClusterShade (signed
  cubes, rtol 1e-4);
- the filter bank: XLA's CPU sqrt/log/exp/rsqrt are not correctly rounded
  and XLA contracts a·b + c into fma in fused elementwise code, so outputs
  agree to a few float32 ulps (rtol 4e-6, plus atol 1e-4·max|x| for LoG
  values near 0); the wavelet taps, which the port accumulates in XLA's
  fused-multiply-add order, agree bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.ops import filters as JF
from multimodal_isic_tpu.ops import texture as JT
from multimodal_isic_tpu.ops import texture_extra as JX
from multimodal_isic_tpu_torch.ops import filters as TF
from multimodal_isic_tpu_torch.ops import texture as TT
from multimodal_isic_tpu_torch.ops import texture_extra as TX
from tests.test_texture import _case

RTOL = 1e-5
# (rtol, atol) where the default does not hold, with the reason above
TOL = {
    ("firstorder", "Skewness"): (1e-5, 1e-6),
    ("glcm", "ClusterShade"): (1e-4, 1e-4),
    ("glcm", "Correlation"): (1e-5, 1e-6),
    ("glcm", "Imc1"): (1e-5, 1e-5),
    ("glcm", "Imc2"): (1e-5, 2e-5),
}
MAX_LEN = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _maps():
    """[M, 30, 33] images and masks: ROIs with and without a hole over
    narrow (6 levels), wide (20), saturating (> NG·bin_width) and 3-level
    ranges; a single gray level; an empty mask; a full frame with negative
    values."""
    rng = np.random.RandomState(0)
    imgs, masks = [], []
    for vmax in (60, 200, 700, 25):
        for k in range(3):
            im, m = _case(rng, h=30, w=33, vmax=vmax, hole=bool(k % 2))
            imgs.append(im)
            masks.append(m)
    imgs.append(np.full((30, 33), 5.0, np.float32))
    masks.append(np.full((30, 33), 255, np.uint8))
    imgs.append((rng.rand(30, 33) * 100).astype(np.float32))
    masks.append(np.zeros((30, 33), np.uint8))
    imgs.append((rng.randn(30, 33) * 40).astype(np.float32))
    masks.append(np.full((30, 33), 255, np.uint8))
    return np.stack(imgs), np.stack(masks)


def _jax_bundle(img, mask):
    lv, n, low = JT.discretize(img, mask, 10.0)
    return {
        "levels": lv, "n_levels": n, "low": low,
        "firstorder": JT.firstorder_features(img, mask, 10.0),
        "glcm": JT.glcm_features(lv, mask, n, 10.0, low),
        "glrlm": JT.glrlm_features(lv, mask, n, MAX_LEN),
        "glszm": JX.glszm_features(lv, mask, n),
        "gldm": JX.gldm_features(lv, mask, n),
        "ngtdm": JX.ngtdm_features(lv, mask, n),
        "shape2D": JX.shape2d_features(mask),
    }


@pytest.fixture(scope="module")
def case():
    imgs, masks = _maps()
    want = jax.jit(jax.vmap(_jax_bundle))(jnp.asarray(imgs),
                                          jnp.asarray(masks))
    want = jax.tree_util.tree_map(np.array, want)   # writable copies
    return imgs, masks, want


def _port_class(name, imgs, masks, levels, n_levels):
    img, m = torch.from_numpy(imgs), torch.from_numpy(masks)
    lv, n = torch.from_numpy(levels), torch.from_numpy(n_levels)
    if name == "firstorder":
        return TT.firstorder_features(img, m, 10.0)
    if name == "glcm":
        return TT.glcm_features(lv, m, n)
    if name == "glrlm":
        return TT.glrlm_features(lv, m, n, MAX_LEN)
    if name == "glszm":
        return TX.glszm_features(lv, m, n)
    if name == "gldm":
        return TX.gldm_features(lv, m, n)
    if name == "ngtdm":
        return TX.ngtdm_features(lv, m, n)
    return TX.shape2d_features(m)


def test_discretize_matches_jax(case):
    imgs, masks, want = case
    lv, n, low = TT.discretize(torch.from_numpy(imgs), torch.from_numpy(masks),
                               10.0)
    np.testing.assert_array_equal(lv.numpy(), want["levels"])
    np.testing.assert_array_equal(n.numpy(), want["n_levels"])
    np.testing.assert_array_equal(low.numpy(), want["low"])
    assert n.numpy()[13] == np.iinfo(np.int32).min   # the empty mask


@pytest.mark.parametrize("name", ["firstorder", "glcm", "glrlm", "glszm",
                                  "gldm", "ngtdm", "shape2D"])
def test_feature_class_matches_jax(case, name):
    imgs, masks, want = case
    got = _port_class(name, imgs, masks, want["levels"], want["n_levels"])
    assert sorted(got) == sorted(want[name])
    for k, v in got.items():
        assert v.shape == (len(imgs),) and v.dtype == torch.float32, k
        rtol, atol = TOL.get((name, k), (RTOL, 0.0))
        np.testing.assert_allclose(v.numpy(), want[name][k], rtol=rtol,
                                   atol=atol, equal_nan=True,
                                   err_msg=f"{name}_{k}")


def test_percentiles_and_nan_conventions(case):
    """Linear-interpolation percentiles over the ROI (an even count, an odd
    one, one pixel, none), checked against numpy too."""
    imgs, masks, _ = case
    img = imgs[:4].copy()
    m = np.zeros_like(masks[:4])
    m[0, 2:12, 3:9] = 255          # 60 pixels
    m[1, 2:9, 3:10] = 255          # 49 pixels
    m[2, 5, 5] = 255               # one pixel
    got = TT.firstorder_features(torch.from_numpy(img), torch.from_numpy(m),
                                 10.0)
    want = jax.vmap(lambda a, b: JT.firstorder_features(a, b, 10.0))(
        jnp.asarray(img), jnp.asarray(m))
    for k in ("10Percentile", "90Percentile", "Median", "InterquartileRange",
              "RobustMeanAbsoluteDeviation", "Entropy", "Minimum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, equal_nan=True, err_msg=k)
    for i in range(3):
        vals = img[i][m[i] > 0].astype(np.float64)
        np.testing.assert_allclose(got["10Percentile"][i].item(),
                                   np.percentile(vals, 10), rtol=1e-5)
    assert np.isnan(got["Median"][3].item())   # empty ROI
    assert got["RobustMeanAbsoluteDeviation"][3].item() == 0.0


def test_filter_bank_matches_jax():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (3, 32, 40)).astype(np.float32)
    img[1] = rng.randn(32, 40).astype(np.float32) * 30   # negative values
    img[2] = 0.0                                          # flat zero
    want = jax.jit(jax.vmap(JF.filter_bank))(jnp.asarray(img))
    got = TF.filter_bank(torch.from_numpy(img))
    assert sorted(got) == sorted(want) and len(got) == 13
    for k, v in got.items():
        w = np.asarray(want[k])
        assert v.shape == w.shape and v.dtype == torch.float32, k
        if k == "original" or k.startswith("wavelet"):
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
        else:
            scale = np.abs(w).max(axis=(1, 2), keepdims=True)
            np.testing.assert_allclose(v.numpy(), w, rtol=4e-6,
                                       atol=1e-4 * scale.max(), err_msg=k)


def _mcc_float64(levels, n_levels):
    """pyradiomics' MCC from float64 eigenvalues, averaged over angles."""
    from multimodal_isic_tpu_torch.ops.glcm import glcm_matrices_reference
    raw = glcm_matrices_reference(torch.from_numpy(levels)[None],
                                  torch.from_numpy(levels > 0)[None])[0]
    out = []
    for P in raw.double().numpy():
        p = P[:n_levels, :n_levels] / P.sum()
        px, py = p.sum(1), p.sum(0)
        q = (p / px[:, None]) @ (p / py[None, :]).T
        out.append(np.sqrt(np.clip(np.sort(np.linalg.eigvals(q).real)[-2],
                                   0.0, 1.0)))
    return float(np.mean(out))


def test_mcc_where_the_jax_start_vanishes():
    """Two levels in alternate rows: every angle's GLCM has equal marginals,
    the JAX start vector has no component along the second eigenvector and
    JAX's MCC is 0 (ROADMAP C5); the port restarts and gives pyradiomics'
    value.  A GLCM whose start vanishes exactly exercises the restart."""
    lv = np.where(np.arange(12)[:, None] % 2 == 0, 2, 1) * np.ones((1, 16))
    lv = lv.astype(np.int32)
    mask = np.full(lv.shape, 255, np.uint8)
    want = _mcc_float64(lv, 2)
    jax_mcc = float(JT.glcm_features(jnp.asarray(lv), jnp.asarray(mask),
                                     jnp.int32(2), 10.0, 0.0)["MCC"])
    got = TT.glcm_features(torch.from_numpy(lv)[None],
                           torch.from_numpy(mask)[None],
                           torch.tensor([2], dtype=torch.int32))["MCC"]
    assert jax_mcc == 0.0 and want > 0.99
    assert abs(float(got[0]) - want) < 1e-5

    P = np.zeros((TT.NG, TT.NG), np.float32)
    P[:4, :4] = [[2, 1, 0, 0], [1, 0, 2, 0], [0, 2, 0, 1], [0, 0, 1, 2]]
    p = torch.from_numpy(P / P.sum())[None]
    q = (P[:4, :4] / 3.0).astype(np.float64)   # px = py = 1/4
    lam2 = np.sort(np.linalg.eigvals(q @ q.T).real)[-2]
    got = TT._mcc(p, p.sum(-1), p.sum(-2))
    assert abs(float(got[0]) - np.sqrt(lam2)) < 1e-5
