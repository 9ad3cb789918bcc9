"""The radiomics slice end to end on the CPU: the port's
``RadiomicsExtractor(device="cpu").extract_channels_batch`` against the JAX
package's ``RadiomicsExtractor`` on three seeded 32×40 rendered lesions with
their masks — the 4,872 column names in order, and every value.

Tolerance, |port − jax| ≤ rtol·|jax| + atol, rtol 1e-5 (float32 sums in
another order), and an atol per feature on the scale of the terms it is
computed from:
- 1e-5 × the derived image's own scale (max |Minimum|, |Maximum| of that map)
  for the first-order intensity features: the filter bank agrees with JAX to
  a few float32 ulps of the image (XLA's approximate CPU sqrt/log/exp and its
  fma contraction), and LoG means, minima and medians sit near 0;
- 1e-4 for Skewness and Kurtosis (third and fourth central moments, which
  cancel), 1e-4 for ClusterShade (signed cubes), 2e-5 for Imc1/Imc2
  (entropy differences through XLA's approximate log2), 1e-6 for
  Correlation;
- MCC, 1e-4; where the JAX power iteration starts orthogonal to the second
  eigenvector (equal marginals, e.g. a two-level map) JAX returns 0 for that
  angle, and the port is held against the float64 eigenvalue instead.
The integer stages are exact: the derived images' levels must equal JAX's
(a level one ulp across a bin edge would change every count, and the test
says so rather than passing on a looser tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.analysis import radiomics as JR
from multimodal_isic_tpu.ops import filters as JF
from multimodal_isic_tpu.ops import texture as JT
from multimodal_isic_tpu_torch.analysis import radiomics as TR
from multimodal_isic_tpu_torch.data.synthetic import _render_sample
from multimodal_isic_tpu_torch.ops import filters as TF
from multimodal_isic_tpu_torch.ops import glcm as TG
from multimodal_isic_tpu_torch.ops import texture as TT

MAX_LEN = 64
RTOL = 1e-5
ATOL = {"Skewness": 1e-4, "Kurtosis": 1e-4, "ClusterShade": 1e-4,
        "Imc1": 2e-5, "Imc2": 2e-5, "Correlation": 1e-6, "MCC": 1e-4}
INTENSITY = {"Energy", "TotalEnergy", "Minimum", "10Percentile",
             "90Percentile", "Maximum", "Mean", "Median", "InterquartileRange",
             "Range", "MeanAbsoluteDeviation", "RobustMeanAbsoluteDeviation",
             "RootMeanSquared", "Variance"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def slice_run():
    rng = np.random.RandomState(0)
    imgs, masks = zip(*[_render_sample(rng, 32, 40, c) for c in (0, 4, 5)])
    rgb, masks = np.stack(imgs), np.stack(masks)
    want = JR.RadiomicsExtractor(glrlm_max_len=MAX_LEN).extract_channels_batch(
        rgb, masks)
    ex = TR.RadiomicsExtractor(glrlm_max_len=MAX_LEN, device="cpu")
    got = ex.extract_channels_batch(rgb, masks)
    return rgb, masks, ex, got, want


def _channel_maps(rgb, masks):
    """The extractor's [B·4, H, W] channel maps and masks, numpy."""
    c = rgb.astype(np.int64)
    gray = JR._bt601_gray(c[..., 0], c[..., 1], c[..., 2])
    chans = np.stack([gray, c[..., 0], c[..., 1], c[..., 2]], 1)
    b, _, h, w = chans.shape
    m = np.repeat((masks == 255)[:, None].astype(np.uint8) * 255, 4, axis=1)
    return (chans.reshape(b * 4, h, w).astype(np.float32),
            m.reshape(b * 4, h, w))


def test_derived_image_levels_match_jax(slice_run):
    rgb, masks, *_ = slice_run
    chans, m = _channel_maps(rgb, masks)
    jbank = jax.jit(jax.vmap(JF.filter_bank))(jnp.asarray(chans))
    tbank = TF.filter_bank(torch.from_numpy(chans))
    for t in sorted(jbank):
        jlv, jn, _ = jax.vmap(lambda a, b: JT.discretize(a, b, 10.0))(
            jbank[t], jnp.asarray(m))
        tlv, tn, _ = TT.discretize(tbank[t], torch.from_numpy(m), 10.0)
        np.testing.assert_array_equal(tlv.numpy(), np.asarray(jlv), err_msg=t)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn), err_msg=t)


def test_columns_identical_and_in_order(slice_run):
    *_, ex, got, want = slice_run
    cols, vals = TR.features_to_frame(got)
    assert cols == list(JR.features_to_frame(want).columns)
    assert len(cols) == 4872 and vals.shape == (3, 4872)
    assert vals.dtype == np.float64
    assert list(got[0]) == list(TR.CHANNELS)
    assert list(got[0]["red"]) == ex.feature_names()


def _mcc_oracle(rgb, masks, derived, channel, image):
    """MCC of one map from float64 eigenvalues of Q (pyradiomics' definition)
    on the port's own GLCM."""
    chans, m = _channel_maps(rgb, masks)
    i = image * 4 + list(TR.CHANNELS).index(channel)
    img = TF.filter_bank(torch.from_numpy(chans[i:i + 1]))[derived]
    lv, n, _ = TT.discretize(img, torch.from_numpy(m[i:i + 1]), 10.0)
    ng = int(n[0])
    if ng <= 1:
        return 1.0
    raw = TG.glcm_matrices_reference(lv, torch.from_numpy(m[i:i + 1]))[0]
    out = []
    for P in raw.double().numpy():
        p = P[:ng, :ng] / max(P.sum(), 1.0)
        px, py = p.sum(1), p.sum(0)
        q = (p / np.where(px > 0, px, 1)[:, None]) @ (
            p / np.where(py > 0, py, 1)[None, :]).T
        eig = np.sort(np.linalg.eigvals(q).real)
        out.append(np.sqrt(np.clip(eig[-2], 0.0, 1.0)))
    return float(np.mean(out))


def test_every_value_matches_jax(slice_run):
    rgb, masks, _, got, want = slice_run
    bad = []
    for bi in range(len(got)):
        for ch in TR.CHANNELS:
            g, w = got[bi][ch], want[bi][ch]
            for name, v in g.items():
                ref = w[name]
                if np.isnan(ref) or np.isnan(v):
                    if not (np.isnan(ref) and np.isnan(v)):
                        bad.append((bi, ch, name, v, ref))
                    continue
                derived, cls, feat = name.split("_", 2)
                atol = ATOL.get(feat, 0.0)
                if cls == "firstorder" and feat in INTENSITY:
                    scale = max(abs(w[f"{derived}_firstorder_Minimum"]),
                                abs(w[f"{derived}_firstorder_Maximum"]))
                    atol = 1e-5 * scale
                if abs(v - ref) <= RTOL * abs(ref) + atol:
                    continue
                if feat == "MCC":
                    exact = _mcc_oracle(rgb, masks, derived, ch, bi)
                    if abs(v - exact) <= 2e-3 < abs(ref - exact):
                        continue
                bad.append((bi, ch, name, v, ref))
    assert not bad, bad[:20]


def test_shape2d_is_identical_across_channels(slice_run):
    *_, got, _ = slice_run
    for res in got:
        for k, v in res["grayscale"].items():
            if "_shape2D_" in k:
                assert all(res[ch][k] == v for ch in TR.CHANNELS), k
