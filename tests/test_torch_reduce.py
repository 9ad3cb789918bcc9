"""Port parity for the radiomics host side: the feature reduction
(``analysis/reduce.py``, ``cli/reduce_dim.py``) and the extraction from files
on disk (``analysis/radiomics.py``'s path-based APIs,
``cli/extract_radiomics.py``) against the JAX package on the CPU.

Tolerances:
- FISTA, W and b: |port − jax| ≤ 5e-5 + 1e-4·|jax| (float32 products in
  another order through 300 steps; 4.5e-6 measured on coefficients up to
  3.5), and each float32 solve within the same of the float64 one (1.6e-5
  measured on coefficients up to 2.3);
- the host stages (variance filter, standardisation, correlation drop):
  bit for bit (the same numpy float64 in both packages);
- the selection: the same kept columns, and every feature's importance at
  least 10× the port-vs-JAX drift away from the 1e-5 threshold (asserted,
  so a feature that could flip says so instead of passing by luck);
- the extracted frames: ``test_torch_radiomics_slice.py``'s tolerances,
  both packages decoding with the native decoder.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from multimodal_isic_tpu.analysis import radiomics as JRad
from multimodal_isic_tpu.analysis import reduce as JR
from multimodal_isic_tpu_torch.analysis import radiomics as TRad
from multimodal_isic_tpu_torch.analysis import reduce as TR
from multimodal_isic_tpu_torch.cli import extract_radiomics as tex
from multimodal_isic_tpu_torch.cli import prepare_df as tprep
from multimodal_isic_tpu_torch.cli import reduce_dim as tred
from multimodal_isic_tpu_torch.core.config import config_from_dict
from multimodal_isic_tpu_torch.data import native_io
from multimodal_isic_tpu_torch.data.synthetic import make_synthetic_isic
from tests.test_torch_radiomics_slice import ATOL, INTENSITY, RTOL

FISTA_TOL = dict(rtol=1e-4, atol=5e-5)
N, K = 120, 7
CHANNEL_TAGS = ("_gs", "_red", "_green", "_blue")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed=0, n=N, d=40, k=K):
    """Seeded standardised X [n, d] with 5 informative features, labels
    cycling over k classes, balanced sample weights."""
    rng = np.random.RandomState(seed)
    y = np.arange(n) % k
    X = rng.randn(n, d)
    X[:, :5] += 1.5 * (y[:, None] == np.arange(5)[None])
    X = (X - X.mean(0)) / X.std(0)
    sw = n / (k * np.bincount(y)[y])
    return X, y, sw


@functools.lru_cache(maxsize=1)
def _frames():
    """Radiomics-like frames: 4 channels × 12 features (suffixed as the
    extractor's), 120 train and 40 test rows, 7 classes, 6 informative
    features; two near-constant columns (variance below 1e-3) and two
    near-copies (|ρ| > 0.95).  The selection keeps 35 of the 46 features
    left after the variance filter, the smallest kept importance 1.2e-3,
    the solvers' drift 2.7e-7."""
    rng = np.random.RandomState(3)
    y = np.arange(N) % K
    names = [f"original_firstorder_F{i}{tag}" for tag in CHANNEL_TAGS
             for i in range(12)]
    tr = rng.randn(N, len(names)) * rng.uniform(0.5, 3.0, len(names)) + 2.0
    tr[:, :6] += 6.0 * (y[:, None] == np.arange(6)[None])
    te = rng.randn(40, len(names)) * 1.5 + 2.0
    tr[:, 13] = 0.5 + 0.01 * rng.randn(N)
    tr[:, 30] = 3.0
    tr[:, 20] = tr[:, 1] * 2.0 + 0.05 * rng.randn(N)
    tr[:, 40] = -tr[:, 2] + 0.05 * rng.randn(N)
    return (pd.DataFrame(tr, columns=names),
            pd.DataFrame(te, columns=names), y)


def _jax_fista(X, Y, sw, C):
    if np.ndim(C) == 1 and len(C) != Y.shape[0]:  # a grid: vmap over C
        fit = jax.vmap(lambda C: JR._fista_l1_logistic(
            jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32),
            jnp.asarray(sw, jnp.float32), C, 300))
        W, b = fit(jnp.asarray(C, jnp.float32))
    else:
        W, b = JR._fista_l1_logistic(
            jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32),
            jnp.asarray(sw, jnp.float32), jnp.asarray(C, jnp.float32), 300)
    return np.asarray(W), np.asarray(b)


@pytest.mark.parametrize("C", ["grid", "per_class"])
def test_fista_matches_jax(C):
    """The batched solve on X [120, 40], 7 one-vs-rest classes: a 3-point C
    grid (every class at each C) and a C per class (the final fit)."""
    X, y, sw = _problem()
    Y = np.stack([np.where(y == c, 1.0, -1.0) for c in range(K)])
    Cs = (np.array([0.05, 0.3, 2.0]) if C == "grid"
          else np.logspace(-1.5, 0.5, K))
    Wj, bj = _jax_fista(X, Y, sw, Cs)
    C_t = torch.tensor(Cs, dtype=torch.float32)
    W, b = TR._fista_l1_logistic(
        torch.tensor(X, dtype=torch.float32),
        torch.tensor(Y, dtype=torch.float32),
        torch.tensor(sw, dtype=torch.float32),
        C_t[:, None] if C == "grid" else C_t, 300)
    assert W.shape == Wj.shape and b.shape == bj.shape
    np.testing.assert_allclose(W.numpy(), Wj, **FISTA_TOL)
    np.testing.assert_allclose(b.numpy(), bj, **FISTA_TOL)
    assert 0 < (Wj == 0).sum() < Wj.size  # the L1 penalty zeroes some


def test_fista_float64_runs_the_same_steps():
    """The solve in float64 (the chip smoke's reference for the card's
    float32 solve): float64 out, the momentum weights in float64, and the
    port's and JAX's float32 solves within FISTA_TOL of it."""
    X, y, sw = _problem()
    Y = np.stack([np.where(y == c, 1.0, -1.0) for c in range(K)])
    Cs = np.logspace(-1.5, 0.5, K)
    W64, b64 = TR._fista_l1_logistic(*map(torch.tensor, (X, Y, sw, Cs)), 300)
    assert W64.dtype == b64.dtype == torch.float64
    W32, b32 = TR._fista_l1_logistic(
        *(torch.tensor(a, dtype=torch.float32) for a in (X, Y, sw, Cs)), 300)
    Wj, bj = _jax_fista(X, Y, sw, Cs)
    for W, b in ((W32.numpy(), b32.numpy()), (Wj, bj)):
        np.testing.assert_allclose(W, W64.numpy(), **FISTA_TOL)
        np.testing.assert_allclose(b, b64.numpy(), **FISTA_TOL)
    b_32, b_64 = TR._fista_betas(300), TR._fista_betas(300, np.float64)
    assert b_32 != b_64
    np.testing.assert_allclose(b_32, b_64, rtol=1e-6)


@pytest.mark.parametrize("stage", ["variance", "normalize", "correlated"])
def test_host_stages_bit_for_bit(stage):
    tr, te, _ = _frames()
    if stage == "variance":
        got, want = (TR.filter_low_variance(tr, te, 1e-3),
                     JR.filter_low_variance(tr, te, 1e-3))
        assert got[0].shape[1] == tr.shape[1] - 2
    elif stage == "normalize":
        got, want = (TR.normalize_features(tr, te),
                     JR.normalize_features(tr, te))
    else:
        norm = TR.normalize_features(*TR.filter_low_variance(tr, te))[0]
        (g, g_drop), (w, w_drop) = (TR.drop_correlated_features(norm),
                                    JR.drop_correlated_features(norm))
        assert g_drop == w_drop and len(g_drop) >= 2
        got, want = (g,), (w,)
    for a, b in zip(got, want):
        assert list(a.columns) == list(b.columns)
        np.testing.assert_array_equal(a.values, b.values)


def test_lasso_select_matches_jax():
    """The kept columns equal JAX's, with every feature's importance far
    from the threshold relative to the two solvers' drift."""
    tr, te, y = _frames()
    tr, te = TR.normalize_features(*TR.filter_low_variance(tr, te))
    imp, best_C = TR.lasso_importance(tr.values, y, device="cpu")
    got_tr, got_te = TR.lasso_select(tr, y, te, device="cpu")
    want_tr, want_te = JR.lasso_select(tr, y, te)
    assert list(got_tr.columns) == list(want_tr.columns)
    assert list(got_te.columns) == list(want_te.columns)
    assert 0 < got_tr.shape[1] < tr.shape[1]
    # JAX's importance at the port's per-class C: the solvers' drift
    Y = np.stack([np.where(y == c, 1.0, -1.0) for c in range(K)])
    counts = np.bincount(y)
    Wj, _ = _jax_fista(tr.values, Y, len(y) / (K * counts[y]), best_C)
    drift = np.abs(imp - np.abs(Wj).mean(0)).max()
    margin = np.abs(imp - TR.SELECT_THRESHOLD).min()
    assert margin > 10 * drift, (margin, drift)


def test_reduce_dim_cli_matches_jax_reduce_features(tmp_path, capsys):
    """The port's ``cli.reduce_dim`` on pickled frames: the reduced frames
    (columns identical, values bit for bit) and the log lines equal JAX's
    ``reduce_features`` on the same frames."""
    tr, te, y = _frames()
    paths = {k: str(tmp_path / f"{k}.pkl") for k in
             ("radiomics", "radiomics_test", "radiomics_red",
              "radiomics_test_red", "df")}
    tr.to_pickle(paths["radiomics"])
    te.to_pickle(paths["radiomics_test"])
    pd.DataFrame({"dx": y}).to_pickle(paths["df"])
    cfg = tmp_path / "c.yml"
    cfg.write_text(yaml.safe_dump({"seed": 42, "device": "cpu",
                                   "dir": paths}))
    tred.main(["--config_path", str(cfg)])
    lines = capsys.readouterr().out.splitlines()
    jlog = []
    want_tr, want_te = JR.reduce_features(tr, te, pd.Series(y), seed=42,
                                          log=jlog.append)
    got_tr = pd.read_pickle(paths["radiomics_red"])
    got_te = pd.read_pickle(paths["radiomics_test_red"])
    assert lines[:len(jlog)] == jlog
    assert lines[len(jlog)].startswith("Reduced radiomics saved: train "
                                       f"{want_tr.shape}")
    for got, want in ((got_tr, want_tr), (got_te, want_te)):
        assert list(got.columns) == list(want.columns)
        np.testing.assert_array_equal(got.values, want.values)
    assert 0 < got_tr.shape[1] < tr.shape[1] - 2


# ------------------------------------------------------------ extraction

@pytest.fixture(scope="module")
def extracted(tmp_path_factory):
    """``make_synthetic_isic(n_train=4, n_test=2, image_hw=(32, 40))`` →
    the port's ``prepare_df`` and ``extract_radiomics`` CLIs (device cpu,
    chunks of 4: the CLI's 16 would pad 4 images to 16 on the CPU), and
    JAX's ``extract_radiomics_frames`` in chunks of 4 on the same
    manifests."""
    root = tmp_path_factory.mktemp("torch_rad_ws")
    dirs = make_synthetic_isic(str(root / "data"), n_train=4, n_test=2,
                               image_hw=(32, 40), seed=0)
    cfg = root / "c.yml"
    cfg.write_text(yaml.safe_dump({"seed": 42, "device": "cpu",
                                   "dir": dirs}))
    tprep.main(["--config_path", str(cfg)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tex, "CHUNK", 4)
        tex.main(["--config_path", str(cfg)])
    df_train = pd.read_pickle(dirs["df"])
    df_test = pd.read_pickle(dirs["df_test"])
    want = JRad.extract_radiomics_frames(
        {"dir": {}}, df_train, df_test, JRad.RadiomicsExtractor(batch=4))
    got = (pd.read_pickle(dirs["radiomics"]),
           pd.read_pickle(dirs["radiomics_test"]))
    return df_train, df_test, got, want


def test_extract_radiomics_cli_matches_jax(extracted):
    """Both packages decode with the native decoder (it loads here); every
    column in order and every value within the slice test's tolerances."""
    assert native_io.available()
    *_, got, want = extracted
    bad = []
    for g, w in zip(got, want):
        assert list(g.columns) == list(w.columns)
        assert g.shape[1] == 4872 and g.dtypes.eq(np.float64).all()
        for col in g.columns:
            derived, cls, rest = col.split("_", 2)
            feat, ch = rest.rsplit("_", 1)
            for i, (v, ref) in enumerate(zip(g[col].values, w[col].values)):
                if np.isnan(v) or np.isnan(ref):
                    if not (np.isnan(v) and np.isnan(ref)):
                        bad.append((col, i, v, ref))
                    continue
                atol = ATOL.get(feat, 0.0)
                if cls == "firstorder" and feat in INTENSITY:
                    atol = 1e-5 * max(
                        abs(w[f"{derived}_firstorder_Minimum_{ch}"].iloc[i]),
                        abs(w[f"{derived}_firstorder_Maximum_{ch}"].iloc[i]))
                if abs(v - ref) > RTOL * abs(ref) + atol:
                    bad.append((col, i, v, ref))
    assert not bad, bad[:20]
    assert [len(g) for g in got] == [4, 2]


def test_cv2_batched_path_equals_per_image(extracted):
    """The cv2 chunk decoder (used where the native decoder does not load)
    gives the per-image path's pixels, so the same features, bit for bit;
    a chunk of 3 pads the 2 test records with the last."""
    _, df_test, *_ = extracted
    records = df_test.to_dict(orient="records")
    ex = TRad.RadiomicsExtractor(batch=3, device="cpu")
    batched = ex._batched_extraction(records, native=False)
    single = [ex.extract_radiomics(r) for r in records]
    cols_b, vals_b = TRad.features_to_frame(batched)
    cols_s, vals_s = TRad.features_to_frame(single)
    assert cols_b == cols_s and vals_b.shape == (2, 4872)
    np.testing.assert_array_equal(vals_b, vals_s)
    rgb, masks = ex._decode_chunk(records, (32, 40), native=False)
    for i, r in enumerate(records):
        im, sg = TRad.read_image_mask(r)
        np.testing.assert_array_equal(rgb[i], im)
        np.testing.assert_array_equal(masks[i], sg)


def test_extract_radiomics_one_card_rule():
    """``_maybe_mesh`` with one card a process: chunks of 16; data -1 or 1
    fits one process, and a mesh over more cards (data 8, or model 2)
    raises there."""
    from multimodal_isic_tpu_torch.cli.common import check_mesh

    assert tex.CHUNK == 16
    for data in (-1, 1):
        check_mesh(config_from_dict({"mesh": {"data": data}}), 1)
    for mesh in ({"data": 8}, {"data": 1, "model": 2}):
        with pytest.raises(ValueError, match="one card"):
            check_mesh(config_from_dict({"mesh": mesh}), 1)
    ex = TRad.RadiomicsExtractor(device="cpu")
    assert ex.get_enabled_image_types() == \
        JRad.RadiomicsExtractor.get_enabled_image_types(None)
    assert ex.get_enabled_features() == \
        JRad.RadiomicsExtractor.get_enabled_features(None)
