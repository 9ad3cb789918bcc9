"""The latent slice against the JAX package: rendered uint8 lesions →
``mae_eval_batch`` → the encoder-only ConvMAE → ``extract_latent_bundle`` →
``patch_table`` → ``concat_patch_moments`` → PCA(0.90), on the same weights
and images; and the PCA module alone on data with a known spectrum."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.analysis import latent_pipeline as jlp
from multimodal_isic_tpu.analysis import latents as jlat
from multimodal_isic_tpu.analysis import pca as jpca
from multimodal_isic_tpu.data import augment as jaug
from multimodal_isic_tpu.models import convmae as J
from multimodal_isic_tpu_torch.analysis import latent_pipeline as tlp
from multimodal_isic_tpu_torch.analysis import latents as tlat
from multimodal_isic_tpu_torch.analysis import pca as tpca
from multimodal_isic_tpu_torch.data import augment as taug
from multimodal_isic_tpu_torch.data.crop import centroid_crop
from multimodal_isic_tpu_torch.data.synthetic import _render_sample
from multimodal_isic_tpu_torch.models import convmae as T
from multimodal_isic_tpu_torch.models.convert import convmae_state_dict
from tests.test_torch_convmae import random_params

# a tiny 128-aligned encoder; the slice runs at 64² (stage grids 16², 8², 4²:
# 16 patches of 16²), its resize is held at the reference's 224² separately
SIZE = 64
CFG = dict(img_size=SIZE, embed_dims=(128, 128, 128), depths=(1, 1, 1),
           num_heads=4, with_decoder=False)
# float32 latents: the same arithmetic in another order (~1e-6 measured)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _lesions():
    """9 rendered 48×64 lesions, centroid crops of 48² (uint8, float masks)."""
    rng = np.random.RandomState(0)
    crops, masks = [], []
    for i in range(9):
        img, mask = _render_sample(rng, 48, 64, i % 7)
        c, m = centroid_crop(img, mask)
        crops.append(c)
        masks.append(m)
    return np.stack(crops), np.stack(masks).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _slice():
    """Both packages' slice outputs on the 9 lesions at 64²: 2 train batches
    of 3 and one test batch of 3."""
    crops, masks = _lesions()
    targets = np.arange(9) % 7
    j_batch = jax.jit(jax.vmap(lambda i, m: jaug.mae_eval_transform(
        i.astype(jnp.float32), m, (SIZE, SIZE))))
    jm = J.ConvMAE(**CFG)
    params = random_params(jm, SIZE, seed=0)
    tm = T.ConvMAE(**CFG)
    tm.load_state_dict(convmae_state_dict(params))

    def batches(sl):
        out = []
        for s in range(sl.start, sl.stop, 3):
            j_img, j_msk = j_batch(jnp.asarray(crops[s:s + 3]),
                                   jnp.asarray(masks[s:s + 3]))
            t_img, t_msk = taug.mae_eval_batch(
                torch.from_numpy(crops[s:s + 3]),
                torch.from_numpy(masks[s:s + 3]), (SIZE, SIZE))
            out.append(({"image": j_img, "mask": j_msk,
                         "target": jnp.asarray(targets[s:s + 3])},
                        {"image": t_img, "mask": t_msk,
                         "target": torch.from_numpy(targets[s:s + 3])}))
        return out

    train, test = batches(slice(0, 6)), batches(slice(6, 9))
    j_train = jlp.extract_latent_bundle(jm, params, [b[0] for b in train])
    j_test = jlp.extract_latent_bundle(jm, params, [b[0] for b in test])
    t_tables = tlp.extract_latent_tables(tm, [b[1] for b in train],
                                         [b[1] for b in test],
                                         pca_enabled=True)
    return train, (j_train, j_test), t_tables


def test_mae_eval_batch_matches_jax():
    crops, masks = _lesions()
    j_img, j_msk = jaug.mae_eval_batch(jnp.asarray(crops[:3]),
                                       jnp.asarray(masks[:3]))
    t_img, t_msk = taug.mae_eval_batch(torch.from_numpy(crops[:3]),
                                       torch.from_numpy(masks[:3]))
    assert t_img.shape == (3, 224, 224, 3) and t_msk.shape == (3, 224, 224)
    # normalised values up to ~2.6: f32 resize sums in another order
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-5)
    np.testing.assert_array_equal(t_msk.numpy(), np.asarray(j_msk))
    # the slice's own 64² batches
    for jb, tb in _slice()[0]:
        np.testing.assert_allclose(tb["image"].numpy(),
                                   np.asarray(jb["image"]), atol=1e-5)
        np.testing.assert_array_equal(tb["mask"].numpy(),
                                      np.asarray(jb["mask"]))


def test_latent_bundle_matches_jax():
    _, (j_train, j_test), (_, _, t_train, t_test, _) = _slice()
    for j, t in ((j_train, t_train), (j_test, t_test)):
        assert t.latents.shape == (len(j.targets), 16, 128)
        for name in ("latents", "pooled_max", "pooled_mean"):
            np.testing.assert_allclose(getattr(t, name).numpy(),
                                       getattr(j, name), **TOL, err_msg=name)
        np.testing.assert_array_equal(t.ids_restore.numpy(), j.ids_restore)
        np.testing.assert_array_equal(t.lesion_overlap.numpy(),
                                      j.lesion_overlap)
        np.testing.assert_array_equal(t.targets.numpy(), j.targets)
        assert 0 < int(t.lesion_overlap.sum()) < t.lesion_overlap.numel()


@pytest.mark.parametrize("remove_background", [False, True])
def test_patch_table_matches_jax(remove_background):
    _, (j_train, _), (_, _, t_train, _, _) = _slice()
    want = jlp.patch_table(j_train, remove_background)
    got = tlp.patch_table(t_train, remove_background)
    assert set(got) == set(want)
    for k in ("image_idx", "patch_id", "patch_in_mask", "target"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(got["patch_latent"].numpy(),
                               want["patch_latent"], **TOL)


def test_patch_moments_match_jax():
    _, (j_train, _), (_, _, t_train, _, _) = _slice()
    lat = j_train.latents
    # the function on the same latents: float32 sums in another order
    got = tlat.concat_patch_moments(torch.from_numpy(lat))
    want = np.asarray(jlat.concat_patch_moments(jnp.asarray(lat)))
    assert got.shape == (6, 6 * 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    got_u = tlat.concat_patch_moments(torch.from_numpy(lat), unbiased=True)
    want_u = jlat.concat_patch_moments(jnp.asarray(lat), unbiased=True)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), rtol=1e-4,
                               atol=1e-4)
    # the slice end to end (skew and kurtosis amplify the latents' ~1e-6)
    np.testing.assert_allclose(
        tlat.concat_patch_moments(t_train.latents).numpy(), want,
        rtol=1e-3, atol=1e-3)


def test_latent_pca_matches_jax():
    _, (j_train, j_test), (t_tr, t_te, t_train, _, state) = _slice()
    jt_tr, jt_te, jstate = jlp.apply_pca(jlp.patch_table(j_train),
                                         jlp.patch_table(j_test))
    k = jstate.components.shape[0]
    assert state.components.shape == (k, 128)
    np.testing.assert_allclose(state.explained_variance_ratio.numpy(),
                               np.asarray(jstate.explained_variance_ratio),
                               rtol=1e-3, atol=1e-6)
    # the PCA(0.90) subspace, its reconstruction, is what downstream uses;
    # single components are defined only up to near-degenerate rotations
    for got, want, tab in ((t_tr, jt_tr, "train"), (t_te, jt_te, "test")):
        rec = tpca.inverse_transform(state, got["patch_latent_pca"])
        rec_j = jpca.inverse_transform(jstate, want["patch_latent_pca"])
        np.testing.assert_allclose(rec.numpy(), np.asarray(rec_j),
                                   rtol=1e-3, atol=1e-3, err_msg=tab)
    # the leading, well-separated components agree sign and all
    np.testing.assert_allclose(state.components[:2].numpy(),
                               np.asarray(jstate.components[:2]), atol=1e-3)


def test_pca_module_matches_jax():
    rng = np.random.RandomState(3)
    basis = np.linalg.qr(rng.randn(12, 12))[0]
    spectrum = np.array([9, 7, 5, 4, 3, 2.2, 1.6, 1.1, 0.7, 0.4, 0.2, 0.1])
    x = (rng.randn(400, 12) * np.sqrt(spectrum)) @ basis.T + 3.0
    x = x.astype(np.float32)
    for n_comp in (None, 4, 0.9):
        st, z = tpca.fit_transform(x, n_comp)
        jst, jz = jpca.fit_transform(x, n_comp)
        assert st.components.shape == jst.components.shape
        for a, b in zip(st, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-4)
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(
            tpca.inverse_transform(st, z).numpy(),
            np.asarray(jpca.inverse_transform(jst, jz)), rtol=1e-4, atol=1e-4)
    # sign convention: each component's largest-|loading| coordinate > 0
    comps = tpca.fit(x).components
    assert bool((comps.gather(1, comps.abs().argmax(1, keepdim=True)) > 0)
                .all())
