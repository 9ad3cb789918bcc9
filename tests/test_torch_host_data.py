"""Port parity for the fusion classifier's host data: the config, the
synthetic dataset on disk, the manifests, the native decoder's binding, the
records and the loader, against the JAX package on the same inputs."""

import os

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from multimodal_isic_tpu.core import config as jcfg
from multimodal_isic_tpu.data import manifest as jman
from multimodal_isic_tpu.data import native_io as jnative
from multimodal_isic_tpu.data import pipeline as jpipe
from multimodal_isic_tpu.data import synthetic as jsyn
from multimodal_isic_tpu_torch.core import config as tcfg
from multimodal_isic_tpu_torch.core.rng import RngStream
from multimodal_isic_tpu_torch.data import manifest as tman
from multimodal_isic_tpu_torch.data import native_io as tnative
from multimodal_isic_tpu_torch.data import pipeline as tpipe
from multimodal_isic_tpu_torch.data import synthetic as tsyn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_HW = (64, 80)
STAGING = (48, 48)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A port-written synthetic dataset, its config dict and its manifests
    (built by the JAX package; ``test_manifests_match_jax`` holds the
    port's equal)."""
    root = tmp_path_factory.mktemp("host_data")
    dirs = tsyn.make_synthetic_isic(str(root / "data"), n_train=12, n_test=5,
                                    image_hw=SRC_HW, seed=3)
    df_train, df_test = jman.prepare_manifests({"dir": dirs})
    return dirs, df_train, df_test


def _workspace_config(dirs):
    return {"neptune": False, "seed": 42, "device": "cpu", "dir": dict(dirs),
            "model_path": "models", "log_dir": "runs", "pca": False,
            "num_classes": 7, "mesh": {"data": -1, "model": 1},
            "training_plan": {
                "modality": ["image", "clinical"], "fusion": "attention",
                "fusion_level": "late",
                "parameters": {"patience": 3, "epochs": 2, "fold": 1,
                               "batch_size": 8, "device_cache": True,
                               "augment_fast": True, "fold_bn_eval": True,
                               "backbone": "efficientnet-b0",
                               "backbone_remat": "conv", "unused": None}},
            "best_params": {"hidden_dim": 32, "lr": 1e-3}}


@pytest.mark.parametrize("case", [
    "repo_config", "workspace", "unknown_top", "unknown_dir",
    "unknown_parameters", "unknown_mesh"])
def test_load_config_matches_jax(case, tmp_path, dataset):
    """``load_config`` equals JAX's ``to_dict()`` on the repo's config and
    on a workspace config (None-valued unknown keys skipped); unknown keys
    raise ``KeyError`` in both."""
    if case == "repo_config":
        path = os.path.join(REPO, "configs", "config.yml")
    else:
        raw = _workspace_config(dataset[0])
        bad = {"unknown_top": raw, "unknown_dir": raw["dir"],
               "unknown_parameters": raw["training_plan"]["parameters"],
               "unknown_mesh": raw["mesh"]}.get(case)
        if bad is not None:
            bad["bogus_key"] = 1
        path = str(tmp_path / "config.yml")
        with open(path, "w") as f:
            yaml.safe_dump(raw, f)
    if case.startswith("unknown"):
        for load in (jcfg.load_config, tcfg.load_config):
            with pytest.raises(KeyError, match="bogus_key"):
                load(path)
        return
    want, got = jcfg.load_config(path), tcfg.load_config(path)
    assert got.to_dict() == want.to_dict()
    assert got["training_plan"]["parameters"]["backbone"] == \
        want["training_plan"]["parameters"]["backbone"]
    assert ("device" in got) and got.get("nope", 7) == 7


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_make_synthetic_isic_matches_jax(tmp_path):
    """The same CSVs, JPEGs and PNG masks byte for byte, and the same dict
    (up to the root), at the same seed."""
    kw = dict(n_train=16, n_test=4, image_hw=(40, 56), seed=11)
    got = tsyn.make_synthetic_isic(str(tmp_path / "t"), **kw)
    want = jsyn.make_synthetic_isic(str(tmp_path / "j"), **kw)
    assert got == {k: v.replace(str(tmp_path / "j"), str(tmp_path / "t"))
                   for k, v in want.items()}
    files_t, files_j = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert len(files_t) == 2 * (16 + 4) + 2
    assert files_t == files_j


def test_manifests_match_jax(dataset, tmp_path):
    """``prepare_manifests`` (pickles included), ``build_manifests``'
    encoders, ``LabelEncoder``'s refusal of unseen labels and
    ``merge_isic2019`` equal the JAX package's."""
    dirs, df_train_j, df_test_j = dataset
    out = {k: str(tmp_path / f"{k}.pkl") for k in ("df", "df_test")}
    cfg = tcfg.config_from_dict({"dir": {**dirs, **out}})
    df_train, df_test = tman.prepare_manifests(cfg)
    pd.testing.assert_frame_equal(df_train, df_train_j)
    pd.testing.assert_frame_equal(df_test, df_test_j)
    pd.testing.assert_frame_equal(pd.read_pickle(out["df"]), df_train_j)
    pd.testing.assert_frame_equal(pd.read_pickle(out["df_test"]), df_test_j)

    raw_train, raw_test = pd.read_csv(dirs["csv"]), pd.read_csv(dirs["csv_test"])
    raw_test.loc[0, "image_id"] = jman.DROPPED_TEST_IMAGE
    args = (raw_train, raw_test, "i", "s", "it", "st")
    *frames_t, enc_t = tman.build_manifests(*args)
    *frames_j, enc_j = jman.build_manifests(*args)
    for a, b in zip(frames_t, frames_j):
        pd.testing.assert_frame_equal(a, b)
    assert len(frames_t[1]) == len(raw_test) - 1
    for k in enc_j:
        np.testing.assert_array_equal(enc_t[k].classes_, enc_j[k].classes_)
    for enc in (enc_t["dx"], enc_j["dx"]):
        with pytest.raises(ValueError, match="unseen"):
            enc.transform(["mel", "zzz"])

    rng = np.random.RandomState(0)
    names = [f"ISIC_{i:07d}" for i in range(9)]
    meta = pd.DataFrame({"image": names, "age_approx": rng.randint(20, 80, 9)})
    gt_cols = ["MEL", "NV", "BCC", "AK", "BKL", "DF", "VASC", "SCC", "UNK"]
    gt = pd.DataFrame(np.eye(9, dtype=np.float64)[rng.permutation(9)],
                      columns=gt_cols)
    gt.insert(0, "image", names)
    test_dup = df_test_j.copy()
    test_dup.loc[test_dup.index[0], "image_path"] = f"/x/{names[2]}.jpg"
    merged_t = tman.merge_isic2019(df_train_j, test_dup, meta, gt, "/2019")
    merged_j = jman.merge_isic2019(df_train_j, test_dup, meta, gt, "/2019")
    pd.testing.assert_frame_equal(merged_t, merged_j)
    assert len(merged_t) > len(df_train_j)


def _native_or_skip():
    if not (jnative.available() and tnative.available()):
        pytest.skip("the native IO library does not load here")


@pytest.mark.parametrize("case", ["single", "crop_batch", "full_batch",
                                  "no_mask", "missing_file"])
def test_native_binding_matches_jax(case, dataset):
    """The port's ctypes binding gives the JAX binding's arrays bit for bit,
    and the same error on a missing file."""
    _native_or_skip()
    _, df, _ = dataset
    images = df["image_path"].tolist()
    masks = [str(p) for p in df["segmentation_path"]]
    if case == "missing_file":
        images[1] = "/nonexistent.jpg"
        for mod in (tnative, jnative):
            with pytest.raises(FileNotFoundError):
                mod.decode_crop(images[1], masks[1], STAGING)
            with pytest.raises(FileNotFoundError):
                mod.decode_crop_batch(images, masks, STAGING, n_threads=2)
        return
    if case == "no_mask":
        masks = ["no_mask"] * len(masks)
    if case in ("single", "no_mask"):
        for i in (0, 3):
            got = tnative.decode_crop(images[i], masks[i], STAGING)
            want = jnative.decode_crop(images[i], masks[i], STAGING)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        if case == "no_mask":
            assert got[1].sum() == 0
        return
    fn = "decode_crop_batch" if case == "crop_batch" else "decode_full_batch"
    got = getattr(tnative, fn)(images, masks, STAGING, n_threads=2)
    want = getattr(jnative, fn)(images, masks, STAGING, n_threads=2)
    assert got[0].shape == (len(images), *STAGING, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


RECORD_CASES = {  # (use_native, cache_decoded, with_image, radiomics)
    "cv2": (False, False, True, False),
    "cv2_cached": (False, True, True, True),
    "native": (True, False, True, False),
    "native_cached": (True, True, True, True),
    "metadata_only": (False, False, False, True),
}


@pytest.mark.parametrize("case", list(RECORD_CASES))
def test_records_match_jax(case, dataset):
    """``DermRecords`` gives the JAX records key by key (values and dtypes),
    on the native and cv2 paths, cached (a second read from the cache) or
    not, with images or metadata only, with radiomics or the placeholder;
    and the staging resize where the crop is not the staging size."""
    use_native, cache, with_image, with_rad = RECORD_CASES[case]
    if use_native:
        _native_or_skip()
    _, df, _ = dataset
    rad = (np.random.RandomState(1).randn(len(df), 20).astype(np.float32)
           if with_rad else None)
    kw = dict(radiomics=rad, staging_hw=STAGING, use_native=use_native,
              with_image=with_image, cache_decoded=cache)
    got_r, want_r = tpipe.DermRecords(df, **kw), jpipe.DermRecords(df, **kw)
    assert got_r.radiomics_dim == (20 if with_rad else 102)
    for _ in range(2 if cache else 1):
        for i in range(len(df)):
            got, want = got_r[i], want_r[i]
            assert list(got) == list(want)
            for k in want:
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if with_image:
        assert got["image"].shape == (*STAGING, 3)


@pytest.mark.parametrize("case", ["cv2", "native_cached", "metadata_only"])
def test_device_loader_yields_jax_host_batches(case, dataset):
    """``DeviceLoader`` (on the CPU, no transform) yields the JAX loader's
    host batches in the same order, partial last batch included; integer
    columns arrive as int64."""
    use_native, cache, with_image, _ = RECORD_CASES[case]
    if use_native:
        _native_or_skip()
    _, df, _ = dataset
    kw = dict(staging_hw=STAGING, use_native=use_native, with_image=with_image,
              cache_decoded=cache)
    order = np.random.RandomState(2).permutation(len(df))
    want = list(jpipe.DeviceLoader(jpipe.DermRecords(df, **kw), 5,
                                   order=order)._host_batches())
    loader = tpipe.DeviceLoader(tpipe.DermRecords(df, **kw), 5, order=order,
                                device="cpu")
    got = list(loader)
    assert len(got) == len(want) == len(loader) == 3  # 5 + 5 + 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            want_dtype = (torch.int64 if w[k].dtype == np.int32
                          else torch.from_numpy(w[k]).dtype)
            assert g[k].dtype == want_dtype, k
            np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)


def test_device_loader_transform_errors_and_device_dataset(dataset,
                                                           monkeypatch):
    """The transform gets each batch with the next generator of
    ``rng_stream``; a producer error (a missing file) is raised in the
    consumer; a consumer that stops early releases the producer; a
    ``DeviceDataset`` from records (uploaded in batches of 5 and a partial
    one) equals one from the same arrays."""
    _, df, _ = dataset
    records = tpipe.DermRecords(df, staging_hw=STAGING, use_native=False)
    seen = []

    def transform(images, masks, gen):
        seen.append(torch.randint(0, 2**30, (1,), generator=gen).item())
        return images.float() / 255.0, masks

    loader = tpipe.DeviceLoader(records, 4, transform=transform,
                                rng_stream=RngStream(7, "augment", "cpu"),
                                device="cpu")
    batches = list(loader)
    ref = RngStream(7, "augment", "cpu")
    assert seen == [torch.randint(0, 2**30, (1,), generator=ref.next()).item()
                    for _ in batches]
    assert batches[0]["image"].dtype == torch.float32
    assert float(batches[0]["image"].max()) <= 1.0

    monkeypatch.setattr(tpipe, "PREFETCH", 1)
    it = iter(tpipe.DeviceLoader(records, 2, device="cpu"))
    next(it)
    it.close()  # stops early: the producer thread must end

    broken = df.copy()
    broken.loc[broken.index[6], "image_path"] = "/nonexistent.jpg"
    bad = tpipe.DermRecords(broken, staging_hw=STAGING, use_native=False)
    with pytest.raises(FileNotFoundError, match="nonexistent"):
        list(tpipe.DeviceLoader(bad, 4, device="cpu"))

    monkeypatch.setattr(tpipe, "UPLOAD_BATCH", 5)
    staged = tpipe.DeviceDataset.from_records(records, device="cpu")
    host = tpipe._collate([records[i] for i in range(len(records))])
    meta = {k: v for k, v in host.items() if k not in ("image", "mask")}
    direct = tpipe.DeviceDataset(host["image"], meta, host["mask"],
                                 device="cpu")
    assert torch.equal(staged.images, direct.images)
    assert torch.equal(staged.masks, direct.masks)
    assert staged.meta.keys() == direct.meta.keys()
    for k in meta:
        assert torch.equal(staged.meta[k], direct.meta[k]), k
    no_masks = tpipe.DeviceDataset.from_records(records, device="cpu",
                                                with_masks=False)
    assert no_masks.masks is None and torch.equal(no_masks.images,
                                                  direct.images)
