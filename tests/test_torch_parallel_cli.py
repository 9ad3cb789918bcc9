"""The four CLIs the JAX package runs in several processes, run by the
port in 2 processes on the CPU (``ISIC_*`` with a ``FileStore`` under
``tmp_path``, gloo, one group under one wall timeout, the four CLIs one
after the other in the same two processes): ``cli.main`` (metadata
modalities, 2 epochs) against the port's ``main`` in one process,
``cli.train_ae`` (the tiny ConvMAE, 1 epoch) with its ``val_n_true`` loss
against a one-process evaluation of its saved weights,
``cli.extract_radiomics`` against one process bit for bit, and
``cli.tune_mil`` (every trial once across the ranks, one table on both, the
artifacts on rank 0 only)."""

import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from multimodal_isic_tpu_torch.cli import extract_radiomics as txr
from multimodal_isic_tpu_torch.cli import main as tmain
from multimodal_isic_tpu_torch.cli import prepare_df as tprep
from multimodal_isic_tpu_torch.cli import train_ae as tae
from multimodal_isic_tpu_torch.core import checkpoint as tck
from multimodal_isic_tpu_torch.core.rng import RngPool
from multimodal_isic_tpu_torch.data import augment as taug
from multimodal_isic_tpu_torch.data import pipeline as tpipe
from multimodal_isic_tpu_torch.data.synthetic import make_synthetic_isic
from multimodal_isic_tpu_torch.models import fusion as tfu
from multimodal_isic_tpu_torch.models.convmae import ConvMAE
from multimodal_isic_tpu_torch.parallel import distributed as TD
from multimodal_isic_tpu_torch.parallel.launch import (rank_results,
                                                       run_ranks)
from multimodal_isic_tpu_torch.train import fusion as ttr
from multimodal_isic_tpu_torch.train.mae import make_mae_eval_persample_step
from multimodal_isic_tpu_torch.utils.logging import read_metrics

GROUP_TIMEOUT_S = 90
META_MODS = ["radiomics", "clinical", "artifacts"]
HPO_ARGS = ["--model_type", "mil", "--num_samples", "4", "--cohort_size",
            "2", "--max_epochs", "2", "--patience", "2", "--grace_period",
            "1"]

CLI_CODE = r"""
import json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
from multimodal_isic_tpu_torch.cli import extract_radiomics, main, train_ae
from multimodal_isic_tpu_torch.cli import tune_mil
from multimodal_isic_tpu_torch.parallel import distributed as D

work, rank = sys.argv[1], int(os.environ["ISIC_PROCESS_ID"])
res = main.main(["--config_path", work + "/main.yml"])
np.save(f"{work}/main_logits{rank}.npy", res["logits"].numpy())
ae = train_ae.main(["--config_path", work + "/ae.yml"])
extract_radiomics.CHUNK = 2  # the CLI's 16 would pad 6 images to 16
extract_radiomics.main(["--config_path", work + "/rad.yml"])
out = tune_mil.main(["--config_path", work + "/tune.yml", *sys.argv[2:],
                     "--patch_df", work + "/patches.pkl",
                     "--output_dir", f"{work}/hpo{rank}"])
out["results"].to_csv(f"{work}/hpo_table{rank}.csv", index=False)
print("RANK-RESULT " + json.dumps({
    "model_path": res["model_path"], "run_dir": res["run_dir"],
    "ae_model": ae["model_path"], "ae_val": ae["best_val_loss"],
    "ae_run": ae["run_dir"]}), flush=True)
D.shutdown()
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path, cfg):
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _patch_frame(seed=0, nc=3, dim=8):
    rng = np.random.RandomState(seed)
    rows = []
    for pid in range(24):
        label = pid % nc
        for patch in rng.permutation(rng.randint(6, 10)):
            lat = rng.randn(dim).astype(np.float32)
            lat[label] += 1.5
            rows.append({"image_path": f"/d/SYN_{pid:04d}_0.jpg",
                         "segmentation_path": "s", "target": label,
                         "patch_id": int(patch), "patch_latent": lat,
                         "patch_in_mask": 1, "patch_latent_pca": lat})
    return pd.DataFrame(rows)


@pytest.fixture(scope="module")
def clis(tmp_path_factory):
    """The workspace (36 train and 8 test lesions of 32×40: fold 1 trains
    on 32, two global batches of 16; a second set of 6 + 3 for radiomics;
    a 24-patient patch frame), the configs, and the 2-process run."""
    work = tmp_path_factory.mktemp("torch_parallel_cli")
    dirs = make_synthetic_isic(str(work / "data"), n_train=36, n_test=8,
                               image_hw=(32, 40), seed=5)
    base = {"seed": 42, "device": "cpu", "dir": dirs, "pca": False,
            "num_classes": 7}
    cfgs = {
        "main": dict(base, model_path=str(work / "models"),
                     log_dir=str(work / "runs"), training_plan={
                         "modality": META_MODS, "fusion": "concat",
                         "fusion_level": "intermediate",
                         "parameters": {"patience": 3, "epochs": 2,
                                        "fold": 1}}),
        "ae": dict(base, model_path=str(work / "ae_models"),
                   log_dir=str(work / "ae_runs"), training_plan={
                       "parameters": {"epochs": 1, "fold": 1,
                                      "batch_size": 8, "model_size": "tiny",
                                      "masking_ratio": 0.75,
                                      "eval_masking_ratio": 0.5,
                                      "norm_pix_loss": False,
                                      "include_lesion_mask": False}}),
        "tune": {"seed": 42, "num_classes": 3, "device": "cpu"},
    }
    rad_dirs = make_synthetic_isic(str(work / "rad_data"), n_train=6,
                                   n_test=3, image_hw=(32, 40), seed=5)
    rad_dirs.update(radiomics=str(work / "rad.pkl"),
                    radiomics_test=str(work / "rad_test.pkl"))
    cfgs["rad"] = {"seed": 42, "device": "cpu", "dir": rad_dirs}
    paths = {k: _write(work / f"{k}.yml", v) for k, v in cfgs.items()}
    tprep.main(["--config_path", paths["main"]])
    tprep.main(["--config_path", paths["rad"]])
    _patch_frame().to_pickle(str(work / "patches.pkl"))
    outs = run_ranks(2, [sys.executable, "-c", CLI_CODE, str(work),
                         *HPO_ARGS], str(work), GROUP_TIMEOUT_S,
                     env={"OMP_NUM_THREADS": "1"})
    return work, cfgs, outs, rank_results(outs)


def test_main_in_two_processes_equals_one(clis):
    """One run record and one checkpoint (rank 0), both ranks restoring
    rank 0's path; each epoch's train and validation losses equal the
    one-process run's (rtol 1e-5: the data-parallel sums in another
    order); the test logits equal the one-process run's (rtol/atol 1e-5)
    and, restored from the checkpoint in this process, the run's own."""
    work, cfgs, outs, res = clis
    assert res[0]["model_path"] == res[1]["model_path"]
    assert os.listdir(work / "models") == [os.path.basename(
        res[0]["model_path"])]
    assert len(os.listdir(work / "runs")) == 1 and res[1]["run_dir"] is None
    one_cfg = dict(cfgs["main"], model_path=str(work / "one_models"),
                   log_dir=str(work / "one_runs"))
    one = tmain.main(["--config_path", _write(work / "one.yml", one_cfg)])
    two_ev, one_ev = (read_metrics(r) for r in (res[0]["run_dir"],
                                                one["run_dir"]))
    for key in ("train/epoch_loss", "val/epoch_loss", "val/epoch_acc"):
        got = [e["value"] for e in two_ev if e["name"] == key]
        want = [e["value"] for e in one_ev if e["name"] == key]
        assert len(got) == 2 and got == pytest.approx(want, rel=1e-5), key
    logits = np.load(work / "main_logits0.npy")
    np.testing.assert_array_equal(logits, np.load(work / "main_logits1.npy"))
    assert logits.shape == (8, 7)
    np.testing.assert_allclose(logits, one["logits"].numpy(), rtol=1e-5,
                               atol=1e-5)
    model = tfu.MultiModalFusionNet(
        modality=META_MODS, fusion_strategy="concat",
        radiomics_dim=tpipe.RADIOMICS_PLACEHOLDER_DIM)
    model.load_state_dict(tck.restore_checkpoint(res[0]["model_path"]))
    df_test = pd.read_pickle(cfgs["main"]["dir"]["df_test"])
    loader = tpipe.DeviceLoader(tpipe.DermRecords(df_test, with_image=False),
                                tmain.GLOBAL_BS, device="cpu")
    step = ttr.make_fusion_eval_step(model)
    restored = torch.cat([step(b)[1] for b in loader]).numpy()
    np.testing.assert_allclose(restored, logits, rtol=1e-5, atol=1e-6)


def test_train_ae_in_two_processes(clis):
    """Rank 0 alone writes the run record, ``mae_ckpt/`` and the uuid
    checkpoint; the best validation loss (per-sample losses gathered over
    the wrap-padded loader, trimmed to the 4 true rows) equals a
    one-process evaluation of the saved weights on the same masking
    draws (rtol 1e-5)."""
    work, cfgs, outs, res = clis
    assert res[1]["ae_model"] is None and res[1]["ae_run"] is None
    assert sorted(os.listdir(work / "ae_models")) == sorted(
        ["mae_ckpt", os.path.basename(res[0]["ae_model"])])
    assert len(os.listdir(work / "ae_runs")) == 1
    assert "Saved Best Model" in outs[0] and "Saved Best Model" not in outs[1]
    model = ConvMAE(**tae.TINY, norm_pix_loss=False)
    model.load_state_dict(tck.restore_checkpoint(res[0]["ae_model"]))
    df = pd.read_pickle(cfgs["ae"]["dir"]["df"])
    from multimodal_isic_tpu_torch.core.splits import StratifiedKFold
    folds = list(StratifiedKFold(n_splits=10, shuffle=True,
                                 random_state=42).split(df, df["dx"]))
    records = tpipe.DermRecords(df.iloc[folds[1][1]])
    n = len(records)
    order = np.resize(np.arange(n), tae.VAL_BS)
    gen = RngPool(42, "cpu")["eval"].at(0)
    step = make_mae_eval_persample_step(model, 0.5)
    losses = np.concatenate([
        step(b["image"], gen).numpy() for b in tpipe.DeviceLoader(
            records, tae.VAL_BS, order=order,
            transform=taug.POLICIES["mae_eval"], device="cpu")])[:n]
    assert res[0]["ae_val"] == pytest.approx(float(losses.mean()), rel=1e-5)
    assert res[0]["ae_val"] == res[1]["ae_val"]


def test_extract_radiomics_in_two_processes_equals_one(clis):
    """The 6 + 3 lesions split over the ranks in chunks of 2 (3 and 2
    chunks: uneven shares): rank 0's frames equal one process's bit for
    bit, rows in the same order."""
    work, cfgs, _, _ = clis
    two = (pd.read_pickle(work / "rad.pkl"),
           pd.read_pickle(work / "rad_test.pkl"))
    cfg = dict(cfgs["rad"], dir=dict(cfgs["rad"]["dir"],
                                     radiomics=str(work / "one_rad.pkl"),
                                     radiomics_test=str(work / "one_t.pkl")))
    old = txr.CHUNK
    txr.CHUNK = 2
    try:
        one = txr.main(["--config_path", _write(work / "rad1.yml", cfg)])
    finally:
        txr.CHUNK = old
    for got, want in zip(two, one):
        assert list(got.columns) == list(want.columns)
        np.testing.assert_array_equal(got.values, want.values)
    assert two[0].shape == (6, 4872) and two[1].shape == (3, 4872)


def test_tune_mil_in_two_processes(clis):
    """Both ranks hold one results table of the 4 trials (the two cohorts
    ran one a rank), finite val_bacc, and only rank 0 wrote the
    artifacts."""
    work, _, outs, _ = clis
    tables = [pd.read_csv(work / f"hpo_table{r}.csv") for r in (0, 1)]
    pd.testing.assert_frame_equal(tables[0], tables[1])
    assert len(tables[0]) == 4 and np.isfinite(tables[0]["val_bacc"]).all()
    assert sorted(p.split("_")[0] for p in os.listdir(work / "hpo0")) == [
        "best", "hpo"]
    assert not (work / "hpo1").exists()
    assert all("Packed search: 4 trials" in o for o in outs)


def test_multiprocess_env_without_a_count_is_refused(monkeypatch):
    monkeypatch.setenv("ISIC_COORDINATOR", "localhost:1")
    monkeypatch.delenv("ISIC_NUM_PROCESSES", raising=False)
    with pytest.raises(ValueError, match="multi-process"):
        TD.initialize(device="cpu")
