"""Port parity for MIL cross-validation and its CLI: ``train/cv.py`` and
``cli/use_latent.py`` (both modes) against the JAX package on the CPU.

The patch frame: 24 patients of 3 classes (9 of them with two images),
6-9 patches an image with shuffled patch ids, 8-dim latents.  Both
packages train AttentionMIL at dropout 0 from JAX's initial params (the
port's ``init_params_`` replaced by JAX's draws for the fold's seed), so
the folds' rows agree within ``ROW_TOL``: the same resampled bags, the
same steps, float32 sums in another order.  Fold membership equals JAX's
and sklearn's.  The sweep runs on a tiny port ConvMAE checkpoint and one
whose tree matches nothing: NaN rows for the bad one, finite rows for the
good one, and the config snapshot with its sha1 header.
"""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from multimodal_isic_tpu.cli import use_latent as JUL
from multimodal_isic_tpu.core.splits import StratifiedKFold as JKFold
from multimodal_isic_tpu.models.mil import AttentionMIL as JAttentionMIL
from multimodal_isic_tpu_torch.analysis import bags as TB
from multimodal_isic_tpu_torch.cli import prepare_df as tprep
from multimodal_isic_tpu_torch.cli import use_latent as TUL
from multimodal_isic_tpu_torch.cli.train_ae import TINY
from multimodal_isic_tpu_torch.core import checkpoint as ckpt
from multimodal_isic_tpu_torch.core.rng import generator
from multimodal_isic_tpu_torch.data.synthetic import make_synthetic_isic
from multimodal_isic_tpu_torch.models.convert import mil_state_dict
from multimodal_isic_tpu_torch.models.convmae import build_convmae
from multimodal_isic_tpu_torch.train import cv as TCV
from multimodal_isic_tpu_torch.train import mil as TM

ROW_TOL = dict(rtol=1e-4, atol=1e-5)
N_FOLDS, EPOCHS, F_DIM, NC = 2, 2, 8, 3
BEST = {"hidden_dim": 8, "att_dim": 4, "dropout": 0.0, "optimizer": "adam",
        "lr": 1e-2, "weight_decay": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path, config):
    path.write_text(yaml.safe_dump(config))
    return str(path)


def _patch_frame(seed=0):
    rng = np.random.RandomState(seed)
    rows = []
    for pid in range(24):
        label = pid % NC
        for img in range(1 + (pid % 8 < 3)):
            n = rng.randint(6, 10)
            for patch in rng.permutation(n):
                lat = rng.randn(F_DIM).astype(np.float32)
                lat[label] += 1.5
                # one patch of another class: the bag's label is the mode
                target = (label + 1) % NC if patch == 0 and img else label
                rows.append({"image_path": f"/d/SYN_{pid:04d}_{img}.jpg",
                             "segmentation_path": "s", "target": target,
                             "patch_id": int(patch), "patch_latent": lat,
                             "patch_in_mask": 1, "patch_latent_pca": lat})
    return pd.DataFrame(rows)


@pytest.fixture(scope="module")
def cv_workspace(tmp_path_factory):
    """The patch pickle, a config for each package, and JAX's
    ``cli.use_latent`` single-frame CSV on it."""
    root = tmp_path_factory.mktemp("torch_mil_cli")
    frame = _patch_frame()
    pkl = str(root / "patches.pkl")
    frame.to_pickle(pkl)
    base = {"seed": 42, "num_classes": NC, "best_params": BEST,
            "log_dir": str(root / "runs")}
    jax_cfg = _write(root / "jax.yml", {**base, "device": "tpu"})
    port_cfg = _write(root / "port.yml", {**base, "device": "cpu"})
    jax_csv = str(root / "jax_cv.csv")
    JUL.main(["--config_path", jax_cfg, "--model_type", "mil",
              "--patch_df", pkl, "--n_folds", str(N_FOLDS),
              "--max_epochs", str(EPOCHS), "--patience", "3",
              "--csv", jax_csv])
    return root, frame, pkl, port_cfg, pd.read_csv(jax_csv)


@pytest.fixture
def jax_init(monkeypatch):
    """The port's trainables start from JAX's initial AttentionMIL params
    for the fold's seed (JAX ``train/mil.py:127-131``; AttentionMIL's
    shapes do not depend on the bag length)."""
    def init(model, seed):
        jm = JAttentionMIL(input_dim=F_DIM, hidden_dim=BEST["hidden_dim"],
                           att_dim=BEST["att_dim"], dropout=0.0,
                           num_classes=NC)
        params = jm.init({"params": jax.random.PRNGKey(seed),
                          "dropout": jax.random.PRNGKey(0)},
                         jnp.zeros((4, F_DIM)), valid=jnp.ones(4, bool))
        model.load_state_dict(mil_state_dict(params["params"]))
    monkeypatch.setattr(TM, "init_params_", init)


def _assert_rows_match(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) == N_FOLDS
    assert got["error"].isna().all() or (got["error"].fillna("") == "").all()
    for col in want.columns:
        if col in ("fold", "error"):
            continue
        np.testing.assert_allclose(got[col].astype(float).values,
                                   want[col].astype(float).values,
                                   err_msg=col, **ROW_TOL)


def test_bags_sorted_modal_and_from_table(cv_workspace):
    _, frame, *_ = cv_workspace
    bags, labels, patients = TB.build_patient_bags(frame)
    assert patients == sorted(patients) and len(bags) == 24
    assert labels == [int(p) % NC for p in patients]
    df = frame.assign(patient=frame["image_path"].map(
        TB.patient_id_from_path))
    first = df[df["patient"] == patients[0]].sort_values(
        "patch_id", kind="stable")
    np.testing.assert_array_equal(bags[0],
                                  np.stack(first["patch_latent_pca"]))
    paths = sorted(frame["image_path"].unique())
    table = {"image_idx": torch.tensor([paths.index(p)
                                        for p in frame["image_path"]]),
             "patch_id": torch.tensor(frame["patch_id"].values),
             "target": torch.tensor(frame["target"].values),
             "patch_latent": torch.from_numpy(
                 np.stack(frame["patch_latent"]))}
    t_bags, t_labels, t_patients = TB.bags_from_table(table, paths)
    assert t_patients == patients and t_labels == labels
    for a, b in zip(t_bags, bags):
        np.testing.assert_array_equal(a, b)


def test_cross_validate_mil_matches_jax(cv_workspace, jax_init):
    from sklearn.model_selection import StratifiedKFold as SkKFold
    root, frame, _, _, jax_rows = cv_workspace
    bags, labels, _ = TB.build_patient_bags(frame)
    X = np.zeros((len(labels), 1))
    for ours, theirs, sk in zip(
            TCV.fold_splits(labels, N_FOLDS, 42),
            JKFold(N_FOLDS, shuffle=True, random_state=42).split(X, labels),
            SkKFold(N_FOLDS, shuffle=True, random_state=42).split(X, labels)):
        for a, b, c in zip(ours, theirs, sk):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    out = TCV.cross_validate_mil(bags, labels, "mil", dict(BEST),
                                 n_folds=N_FOLDS, seed=42, num_classes=NC,
                                 max_epochs=EPOCHS, patience=3,
                                 csv_path=str(root / "port_cv.csv"),
                                 device="cpu")
    _assert_rows_match(out["frame"], jax_rows)
    _assert_rows_match(pd.read_csv(root / "port_cv.csv"), jax_rows)
    assert set(out["summary"]) == set(jax_rows.columns) - {"fold", "error"}


def test_use_latent_single_frame_matches_jax_cli(cv_workspace, jax_init):
    root, _, pkl, port_cfg, jax_rows = cv_workspace
    csv = str(root / "port_cli.csv")
    out = TUL.main(["--config_path", port_cfg, "--model_type", "mil",
                    "--patch_df", pkl, "--n_folds", str(N_FOLDS),
                    "--max_epochs", str(EPOCHS), "--patience", "3",
                    "--csv", csv])
    _assert_rows_match(pd.read_csv(csv), jax_rows)
    assert all(np.isfinite(m) for m, _ in out["summary"].values())


def test_use_latent_sweep_nan_rows_and_snapshot(tmp_path, monkeypatch):
    """Sweep mode: a tiny port ConvMAE checkpoint and one whose tree
    matches nothing (``restore_partial`` raises), 72 patients (two folds,
    then the 80/20 split inside, need two bags a class everywhere)."""
    dirs = make_synthetic_isic(str(tmp_path / "data"), n_train=72, n_test=8,
                               image_hw=(64, 80), seed=7)
    config = {
        "seed": 42, "device": "cpu", "dir": dirs, "pca": False,
        "latent_dtype": "float32", "log_dir": str(tmp_path / "runs"),
        "model_path": str(tmp_path / "models"),
        "training_plan": {"parameters": {"model_size": "tiny"}},
        "best_params": dict(BEST, dropout=0.2),
    }
    cfg = _write(tmp_path / "sweep.yml", config)
    tprep.main(["--config_path", cfg])
    good = str(tmp_path / "good_ckpt")
    ckpt.save_checkpoint(good, build_convmae(generator(3, "cpu"),
                                             **TINY).state_dict())
    bad = str(tmp_path / "bad_ckpt")
    ckpt.save_checkpoint(bad, {"unrelated.w": torch.zeros(3)})
    monkeypatch.chdir(tmp_path)
    out_dir = tmp_path / "mil_results"
    TUL.main(["--config_path", cfg, "--model_type", "mil",
              "--checkpoints", f"{bad},{good}", "--n_folds", "2",
              "--max_epochs", "2", "--patience", "2",
              "--out_dir", str(out_dir)])
    (csv,) = [f for f in os.listdir(out_dir)
              if f.startswith("runs_df_mil_results_")]
    res = pd.read_csv(out_dir / csv)
    assert len(res) == 4
    assert list(res["checkpoint_type"]) == ["best_bacc", "best_loss"] * 2
    bad_rows, good_rows = res[res["id"] == "manual_0"], \
        res[res["id"] == "manual_1"]
    stems = [c for _, c in TCV.SWEEP_COLS]
    assert bad_rows[stems].isna().all().all()
    assert bad_rows["error"].str.contains("matched 0").all()
    assert np.isfinite(good_rows[stems + [f"{c}_std" for c in stems]]
                       .values).all()
    (snap,) = [f for f in os.listdir(out_dir) if f.startswith("config_")]
    header, body = (out_dir / snap).read_text().split("\n", 1)
    assert header == ("# config_hash: "
                      + hashlib.sha1(body.encode()).hexdigest()[:8])
    assert yaml.safe_load(body)["seed"] == 42
    events = [json.loads(line) for d in os.listdir(tmp_path / "runs")
              for line in open(tmp_path / "runs" / d / "metrics.jsonl")]
    assert {e["name"] for e in events} >= {"manual_1/best_bacc/macro_f1"}
