"""Port parity for the MIL search CLI: ``cli/tune_mil.py`` against JAX's
``cli.tune_mil`` on the CPU, on a tiny patch frame (24 patients of 3
classes, 6-9 patches of 8-dim latents).

- ``--packed auto``: both CLIs run their packed cohorts (3 trials in
  one cohort, ASHA at grace 1): the same trial ids, config columns and
  values (one seeded stream) and result columns.  The values differ: the
  two packages draw their inits and dropout masks from different
  generators.
- ``--packed never``: JAX's CLI drives the port's ``train_mil`` on the CPU
  (its parity with JAX's trainable is ``test_torch_mil.py``'s), so the two
  tables are equal but for the wall times and ``stopped_early``, which JAX
  also sets for a trial that reaches the scheduler's max_t.
- Both modes: the artifacts, ``best_config`` the table's argmax, a config
  whose device is not ``cpu`` raising on a machine without a card.
"""

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from multimodal_isic_tpu.cli import tune_mil as JTM
from multimodal_isic_tpu_torch.cli import tune_mil as TTM
from multimodal_isic_tpu_torch.train import mil as TM

NC, F_DIM = 3, 8
ARGS = ["--model_type", "mil", "--num_samples", "3", "--cohort_size", "3",
        "--max_epochs", "2", "--patience", "2", "--grace_period", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _patch_frame(seed=0):
    rng = np.random.RandomState(seed)
    rows = []
    for pid in range(24):
        label = pid % NC
        for patch in rng.permutation(rng.randint(6, 10)):
            lat = rng.randn(F_DIM).astype(np.float32)
            lat[label] += 1.5
            rows.append({"image_path": f"/d/SYN_{pid:04d}_0.jpg",
                         "segmentation_path": "s", "target": label,
                         "patch_id": int(patch), "patch_latent": lat,
                         "patch_in_mask": 1, "patch_latent_pca": lat})
    return pd.DataFrame(rows)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_tune_mil")
    pkl = str(root / "patches.pkl")
    _patch_frame().to_pickle(pkl)
    configs = {}
    for name, device in (("jax", "tpu"), ("port", "cpu"), ("card", "")):
        path = root / f"{name}.yml"
        path.write_text(yaml.safe_dump({"seed": 42, "num_classes": NC,
                                        "device": device}))
        configs[name] = str(path)
    return root, pkl, configs


def _artifacts(out_dir):
    names = sorted(p.name for p in out_dir.iterdir())
    assert [n.split("_")[0] for n in names] == ["best", "hpo"], names
    table = pd.read_csv(out_dir / names[1])
    best = yaml.safe_load((out_dir / names[0]).read_text())
    return table, best


def _best_row_config(table):
    row = table.iloc[int(table["val_bacc"].astype(float).idxmax())]
    return {k.split("/", 1)[1]: row[k] for k in table.columns
            if k.startswith("config/")}


def test_packed_auto_matches_jax_tables(workspace, capsys):
    root, pkl, configs = workspace
    JTM.main(["--config_path", configs["jax"], *ARGS, "--patch_df", pkl,
              "--output_dir", str(root / "jax_auto")])
    out = TTM.main(["--config_path", configs["port"], *ARGS,
                    "--patch_df", pkl, "--output_dir",
                    str(root / "port_auto")])
    lines = capsys.readouterr().out.splitlines()
    want, jbest = _artifacts(root / "jax_auto")
    got, best = _artifacts(root / "port_auto")
    assert list(got.columns) == list(want.columns)
    assert list(got["trial_id"]) == list(want["trial_id"]) == [
        "cohort000_t00", "cohort000_t01", "cohort000_t02"]
    cfg_cols = [c for c in want.columns if c.startswith("config/")]
    pd.testing.assert_frame_equal(got[cfg_cols], want[cfg_cols])
    assert {"epochs_run", "stopped_early", "val_bacc"} <= set(got.columns)
    assert np.isfinite(got["val_bacc"]).all()
    assert set(best) == set(jbest) == {"best_config", "best_val_bacc"}
    assert best["best_config"] == out["best_config"]
    cfg = _best_row_config(got)
    assert {k: best["best_config"][k] for k in cfg} == pytest.approx(cfg)
    assert best["best_val_bacc"] == pytest.approx(got["val_bacc"].max())
    assert any(ln.startswith("Packed search: 3 trials") for ln in lines)


def test_packed_never_matches_jax_tables(workspace, monkeypatch):
    root, pkl, configs = workspace
    monkeypatch.setattr(JTM, "train_mil", lambda c, d, **kw: TM.train_mil(
        c, d, **{**kw, "device": "cpu"}))
    argv = [*ARGS, "--packed", "never", "--patch_df", pkl]
    JTM.main(["--config_path", configs["jax"], *argv, "--output_dir",
              str(root / "jax_never")])
    out = TTM.main(["--config_path", configs["port"], *argv,
                    "--output_dir", str(root / "port_never")])
    want, jbest = _artifacts(root / "jax_never")
    got, best = _artifacts(root / "port_never")
    assert list(got["trial_id"]) == [f"trial_{i:05d}" for i in range(3)]
    pd.testing.assert_frame_equal(
        got.drop(columns=["wall_s", "stopped_early"]),
        want.drop(columns=["wall_s", "stopped_early"]))
    assert not (got["stopped_early"] & ~want["stopped_early"]).any()
    assert not any(t.error for t in out["trials"])
    assert best == jbest
    assert best["best_config"] == out["best_config"]
    cfg = _best_row_config(got)
    assert {k: best["best_config"][k] for k in cfg} == pytest.approx(cfg)


def test_device_rule(workspace):
    """A config asking for the card raises here: nothing falls back to the
    CPU."""
    root, pkl, configs = workspace
    with pytest.raises(RuntimeError, match="CUDA"):
        TTM.main(["--config_path", configs["card"], *ARGS, "--patch_df", pkl,
                  "--output_dir", str(root / "card")])
