"""Port parity for the clustering and tooling CLIs: ``cli/cluster_latents.py``
and ``cli/fetch_experiments.py`` (with ``utils/reporting.py``) against the
JAX package on the CPU.

The patch frame: 480 rows, 24 images of 12 patients in 4 classes, 24-dim
latents in 8 Gaussian blobs (so ``--embed pca`` projects to 20 dims), a
fifth of the patches in another class's blob and a tenth scattered (noise
and impure clusters for the filter).
Tolerances:

- ``--embed pca --clusterer density``: JAX's printed lines, cluster labels
  and ``df_filtered.pkl`` (columns and values; integer widths aside), on
  the same latents (the two PCAs agree within float32 rounding);
- the default k-means backbone: its statistics columns equal JAX's
  ``cluster_purity_stats`` and filter recomputed on the port's labels;
- ``--viz_out`` writes both PNGs and the HTML page, on the neighbour
  embedding, the density clustering and the approximate graph;
- ``fetch_experiments`` prints JAX's output over one run directory, and the
  reporting functions give JAX's values.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from multimodal_isic_tpu.analysis import cluster as JC
from multimodal_isic_tpu.cli import cluster_latents as JCL
from multimodal_isic_tpu.cli import fetch_experiments as JFE
from multimodal_isic_tpu.utils import reporting as JR
from multimodal_isic_tpu_torch.cli import cluster_latents as TCL
from multimodal_isic_tpu_torch.cli import fetch_experiments as TFE
from multimodal_isic_tpu_torch.utils import reporting as TR
from multimodal_isic_tpu_torch.utils.logging import RunLogger

NC = 4
STAT_COLUMNS = ("cluster_same_count", "cluster_other_count",
                "cluster_prop_same", "cluster_ratio_same_other",
                "cluster_prop_same_weighted")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("cluster")
    rng = np.random.RandomState(0)
    centers = rng.randn(8, 24) * 3.0
    rows = []
    for img in range(24):
        pid, label = img // 2, (img // 2) % NC
        for patch in range(20):
            # a fifth of the patches in another class's blob, a tenth
            # scattered: impure clusters and noise
            blob = (2 * label + (patch % 2) if rng.rand() < 0.8
                    else rng.randint(8))
            spread = 0.5 if rng.rand() < 0.9 else 4.0
            lat = (centers[blob] + rng.randn(24) * spread).astype(np.float32)
            rows.append({"image_path": f"/d/ISIC_{pid:04d}_{img}.jpg",
                         "target": label, "patch_id": patch,
                         "patch_latent_pca": lat})
    frame = root / "patches.pkl"
    pd.DataFrame(rows).to_pickle(frame)
    cfg = root / "config.yml"
    cfg.write_text(yaml.safe_dump({"seed": 42, "device": "cpu",
                                   "num_classes": NC}))
    return root, str(frame), str(cfg)


def _args(ws, out, *extra):
    root, frame, cfg = ws
    return ["--config_path", cfg, "--patch_df", frame,
            "--out", str(root / out), *extra]


def test_density_cli_equals_jax(workspace, capsys):
    flags = ("--embed", "pca", "--clusterer", "density",
             "--min_cluster_size", "15", "--min_samples", "5")
    JCL.main(_args(workspace, "jax.pkl", *flags))
    want_out = capsys.readouterr().out
    TCL.main(_args(workspace, "port.pkl", *flags))
    got_out = capsys.readouterr().out
    assert got_out == want_out
    root = workspace[0]
    want = pd.read_pickle(root / "jax.pkl")
    got = pd.read_pickle(root / "port.pkl")
    assert list(got.columns) == list(want.columns)
    assert "Number of clusters found: 1 " not in got_out
    assert "(+ 0 noise" not in got_out and len(got) < 480
    pd.testing.assert_frame_equal(got, want, check_dtype=False)


def test_kmeans_cli_statistics_equal_jax(workspace, monkeypatch):
    seen = {}
    fit = TCL.KM.fit_best_of

    def recording(*args, **kwargs):
        seen["out"] = fit(*args, **kwargs)
        return seen["out"]

    monkeypatch.setattr(TCL.KM, "fit_best_of", recording)
    TCL.main(_args(workspace, "kmeans.pkl", "--k", "6"))
    labels = seen["out"][1].numpy()
    frame = pd.read_pickle(workspace[1])
    pids = frame["image_path"].map(lambda p: p.split("_")[1])
    patient = frame.assign(pid=pids).groupby("pid")["target"].agg(
        lambda s: s.mode()[0]).values
    stats = JC.cluster_purity_stats(labels, frame["target"].values, NC,
                                    JC.patient_class_weights(patient, NC))
    keep, _ = JC.filter_low_purity_clusters(stats, 10)
    got = pd.read_pickle(workspace[0] / "kmeans.pkl")
    assert len(np.unique(labels)) == 6 and len(got) == keep.sum()
    np.testing.assert_array_equal(got["cluster"], labels[keep])
    for key in STAT_COLUMNS:
        np.testing.assert_array_equal(got[key], stats[key][keep])
    for c in range(NC):
        np.testing.assert_array_equal(got[f"cluster_count_class_{c}"],
                                      stats["counts_per_class"][keep, c])


def test_viz_out_writes_both_pngs_and_the_page(workspace, capsys):
    root = workspace[0]
    prefix = str(root / "viz")
    TCL.main(_args(workspace, "viz.pkl", "--embed", "neighbor",
                   "--clusterer", "density", "--knn_method", "approx",
                   "--min_cluster_size", "15", "--min_samples", "5",
                   "--viz_out", prefix))
    out = capsys.readouterr().out
    for suffix in ("_euclidean.png", "_cosine.png", "_interactive.html"):
        path = prefix + suffix
        assert os.path.getsize(path) > 1000 and f"Wrote {path}" in out
    assert open(prefix + "_interactive.html").read().count('"c": ') == 480
    assert len(pd.read_pickle(root / "viz.pkl")) > 0


def test_fetch_experiments_prints_jax_output(tmp_path, capsys):
    report = ("              precision    recall  f1-score   support\n\n"
              "           0       0.80      0.67      0.73         6\n"
              "           1       0.50      0.67      0.57         3\n\n"
              "    accuracy                           0.67         9\n"
              "   macro avg       0.65      0.67      0.65         9\n"
              "weighted avg       0.70      0.67      0.68         9\n")
    for i, acc in enumerate([0.8, 0.9, 0.65]):
        with RunLogger(str(tmp_path), run_name=f"r{i}", stdout=False) as lg:
            lg.assign("group_tags", ["image", "clinical"] if i < 2
                      else ["image"])
            lg.assign("test/classification_report", report)
            lg.log("test/accuracy", acc)
            lg.log("test/balanced_accuracy", acc - 0.1)
    assert TR.parse_classification_report(report) == \
        JR.parse_classification_report(report)
    pd.testing.assert_frame_equal(TR.collect_runs(str(tmp_path)),
                                  JR.collect_runs(str(tmp_path)))
    frame = TR.collect_runs(str(tmp_path), where={"run": "r1"})
    assert len(frame) == 1
    assert TR.latex_row(frame, ["test/accuracy"], "x") == \
        JR.latex_row(frame, ["test/accuracy"], "x")
    for argv in ([], ["--group-tag", "clinical", "--label", "c",
                      "--metric", "test/accuracy", "recall_macro avg"]):
        argv = ["--log_dir", str(tmp_path), *argv]
        JFE.main(argv)
        want = capsys.readouterr().out
        TFE.main(argv)
        assert capsys.readouterr().out == want
    TFE.main(["--log_dir", str(tmp_path / "none")])
    assert capsys.readouterr().out == "No runs found.\n"
