"""MIL cross-validation (the ``use_latent.py`` workload).

Counterpart of ``multimodal_isic_tpu/train/cv.py`` (:32-210): patient-level
``StratifiedKFold`` (sklearn's membership), a fold re-seeded with ``seed +
fold`` (``use_latent.py:270-274``), AttentionMIL or GraphMIL from
``config['best_params*']`` with the reference's defaults, both best
snapshots evaluated on the held-out fold, nanmean / nanstd over the folds,
and the CSV written after every fold: a failing fold gives a NaN row
instead of ending the run (``use_latent.py:157-170,472-547``).  The
per-checkpoint sweep (:func:`sweep_ae_checkpoints`) re-extracts the bags
for each AE checkpoint, runs the CV and writes the cross-model CSV and a
config snapshot with its sha1 header.  pandas and yaml are imported where
a frame or a file is written.
"""

from __future__ import annotations

import hashlib
import os
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.splits import StratifiedKFold
from .mil import Device, train_graph_mil, train_mil

METRIC_KEYS = ("bacc", "acc", "auc", "loss", "macro_f1", "weighted_f1")
TEST_METRIC_KEYS = ("bacc", "acc", "auc", "loss", "macro_p", "macro_r",
                    "macro_f1", "weighted_p", "weighted_r", "weighted_f1")


def _fold_metrics(final: Dict, test_best_loss: Optional[Dict],
                  test_best_bacc: Optional[Dict] = None) -> Dict[str, float]:
    row = {f"val_{k}": float(final.get(f"val_{k}", np.nan))
           for k in METRIC_KEYS}
    bacc_dict = test_best_bacc if test_best_bacc is not None else {
        k: final.get(f"test_{k}", np.nan) for k in METRIC_KEYS}
    for k in TEST_METRIC_KEYS:
        row[f"test_{k}_best_bacc"] = float(bacc_dict.get(k, np.nan))
        row[f"test_{k}_best_loss"] = float(
            (test_best_loss or {}).get(k, np.nan))
    return row


def fold_splits(labels: Sequence[int], n_folds: int = 5, seed: int = 42):
    """The patient folds: (train indices, test indices) a fold."""
    labels = np.asarray([int(l) for l in labels])
    kf = StratifiedKFold(n_folds, shuffle=True, random_state=seed)
    return list(kf.split(np.zeros((len(labels), 1)), labels))


def cross_validate_mil(
    bags: Sequence[np.ndarray],
    labels: Sequence[int],
    model_kind: str = "mil",            # 'mil' | 'graph-mil'
    config: Optional[Dict] = None,
    n_folds: int = 5,
    seed: int = 42,
    num_classes: int = 7,
    max_epochs: int = 200,
    patience: int = 16,
    csv_path: Optional[str] = None,
    logger=None,
    device: Device = "cuda",
) -> Dict:
    """→ {folds: [a row a fold], summary: {metric: (nanmean, nanstd)},
    frame: the rows as a DataFrame}."""
    import pandas as pd  # local: host-only dependency

    config = dict(config or {})
    labels = np.asarray([int(l) for l in labels])
    trainable = train_graph_mil if model_kind == "graph-mil" else train_mil
    if model_kind == "mil":
        config.setdefault("hidden_dim", 128)
        config.setdefault("att_dim", 64)
        config.setdefault("dropout", 0.5)
        config.setdefault("optimizer", "adam")
        config.setdefault("lr", 1e-4)

    rows: List[Dict] = []
    for fold, (tr_idx, te_idx) in enumerate(fold_splits(labels, n_folds,
                                                        seed)):
        data = {"train_feats": [bags[i] for i in tr_idx],
                "train_labels": labels[tr_idx],
                "test_feats": [bags[i] for i in te_idx],
                "test_labels": labels[te_idx]}
        try:
            final = trainable(config, data, seed=seed + fold,
                              num_classes=num_classes, patience=patience,
                              max_epochs=max_epochs, device=device)
            row = {"fold": fold, "error": "",
                   **_fold_metrics(final, final.get("_test_best_loss"),
                                   final.get("_test_best_bacc"))}
        except Exception as e:  # a NaN row keeps the run alive
            traceback.print_exc()
            row = {"fold": fold, "error": str(e),
                   **{k: np.nan for k in _fold_metrics({}, None)}}
        rows.append(row)
        if logger is not None:
            logger.log_dict({k: v for k, v in row.items()
                             if isinstance(v, float)}, step=fold,
                            prefix=f"fold{fold}/")
        if csv_path:  # incremental, crash-safe persistence
            pd.DataFrame(rows).to_csv(csv_path, index=False)

    frame = pd.DataFrame(rows)
    summary = {}
    for col in frame.columns:
        if col in ("fold", "error"):
            continue
        vals = frame[col].astype(float).values
        summary[col] = (float(np.nanmean(vals)), float(np.nanstd(vals)))
    return {"folds": rows, "summary": summary, "frame": frame}


# -------------------------------------------- per-AE-checkpoint CV sweep

# the reference's result row (use_latent.py:494-535): our metric key → its
# column stem ('micro' is plain accuracy in its _evaluate_model)
SWEEP_COLS = (("acc", "micro_accuracy"), ("macro_p", "macro_precision"),
              ("macro_r", "macro_recall"), ("macro_f1", "macro_f1"),
              ("weighted_p", "weighted_precision"),
              ("weighted_r", "weighted_recall"),
              ("weighted_f1", "weighted_f1"))


def _nan_sweep_row(run_id: str, checkpoint_type: str, error: str = ""
                   ) -> Dict:
    row = {"id": run_id, "checkpoint_type": checkpoint_type, "error": error}
    for _, col in SWEEP_COLS:
        row[col] = np.nan
        row[f"{col}_std"] = np.nan
    return row


def sweep_ae_checkpoints(
    model_names: Sequence[str],
    extract_bags_fn: Callable[[str], Tuple[Sequence[np.ndarray],
                                           Sequence[int]]],
    model_kind: str = "mil",
    config: Optional[Dict] = None,
    *,
    run_ids: Optional[Sequence[str]] = None,
    n_folds: int = 5,
    seed: int = 42,
    num_classes: int = 7,
    max_epochs: int = 200,
    patience: int = 16,
    out_csv: Optional[str] = None,
    config_snapshot: Optional[Dict] = None,
    config_out: Optional[str] = None,
    logger=None,
    device: Device = "cuda",
):
    """The reference's cross-checkpoint loop (``use_latent.py:69-81,
    142-170,494-547``; JAX :132-210): for each AE checkpoint, re-extract
    the bags (``extract_bags_fn(model_name) → (bags, labels)``), run the
    patient-level CV and append two rows ('best_bacc', 'best_loss') of
    nanmean ± nanstd test metrics.  A checkpoint that fails gives NaN rows
    and the sweep goes on; ``out_csv`` is rewritten after every model, and
    the config snapshot with its sha1 header is written once.  → the rows
    as a DataFrame."""
    import pandas as pd  # local: host-only dependencies
    import yaml

    results_rows: List[Dict] = []

    def persist():
        if out_csv:
            os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
            pd.DataFrame(results_rows).to_csv(out_csv, index=False)
        if config_out and config_snapshot is not None \
                and not os.path.exists(config_out):
            cfg = yaml.safe_dump(config_snapshot, sort_keys=False)
            cfg_hash = hashlib.sha1(cfg.encode("utf-8")).hexdigest()[:8]
            with open(config_out, "w") as f:
                f.write(f"# config_hash: {cfg_hash}\n{cfg}")

    for idx, model_name in enumerate(model_names):
        run_id = run_ids[idx] if run_ids is not None else f"manual_{idx}"
        print(f"\n=== Processing run {idx} - model: {model_name} ===")
        np.random.seed(seed)  # the reference re-seeds before each model
        try:
            bags, labels = extract_bags_fn(model_name)
        except Exception as e:  # NaN rows keep the sweep alive
            traceback.print_exc()
            print(f"  Error extracting latents for {model_name}: {e}")
            results_rows.append(_nan_sweep_row(run_id, "best_bacc", str(e)))
            results_rows.append(_nan_sweep_row(run_id, "best_loss", str(e)))
            persist()
            continue

        frame = cross_validate_mil(
            bags, labels, model_kind=model_kind, config=config,
            n_folds=n_folds, seed=seed, num_classes=num_classes,
            max_epochs=max_epochs, patience=patience,
            device=device)["frame"]
        for ctype in ("best_bacc", "best_loss"):
            row = {"id": run_id, "checkpoint_type": ctype, "error": ""}
            for key, col in SWEEP_COLS:
                vals = frame[f"test_{key}_{ctype}"].astype(float).values
                all_nan = bool(np.all(np.isnan(vals)))
                row[col] = np.nan if all_nan else float(np.nanmean(vals))
                row[f"{col}_std"] = (np.nan if all_nan
                                     else float(np.nanstd(vals)))
            results_rows.append(row)
        if logger is not None:  # the reference's wandb.log summary
            last_b, last_l = results_rows[-2], results_rows[-1]
            logger.log_dict({
                "best_bacc/micro_accuracy": last_b["micro_accuracy"],
                "best_bacc/macro_f1": last_b["macro_f1"],
                "best_bacc/weighted_f1": last_b["weighted_f1"],
                "best_loss/micro_accuracy": last_l["micro_accuracy"],
                "best_loss/macro_f1": last_l["macro_f1"],
                "best_loss/weighted_f1": last_l["weighted_f1"],
            }, step=idx, prefix=f"{run_id}/")
        persist()

    return pd.DataFrame(results_rows)
