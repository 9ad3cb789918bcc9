"""Classification metrics with sklearn semantics, in numpy.

Counterpart of ``multimodal_isic_tpu/core/metrics.py``: the definitions the
reference uses (``balanced_accuracy_score`` / ``classification_report``,
``net_utils.py:110-123``; ``precision_recall_fscore_support``,
``utils_g_mil.py:172-187``; ``roc_auc_score(multi_class='ovr')``, the MIL
trainables' 10-metric bundle :func:`evaluate_probs`).  Predictions come back
from the device once per batch or split, so the metrics run on the host.
``classification_report`` renders the same string as the JAX package's,
byte for byte.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray,
                     num_classes: int) -> np.ndarray:
    """[num_classes, num_classes] counts, rows = true class."""
    idx = np.asarray(y_true) * num_classes + np.asarray(y_pred)
    flat = np.bincount(idx, minlength=num_classes * num_classes)
    return flat.reshape(num_classes, num_classes)


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def balanced_accuracy(y_true: np.ndarray, y_pred: np.ndarray,
                      num_classes: int) -> float:
    """Mean recall over the classes present in ``y_true``."""
    cm = confusion_matrix(y_true, y_pred, num_classes).astype(np.float64)
    support = cm.sum(axis=1)
    present = support > 0
    recall = np.where(present, cm.diagonal() / np.maximum(support, 1.0), 0.0)
    return float(recall.sum() / max(int(present.sum()), 1))


def _tie_averaged_ranks(scores: np.ndarray) -> np.ndarray:
    """1-based average ranks with tie correction (Mann-Whitney
    convention)."""
    order = np.sort(scores)
    c_less = np.searchsorted(order, scores, side="left")
    c_leq = np.searchsorted(order, scores, side="right")
    return c_less + (c_leq - c_less + 1) / 2.0


def binary_auc(y_true01: np.ndarray, scores: np.ndarray) -> float:
    """ROC AUC of a binary problem by the rank statistic (tie-aware); NaN
    where one side is empty."""
    y_true01 = np.asarray(y_true01)
    ranks = _tie_averaged_ranks(np.asarray(scores))
    n_pos = float(np.sum(y_true01))
    n_neg = len(y_true01) - n_pos
    u = float(np.sum(ranks[y_true01 > 0])) - n_pos * (n_pos + 1.0) / 2.0
    denom = n_pos * n_neg
    return u / denom if denom > 0 else float("nan")


def roc_auc_ovr(y_true: np.ndarray, y_score: np.ndarray,
                num_classes: int) -> float:
    """Macro one-vs-rest AUC, ``roc_auc_score(y_true, y_score,
    multi_class='ovr')``.  sklearn raises where a class is absent from
    ``y_true`` and the reference turns that into NaN
    (``utils_g_mil.py:175-178``): NaN here too."""
    y_true = np.asarray(y_true)
    counts = np.bincount(y_true, minlength=num_classes)
    if not np.all(counts[:num_classes] > 0):
        return float("nan")
    return float(np.mean([binary_auc(y_true == c, y_score[:, c])
                          for c in range(num_classes)]))


def precision_recall_fscore(y_true: np.ndarray, y_pred: np.ndarray,
                            num_classes: int, average: str = "macro"
                            ) -> Dict[str, np.ndarray]:
    """``precision_recall_fscore_support(..., zero_division=0)``.  Macro
    averages run over labels present in ``y_true`` or ``y_pred``; weighted
    averages weight by true support."""
    cm = confusion_matrix(y_true, y_pred, num_classes).astype(np.float64)
    tp = cm.diagonal()
    support = cm.sum(axis=1)
    predicted = cm.sum(axis=0)
    precision = np.where(predicted > 0, tp / np.maximum(predicted, 1.0), 0.0)
    recall = np.where(support > 0, tp / np.maximum(support, 1.0), 0.0)
    pr = precision + recall
    f1 = np.where(pr > 0, 2.0 * precision * recall / np.maximum(pr, 1e-38),
                  0.0)
    present = (support > 0) | (predicted > 0)
    if average == "macro":
        n = max(int(present.sum()), 1)
        avg = lambda v: float(np.where(present, v, 0.0).sum() / n)
    elif average == "weighted":
        total = max(float(support.sum()), 1.0)
        avg = lambda v: float((v * support).sum() / total)
    else:
        raise ValueError(f"unsupported average={average!r}")
    return {
        "precision": avg(precision), "recall": avg(recall), "f1": avg(f1),
        "per_class_precision": precision, "per_class_recall": recall,
        "per_class_f1": f1, "support": support,
    }


def evaluate_probs(y_true: np.ndarray, y_score: np.ndarray,
                   num_classes: int, loss: Optional[float] = None
                   ) -> Dict[str, float]:
    """The 10-metric bundle of the MIL trainables (``utils_g_mil.py:
    150-187``): acc, bacc, auc, macro and weighted P/R/F1, and ``loss``
    where given."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    y_pred = np.argmax(y_score, axis=1)
    macro = precision_recall_fscore(y_true, y_pred, num_classes, "macro")
    weighted = precision_recall_fscore(y_true, y_pred, num_classes,
                                       "weighted")
    out = {
        "acc": accuracy(y_true, y_pred),
        "bacc": balanced_accuracy(y_true, y_pred, num_classes),
        "auc": roc_auc_ovr(y_true, y_score, num_classes),
        "macro_p": macro["precision"], "macro_r": macro["recall"],
        "macro_f1": macro["f1"],
        "weighted_p": weighted["precision"],
        "weighted_r": weighted["recall"], "weighted_f1": weighted["f1"],
    }
    if loss is not None:
        out["loss"] = float(loss)
    return out


def classification_report(y_true: np.ndarray, y_pred: np.ndarray,
                          digits: int = 5, target_names=None) -> str:
    """sklearn-layout text report (the reference uses digits=5,
    ``net_utils.py:112``)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    labels = np.unique(np.concatenate([y_true, y_pred]))
    if target_names is None:
        target_names = [str(l) for l in labels]

    rows = []
    supports = []
    for lbl in labels:
        tp = np.sum((y_true == lbl) & (y_pred == lbl))
        fp = np.sum((y_true != lbl) & (y_pred == lbl))
        fn = np.sum((y_true == lbl) & (y_pred != lbl))
        p = tp / (tp + fp) if (tp + fp) > 0 else 0.0
        r = tp / (tp + fn) if (tp + fn) > 0 else 0.0
        f = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
        s = int(np.sum(y_true == lbl))
        rows.append((p, r, f, s))
        supports.append(s)
    supports = np.array(supports, dtype=float)
    total = int(supports.sum())

    headers = ["precision", "recall", "f1-score", "support"]
    name_width = max(max(len(n) for n in target_names), len("weighted avg"),
                     digits)
    head_fmt = "{:>{width}s} " + " {:>9}" * len(headers) + "\n"
    report = head_fmt.format("", *headers, width=name_width) + "\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for name, (p, r, f, s) in zip(target_names, rows):
        report += row_fmt.format(name, p, r, f, s, width=name_width,
                                 digits=digits)
    report += "\n"

    acc = float(np.mean(y_true == y_pred)) if len(y_true) else 0.0
    acc_fmt = "{:>{width}s} " + " {:>9}" * 2 + " {:>9.{digits}f}" + " {:>9}\n"
    report += acc_fmt.format("accuracy", "", "", acc, total, width=name_width,
                             digits=digits)

    ps, rs, fs, _ = zip(*rows)
    macro = (float(np.mean(ps)), float(np.mean(rs)), float(np.mean(fs)))
    w = supports / supports.sum() if supports.sum() > 0 else supports
    weighted = (float(np.sum(w * ps)), float(np.sum(w * rs)),
                float(np.sum(w * fs)))
    report += row_fmt.format("macro avg", *macro, total, width=name_width,
                             digits=digits)
    report += row_fmt.format("weighted avg", *weighted, total,
                             width=name_width, digits=digits)
    return report
