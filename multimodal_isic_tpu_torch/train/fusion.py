"""Fusion classifier evaluation (the reference's ``net_utils.py`` test pass).

Counterpart of the eval side of ``multimodal_isic_tpu/train/fusion.py``:
``BATCH_KEYS``, ``cross_entropy``, ``make_fusion_eval_step`` and
``evaluate_test`` → (accuracy, classification_report digits=5)
(``net_utils.py:86-127``).  Single process: predictions come to the host with
``.cpu().numpy()``.  The model holds its weights, so the eval step takes a
batch only.  The training step and epochs come with the training port.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import metrics as M

BATCH_KEYS = ("image", "radiomics", "age", "sex", "loc", "artifacts")


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, targets.long())


def make_fusion_eval_step(model: torch.nn.Module
                          ) -> Callable[[Dict[str, torch.Tensor]],
                                        Tuple[torch.Tensor, torch.Tensor]]:
    """batch → (mean cross-entropy, logits), in eval mode without autograd."""
    model.eval()

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]):
        logits = model(**{k: batch[k] for k in BATCH_KEYS if k in batch})
        return cross_entropy(logits, batch["target"]), logits

    return step


def evaluate_test(eval_fn, loader: Iterable[Dict[str, torch.Tensor]],
                  logger=None, num_classes: int = 7,
                  n_true: Optional[int] = None) -> Tuple[float, str]:
    """→ (accuracy, classification_report).  ``logger`` (optional) receives
    ``assign(key, value)`` for accuracy, balanced accuracy and the report,
    and ``print(text)``; ``n_true`` trims padded trailing rows."""
    preds, targets = [], []
    for batch in loader:
        _, logits = eval_fn(batch)
        preds.append(logits.argmax(dim=1).cpu().numpy())
        targets.append(batch["target"].cpu().numpy())
    y_pred = np.concatenate(preds)[:n_true]
    y_true = np.concatenate(targets)[:n_true]
    acc = float(np.mean(y_pred == y_true))
    bacc = M.balanced_accuracy(y_true, y_pred, num_classes)
    report = M.classification_report(y_true, y_pred, digits=5)
    if logger is not None:
        logger.assign("test/accuracy", acc)
        logger.assign("test/balanced_accuracy", bacc)
        logger.assign("test/classification_report", report)
        logger.print(f"Test Accuracy: {acc:.4f}")
        logger.print("Classification Report:\n" + report)
    return acc, report
