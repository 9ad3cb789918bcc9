"""Experiment aggregation and report tooling (the reference's
``fetch_experiments.py``, pointed at local runs instead of Neptune).

Counterpart of ``multimodal_isic_tpu/utils/reporting.py`` (:1-82), its
code copied:

- parse sklearn-style classification-report text back into a metric dict
  (the regex semantics of ``fetch_experiments.py:67-103``);
- collect runs from a local ``runs/`` directory (``utils.logging.RunLogger``
  output, the same layout as the JAX package's), filterable by attributes;
- aggregate metric columns to ``mean ± std`` LaTeX table rows
  (``fetch_experiments.py:140-158``).

pandas is imported where a frame is built or read.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Sequence

import numpy as np


def parse_classification_report(text: str) -> Dict[str, float]:
    """Per-class + accuracy + macro/weighted avg rows → flat metric dict
    (keys like 'precision_0', 'recall_macro avg', 'accuracy', 'support_1')."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("precision"):
            continue
        m = re.match(r"^(.*?)\s+([\d.]+)\s+([\d.]+)\s+([\d.]+)\s+(\d+)$", line)
        if m:
            name = m.group(1).strip()
            out[f"precision_{name}"] = float(m.group(2))
            out[f"recall_{name}"] = float(m.group(3))
            out[f"f1-score_{name}"] = float(m.group(4))
            out[f"support_{name}"] = float(m.group(5))
            continue
        m = re.match(r"^accuracy\s+([\d.]+)\s+(\d+)$", line)
        if m:
            out["accuracy"] = float(m.group(1))
            out["support_total"] = float(m.group(2))
    return out


def collect_runs(log_dir: str = "runs",
                 where: Optional[Dict[str, object]] = None):
    """One row per run: attributes + the LAST value of each logged metric
    → a pandas DataFrame."""
    import pandas as pd
    rows = []
    if not os.path.isdir(log_dir):
        return pd.DataFrame()
    for run_name in sorted(os.listdir(log_dir)):
        run_dir = os.path.join(log_dir, run_name)
        attrs_path = os.path.join(run_dir, "attributes.json")
        metrics_path = os.path.join(run_dir, "metrics.jsonl")
        if not os.path.isdir(run_dir):
            continue
        row: Dict[str, object] = {"run": run_name}
        if os.path.exists(attrs_path):
            with open(attrs_path) as f:
                row.update(json.load(f))
        if os.path.exists(metrics_path):
            with open(metrics_path) as f:
                for line in f:
                    if line.strip():
                        event = json.loads(line)
                        row[event["name"]] = event["value"]
        if where and any(row.get(k) != v for k, v in where.items()):
            continue
        rows.append(row)
    return pd.DataFrame(rows)


def latex_row(frame, columns: Sequence[str], label: str = "",
              digits: int = 2, scale: float = 100.0) -> str:
    """``label & mean ± std & ...`` over the given metric columns of a
    pandas DataFrame."""
    import pandas as pd
    cells = [label] if label else []
    for col in columns:
        vals = pd.to_numeric(frame[col], errors="coerce").values * scale
        cells.append(f"{np.nanmean(vals):.{digits}f} $\\pm$ "
                     f"{np.nanstd(vals):.{digits}f}")
    return " & ".join(cells) + r" \\"
