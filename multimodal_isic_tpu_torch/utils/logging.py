"""Local experiment tracking (the reference's Neptune/wandb, kept local).

Counterpart of ``multimodal_isic_tpu/utils/logging.py`` (:19-80): a run
directory under ``log_dir`` with ``metrics.jsonl`` (one event a line: wall
time since the run began, name, value, optional step), ``config.json`` and
``attributes.json``, so runs of both packages read alike.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class RunLogger:
    def __init__(self, log_dir: str = "runs", run_name: Optional[str] = None,
                 config: Optional[Dict[str, Any]] = None, stdout: bool = True):
        self.run_name = run_name or time.strftime("%Y%m%d_%H%M%S")
        self.dir = os.path.join(log_dir, self.run_name)
        os.makedirs(self.dir, exist_ok=True)
        self._file = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._stdout = stdout
        self._t0 = time.time()
        if config is not None:
            with open(os.path.join(self.dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, name: str, value, step: Optional[int] = None) -> None:
        """Append a time-series point (Neptune ``run[name].log(v)``)."""
        event = {"t": round(time.time() - self._t0, 3), "name": name,
                 "value": float(value) if hasattr(value, "__float__") else value}
        if step is not None:
            event["step"] = int(step)
        self._file.write(json.dumps(event) + "\n")
        self._file.flush()

    def log_dict(self, values: Dict[str, Any], step: Optional[int] = None,
                 prefix: str = "") -> None:
        for k, v in values.items():
            self.log(prefix + k, v, step)

    def assign(self, name: str, value) -> None:
        """Set a run-level attribute (Neptune ``run[name] = v``)."""
        path = os.path.join(self.dir, "attributes.json")
        attrs = {}
        if os.path.exists(path):
            with open(path) as f:
                attrs = json.load(f)
        attrs[name] = (value if isinstance(value, (int, float, str, bool, list,
                                                   dict)) else str(value))
        with open(path, "w") as f:
            json.dump(attrs, f, indent=2)

    def artifact_path(self, name: str) -> str:
        path = os.path.join(self.dir, "artifacts")
        os.makedirs(path, exist_ok=True)
        return os.path.join(path, name)

    def print(self, msg: str) -> None:
        if self._stdout:
            print(msg, flush=True)

    def close(self) -> None:
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_metrics(run_dir: str):
    """A run's ``metrics.jsonl`` as a list of events."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]
