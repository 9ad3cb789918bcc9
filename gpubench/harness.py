"""One run of one cell: set-up, the window, the check, the metrics and the
result line.

``run_cell`` builds the cell's task from its configuration's builder, hands
it to the traffic's driver (set-up, warm-up, the window and, traced, a
profiled segment), reads the peak memory, frees the port's state, runs the
reference over the sampled answers or the first steps, and compares them
against ``limits/<cell>.json``.  With ``trace`` off the metrics are the
cell's end-to-end ones, measured by the harness's host clock; with it on,
the cell's per-layer metrics, each read by ``metrics/<name>.py``.
"""

from __future__ import annotations

import gc
import sys
from typing import Dict, Optional

import numpy as np

from . import common


def _end_to_end(name: str, readings: Dict, setup_s: float) -> float:
    if name == "setup_s":
        return setup_s
    if name in ("infer_img_s", "train_img_s"):
        return readings["img_s"]
    if name == "infer_p95_ms":
        return float(np.percentile(np.asarray(readings["latency_s"]), 95)) * 1e3
    raise KeyError(f"no end-to-end metric {name!r}")


def device_block(device, peak: int) -> Dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak}


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: Optional[str] = None,
             resolved: Optional[Dict] = None, fault=None) -> Dict:
    """→ the result line's object, its ``checks`` last.  ``device``
    defaults to the card; ``resolved`` replaces the cell's files (tests);
    ``fault(task)`` breaks the timed path before the window (tests)."""
    import torch
    r = common.resolve(cell) if resolved is None else resolved
    dev = torch.device(device or "cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    builder = common.builder(r["builder"])
    driver = common.driver(r["driver"])
    traffic = r["traffic"]
    task = builder.make(traffic["task"], r["config"], traffic, seed, dev)
    if fault is not None:
        fault(task)
    readings = driver.run(task, traffic, seed, seconds, trace, dev)
    setup_s = readings["t_window"] - t_start
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    task.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = driver.check(task, readings, dev)
    checks = {k: {"value": numbers[k], "limit": v["limit"]}
              for k, v in r["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if trace:
        ctx = {"cell": cell, "config": r["config"], "traffic": traffic,
               "readings": readings, "builder": builder,
               "segment": readings.get("segment"), "memory_peak_bytes": peak}
        for m in r["per_layer"]:
            value = common.metric_reader(m["name"]).read(ctx)
            if value is None:
                raise RuntimeError(f"per-layer metric {m['name']} found "
                                   f"nothing to read in {cell}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in r["end_to_end"]:
            metrics[m["name"]] = {"value": _end_to_end(m["name"], readings,
                                                       setup_s),
                                  "unit": m["unit"]}
    out = {"correct": correct,
           "attempted": readings.get("batches", readings.get("steps")),
           "failed": 0, "metrics": metrics,
           "device": device_block(dev, peak)}
    seg = readings.get("segment")
    if trace and seg is not None:
        out["device"].update(busy_s=seg["busy_s"], window_s=seg["window_s"])
        out["breakdown"] = {"device_ops": seg["device_ops"],
                            "idle_gaps": seg["idle_gaps"]}
    out["checks"] = checks
    return out


def print_checks(checks: Dict) -> None:
    """Each number compared beside its limit, as the last lines on
    standard error."""
    for name, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr, flush=True)

