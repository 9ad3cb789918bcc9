"""What every part of the benchmark shares: where its files are, how a cell
resolves to its files by name, seeds, and loading a module from a path.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.  The
harness finds every file of a cell by those names, so a new cell, mix,
configuration or per-layer metric is a new file plus a new entry:

- ``configs/<config>.json``: the configuration's sizes, its source and its
  ``builder`` (``builders/<builder>.py``: the port's side and the
  reference's side);
- ``traffic/<traffic>.json``: the mix's parameters and its ``driver``
  (``drivers/<driver>.py``);
- ``limits/<cell>.json``: the limits that decide ``correct``, with the
  readings they were set from;
- ``metrics/<metric>.py``: one reader a per-layer metric.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_isic_tpu")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """Import the Python file ``path`` under the module name ``name`` (file
    names may hold dots, as metric names do)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def benchmark(path: Path = BENCHMARK) -> Dict[str, Any]:
    return load_json(path)


def resolve(cell: str, bench: Dict[str, Any] = None) -> Dict[str, Any]:
    """A cell's name → its entry, configuration, traffic, limits, builder,
    driver and the metrics it reports (end-to-end and per-layer entries of
    ``BENCHMARK.json`` that apply to it)."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits_path = HERE / "limits" / f"{cell}.json"

    def applies(metric):
        return cell in metric.get("workloads", [cell])

    return {
        "entry": entry, "config": config, "traffic": traffic,
        "limits": load_json(limits_path)["limits"],
        "builder": HERE / "builders" / f"{config['builder']}.py",
        "driver": HERE / "drivers" / f"{traffic['driver']}.py",
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def builder(path: Path) -> ModuleType:
    return load_module(path, f"gpubench_builder_{path.stem}")


def driver(path: Path) -> ModuleType:
    return load_module(path, f"gpubench_driver_{path.stem}")


def metric_reader(name: str) -> ModuleType:
    path = HERE / "metrics" / f"{name}.py"
    return load_module(path, "gpubench_metric_" + name.replace(".", "_"))


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose (weights, pool, order, augment, ...)
    from the run's ``--seed``, which may exceed 32 bits."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & 0x7FFFFFFFFFFFFFFF


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (the port's name begins with the JAX
    package's)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@contextlib.contextmanager
def no_gc():
    """Python's cyclic garbage collector off inside the window, so its
    pauses land in set-up and not in a batch's latency."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
