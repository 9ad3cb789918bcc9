"""The benchmark's files against its contract: every cell resolves its
files by name, names and units keep to their characters, and a new cell
needs only new files and entries."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["gpubench"]
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    from gpubench import common
    r = common.resolve(cell)
    assert r["builder"].exists() and r["driver"].exists()
    builder = common.builder(r["builder"])
    assert r["traffic"]["task"] in builder.TASKS
    assert hasattr(common.driver(r["driver"]), "run")
    names = {m["name"] for m in r["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert r["per_layer"]
    for m in r["per_layer"]:
        assert callable(common.metric_reader(m["name"]).read)
    assert set(r["limits"]) and all(v["limit"] > 0
                                    for v in r["limits"].values())


def test_names_units_and_keys():
    b = bench()
    metrics = b["end_to_end"] + b["per_layer"]
    for group in (b["configs"], b["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert 1 <= len(m["layer"]) <= 200
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpubench/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])


def test_roofline_names():
    for m in bench()["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_new_cell_by_new_files_only(tmp_path):
    """A later PR's cell: a traffic file, a limits file, a metric reader
    and entries in BENCHMARK.json; no file that is there changes."""
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    t = json.loads((ROOT / "gpubench/traffic/serve_bs128.json").read_text())
    t.update(batch=16, in_flight=1)
    (tmp_path / "gpubench/traffic/serve_bs16.json").write_text(json.dumps(t))
    cell = "effnet_b3_fusion.serve_bs16"
    (tmp_path / f"gpubench/limits/{cell}.json").write_text(
        (ROOT / "gpubench/limits/effnet_b3_fusion.serve_bs128.json").read_text())
    (tmp_path / "gpubench/metrics/launches.infer.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    b["workloads"].append({"name": cell, "config": "effnet_b3_fusion",
                           "traffic": "serve_bs16", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "launches.infer", "unit": "1",
                           "better": "lower", "source": "program_counter",
                           "layer": "host dispatch", "moves": "infer_img_s",
                           "workloads": [cell]})
    for m in b["end_to_end"]:
        if "workloads" in m and "effnet_b3_fusion.serve_bs128" in m["workloads"]:
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = ("import sys; sys.path.insert(0, '.'); from gpubench import common;"
            f"r = common.resolve('{cell}'); "
            "print(r['traffic']['batch'], [m['name'] for m in r['per_layer']],"
            " common.metric_reader('launches.infer').read({}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, check=True).stdout
    assert out.startswith("16") and "launches.infer" in out


def test_no_result_without_the_port(tmp_path):
    """In a directory holding only BENCHMARK.json and gpubench/, a run
    exits non-zero and prints no result line."""
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload",
         "effnet_b3_fusion.serve_bs128", "--seed", "4294967311",
         "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True)
    assert proc.returncode != 0 and '"correct"' not in proc.stdout
