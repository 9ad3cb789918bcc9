"""Readings that set a cell's limits: the program's numbers on many seeds,
the control's (the reference in the next lower precision put in the
program's place) and, for a training cell, the planted fault of a step on
half its batch.  One process; the control reads the seeds it shares with
the program from the same set-up.

    python3 gpubench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2] [--fault-seeds 4,5,6] [--seconds 2]

Prints one JSON line a reading and a summary (the largest program reading
and the smallest control and fault readings of each number), and writes
them to ``chiprun_out/calibrate_<cell>.json``.  Not run by the benchmark's
runs.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def half_batch(task):
    """The fault: each step trains on the first half of its rows, the
    loss their mean."""
    step = task.model_step

    def broken(x, batch):
        h = x.shape[0] // 2
        return step(x[:h], {k: v[:h] for k, v in batch.items()})

    task.model_step = broken


def reading(r, seed, seconds, what, device):
    """→ {name: numbers} of ``what``: 'program' (with 'control' too when
    ``what`` is 'program+control') or 'fault'."""
    import torch
    from gpubench import common
    builder = common.builder(r["builder"])
    driver = common.driver(r["driver"])
    traffic = r["traffic"]
    task = builder.make(traffic["task"], r["config"], traffic, seed, device)
    if what == "fault":
        half_batch(task)
    readings = driver.run(task, traffic, seed, seconds, False, device)
    task.release()
    gc.collect()
    torch.cuda.empty_cache()
    out = {what.split("+")[0]: driver.check(task, readings, device)}
    if what.endswith("+control"):
        out["control"] = driver.control(task, readings, device)
    del task, readings
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch
    from gpubench import common
    r = common.resolve(args.workload)
    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ints = lambda text: [int(s) for s in text.split(",") if s]
    control = set(ints(args.control_seeds))
    plan = [("program+control" if s in control else "program", s)
            for s in ints(args.seeds)]
    plan += [("fault", s) for s in ints(args.fault_seeds)]
    rows = []
    for what, seed in plan:
        t0 = time.perf_counter()
        out = reading(r, seed, args.seconds, what, device)
        for name, numbers in out.items():
            row = {"what": name, "seed": seed, "numbers": numbers,
                   "seconds": time.perf_counter() - t0}
            print(json.dumps(row), flush=True)
            rows.append(row)
    summary = {}
    for what, pick in (("program", max), ("control", min), ("fault", min)):
        vals = [x["numbers"] for x in rows if x["what"] == what]
        if vals:
            summary[what] = {k: pick(v[k] for v in vals) for k in vals[0]}
    summary["card"] = torch.cuda.get_device_name(0)
    print(json.dumps({"summary": summary}), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / f"calibrate_{args.workload}.json", "w") as f:
        json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
