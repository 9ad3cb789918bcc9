"""Several runs of one cell, each a process of its own, and their spread.

    python3 gpubench/sets.py --workload <cell> --seeds 11,12,13 --seconds 20 \
        [--trace 0] [--tag a]

Runs ``run.py`` once a seed, in turn, and keeps each run's result line in
``chiprun_out/sets_<cell>_<tag>.jsonl``.  Prints the card's name and power
limit, then each metric's median, quartiles (``statistics.quantiles(n=4)``)
and spread: the distance between the quartiles as a share of the median.
Not run by the benchmark's runs.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return {"median": statistics.median(values), "q1": q1, "q3": q3,
            "spread": (q3 - q1) / statistics.median(values)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", required=True)
    p.add_argument("--trace", default="0")
    p.add_argument("--tag", default="a")
    args = p.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / f"sets_{args.workload}_{args.tag}.jsonl"
    rows = []
    for seed in args.seeds.split(","):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "gpubench" / "run.py"),
             "--workload", args.workload, "--seed", seed,
             "--seconds", args.seconds, "--trace", args.trace],
            cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            res = None
        row = {"seed": int(seed), "rc": proc.returncode, "wall_s": wall,
               "result": res, "stderr_tail": proc.stderr[-3000:]}
        rows.append(row)
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")
        short = {k: v["value"] for k, v in (res or {}).get("metrics", {}).items()}
        print(json.dumps({"seed": int(seed), "rc": proc.returncode,
                          "wall_s": round(wall, 1),
                          "correct": (res or {}).get("correct"),
                          "metrics": short,
                          "checks": (res or {}).get("checks"),
                          "device": (res or {}).get("device")}), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], flush=True)
    names = sorted({k for r in rows if r["result"]
                    for k in r["result"]["metrics"]})
    for name in names:
        vals = [r["result"]["metrics"][name]["value"] for r in rows
                if r["result"] and name in r["result"]["metrics"]]
        print(json.dumps({"metric": name, "values": vals,
                          **(spread(vals) or {})}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
