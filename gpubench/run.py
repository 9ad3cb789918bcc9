"""Run one cell of the port's benchmark once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout holding ``BENCHMARK.json``, this folder and
``multimodal_isic_tpu_torch``.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and ``checks`` last: each number
compared with its limit); the checks are also the last lines of standard
error.  Exits 1 without a result when no CUDA card is there, when a run
loaded JAX, flax or the JAX package, or on any error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed paths inside the checkout
CACHE = ROOT / "build" / "gpubench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from gpubench import common, harness
    cell = common.resolve(args.workload)
    need = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"gpubench: {args.workload} needs {need} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START, resolved=cell)
    found = common.forbidden_modules()
    if found:
        print(f"gpubench: the run loaded {found}", file=sys.stderr)
        return 1
    harness.print_checks(out["checks"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
