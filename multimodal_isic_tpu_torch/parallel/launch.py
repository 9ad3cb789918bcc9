"""Start a group of ranks on this host and wait for all of them.

    python -m multimodal_isic_tpu_torch.parallel.launch MODULE:FUNCTION JSON

runs as one rank: it calls ``FUNCTION(**JSON)``, which joins the group
(``parallel.distributed.initialize`` reads the ``ISIC_*`` variables), and
prints its result as one ``RANK-RESULT`` JSON line.  :func:`run_ranks` starts ``n`` such processes (or any command, a
CLI for instance) with ``ISIC_COORDINATOR=file://<store>`` (a
``FileStore``, no TCP port), ``ISIC_NUM_PROCESSES`` and
``ISIC_PROCESS_ID`` set, keeps every rank's output, and fails when any
rank exits non-zero or the group outlives its wall timeout (the others are
killed).  Used by ``entry.dryrun_multichip``, the tests and the card's
smoke run.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

RESULT = "RANK-RESULT "
_ROOT = str(Path(__file__).resolve().parents[2])


def rank_command(target: str, kwargs: Optional[Dict] = None) -> List[str]:
    """The command of one rank running ``target`` ('module:function')."""
    return [sys.executable, "-m", "multimodal_isic_tpu_torch.parallel.launch",
            target, json.dumps(kwargs or {})]


def run_ranks(n: int, command: Sequence[str], workdir: str,
              timeout_s: float, env: Optional[Dict[str, str]] = None
              ) -> List[str]:
    """Run ``command`` as ranks 0..n-1 (the store and each rank's output
    under ``workdir``) → every rank's output, in rank order.  Raises
    ``RuntimeError`` with the outputs' tails when a rank fails or the
    group runs past ``timeout_s``."""
    work = Path(tempfile.mkdtemp(prefix="ranks_", dir=workdir))
    base = dict(os.environ, **(env or {}))
    base["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, base.get("PYTHONPATH")) if p)
    base["ISIC_COORDINATOR"] = (work / "store").resolve().as_uri()
    base["ISIC_NUM_PROCESSES"] = str(n)
    logs = [work / f"rank{r}.log" for r in range(n)]
    procs = []
    try:
        for r in range(n):
            with open(logs[r], "wb") as out:
                procs.append(subprocess.Popen(
                    list(command), stdout=out, stderr=subprocess.STDOUT,
                    env=dict(base, ISIC_PROCESS_ID=str(r))))
        deadline = time.monotonic() + timeout_s
        failed = None
        while failed is None:
            rcs = [p.poll() for p in procs]
            bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {rcs[bad[0]]}"
            elif all(rc == 0 for rc in rcs):
                break
            elif time.monotonic() > deadline:
                failed = f"the group ran past its {timeout_s:.0f} s timeout"
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = [log.read_text(errors="replace") for log in logs]
    if failed is not None:
        tails = "\n".join(f"--- rank {r} ---\n{o[-3000:]}"
                          for r, o in enumerate(outs))
        raise RuntimeError(f"{n} ranks of {' '.join(command)[:200]}: "
                           f"{failed}\n{tails}")
    return outs


def rank_results(outs: Sequence[str]) -> List:
    """The ``RANK-RESULT`` object each rank printed, in rank order."""
    found = []
    for r, out in enumerate(outs):
        lines = [l for l in out.splitlines() if l.startswith(RESULT)]
        if not lines:
            raise RuntimeError(f"rank {r} printed no result:\n{out[-3000:]}")
        found.append(json.loads(lines[-1][len(RESULT):]))
    return found


def _main(argv: Sequence[str]) -> int:
    from . import distributed as D

    target, kwargs = argv[0], json.loads(argv[1]) if len(argv) > 1 else {}
    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    result = fn(**kwargs)
    print(RESULT + json.dumps(result), flush=True)
    D.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
