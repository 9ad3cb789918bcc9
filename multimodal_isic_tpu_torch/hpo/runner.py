"""HPO runner: the ``tune.run`` replacement (``tune_mil.py:243-274``).

Counterpart of ``multimodal_isic_tpu/hpo/runner.py`` (:1-192).  Samples
configs from a space, runs each trial's trainable on ``device`` (the card
unless the caller asks for the CPU) with an ASHA-governed per-epoch report
hook, collects a results table, and writes the best config and the table
(timestamped CSV + YAML, as the reference does).  Trials run one after
another; :mod:`.population` packs same-shape trials into one cohort.

Under a multi-process ``torch.distributed`` group each process runs a
round-robin slice of the trials, while the global pieces live in the
group's store (:mod:`.distributed`): ASHA rung results are shared, the
failure budget is global, and every process assembles the same results
table (process 0 writes the artifacts).  Every process samples EVERY config
from the same seeded stream, so configs never need exchanging.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .asha import ASHAScheduler
from .space import sample_config


class TrialStopped(Exception):
    """Raised inside the report hook to halt a trial early (ASHA stop)."""


@dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    reports: List[Dict[str, float]] = field(default_factory=list)
    final: Optional[Dict[str, float]] = None
    stopped_early: bool = False
    error: str = ""
    wall_s: float = 0.0


def run_search(
    trainable: Callable,
    space: Dict[str, Any],
    data: Dict,
    num_samples: int = 16,
    metric: str = "val_bacc",
    mode: str = "max",
    scheduler: Optional[ASHAScheduler] = None,
    seed: int = 42,
    max_epochs: int = 50,
    patience: int = 8,
    num_classes: int = 7,
    output_dir: Optional[str] = None,
    verbose: bool = True,
    max_failures: int = 5,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Any]:
    """→ {best_config, best_trial, results (DataFrame), trials}.
    ``trainable(config, data, seed=, num_classes=, patience=, max_epochs=,
    report_fn=, device=)`` is ``train.mil.train_mil`` or
    ``train_graph_mil``."""
    import pandas as pd  # local: host-only dependencies
    import yaml

    from . import distributed as hdist

    nproc, pid = hdist.process_count(), hdist.process_index()
    ns = hdist.search_namespace()
    mine = set(hdist.shard_indices(num_samples))
    rng = np.random.RandomState(seed)
    scheduler = scheduler or ASHAScheduler(metric=metric, mode=mode,
                                           max_t=max_epochs)
    if nproc > 1 and scheduler.board is None:
        scheduler.board = hdist.CoordinationRungBoard(ns)
    trials: List[Trial] = []

    for i in range(num_samples):
        # every process samples every config (same stream) — only its own
        # round-robin slice executes; the rest are filled from the store
        config = sample_config(space, rng)
        trial = Trial(trial_id=f"trial_{i:05d}", config=config)
        if i not in mine:
            trials.append(trial)
            continue
        gfail = hdist.global_failure_count(ns)
        if gfail is not None and gfail >= max_failures:
            # another process exhausted the GLOBAL failure budget — abort at
            # this trial boundary instead of running our remaining slice
            raise RuntimeError(
                f"aborting search: {gfail} trials failed across processes")
        epoch_counter = {"n": 0}

        def report_fn(result: Dict[str, float]):
            trial.reports.append(result)
            if "val_macro_p" in result:  # per-epoch report
                epoch_counter["n"] += 1
                decision = scheduler.on_result(
                    trial.trial_id, epoch_counter["n"], result)
                if decision == "stop":
                    # the scheduler's max_t also says "stop": that trial is
                    # complete, not stopped early (JAX marks it early;
                    # its packed engine does not, :459-462)
                    trial.stopped_early = epoch_counter["n"] < getattr(
                        scheduler, "max_t", max_epochs)
                    raise TrialStopped
            else:  # final report
                trial.final = result

        t0 = time.time()
        try:
            final = trainable(config, data, seed=seed, num_classes=num_classes,
                              patience=patience, max_epochs=max_epochs,
                              report_fn=report_fn, device=device)
            if trial.final is None:
                trial.final = {k: v for k, v in final.items()
                               if not k.startswith("_")}
        except TrialStopped:
            # best-so-far summary from per-epoch reports (Ray keeps the last)
            per_epoch = [r for r in trial.reports if "val_macro_p" in r]
            vals = [r[metric] for r in per_epoch]
            best = int(np.nanargmax(vals) if mode == "max" else np.nanargmin(vals))
            trial.final = {metric: per_epoch[best][metric],
                           "val_loss": per_epoch[best].get("val_loss", np.nan)}
        except Exception as e:  # failed trial -> NaN row, keep the sweep alive
            trial.error = f"{type(e).__name__}: {e}"
            trial.final = {metric: float("nan")}
            # the failure budget is GLOBAL under multi-process sharding
            n_failed = (hdist.global_failure_count(ns, new_failure=True)
                        or sum(1 for t in trials if t.error) + 1)
            if verbose:
                print(f"{trial.trial_id} FAILED ({n_failed}/{max_failures}): "
                      f"{trial.error}", flush=True)
            if n_failed >= max_failures:  # reference: max_failures=5
                trials.append(trial)
                raise RuntimeError(
                    f"aborting search after {n_failed} failed trials") from e
        trial.wall_s = time.time() - t0
        trials.append(trial)
        hdist.publish_result(ns, i, {
            "final": {k: (float(v) if isinstance(v, (int, float, np.floating,
                                                     np.integer)) else v)
                      for k, v in (trial.final or {}).items()},
            "stopped_early": trial.stopped_early,
            "wall_s": trial.wall_s, "error": trial.error})
        if verbose:
            print(f"{trial.trial_id}: {metric}="
                  f"{trial.final.get(metric, float('nan')):.4f}"
                  f"{' (stopped early)' if trial.stopped_early else ''}"
                  f" [{trial.wall_s:.1f}s]", flush=True)

    # multi-process: wait for every process's published trials, then fill
    # the ones others ran so every process holds the identical full table
    # (best pick deterministic)
    remote = hdist.collect_results(ns, expected=num_samples,
                                   max_failures=max_failures)
    for i, t in enumerate(trials):
        if t.final is None and i in remote:
            t.final = remote[i]["final"]
            t.stopped_early = bool(remote[i]["stopped_early"])
            t.wall_s = float(remote[i]["wall_s"])
            t.error = remote[i]["error"]

    rows = []
    for t in trials:
        row = {"trial_id": t.trial_id, "stopped_early": t.stopped_early,
               "wall_s": t.wall_s, **{f"config/{k}": v for k, v in t.config.items()},
               **(t.final or {})}
        rows.append(row)
    results = pd.DataFrame(rows)

    vals = results[metric].astype(float)
    if vals.isna().all():
        # every trial failed/NaN: idxmax would return NaN and int() raise —
        # surface a real error on the failure-handling path instead
        raise RuntimeError(
            f"all {len(trials)} trials produced NaN {metric}; "
            "no best trial to select")
    best_idx = int(vals.idxmax() if mode == "max" else vals.idxmin())
    best_trial = trials[best_idx]

    if output_dir and pid == 0:  # coordinator-only artifacts
        os.makedirs(output_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        results.to_csv(os.path.join(output_dir, f"hpo_results_{stamp}.csv"),
                       index=False)
        with open(os.path.join(output_dir, f"best_config_{stamp}.yml"), "w") as f:
            yaml.safe_dump({"best_config": best_trial.config,
                            "best_" + metric: float(best_trial.final[metric])}, f)

    return {"best_config": best_trial.config, "best_trial": best_trial,
            "results": results, "trials": trials}
