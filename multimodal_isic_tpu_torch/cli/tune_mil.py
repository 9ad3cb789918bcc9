"""CLI: MIL hyperparameter search (reference ``tune_mil.py``; JAX
``cli/tune_mil.py``).

    python -m multimodal_isic_tpu_torch.cli.tune_mil --config_path config.yml \
        [--model_type mil|graph-mil] [--num_samples 1000] [--max_epochs 200] \
        [--patience 16] [--patch_df <pkl>] [--packed auto|always|never]

``--packed auto`` (the default) runs both searches as packed trial cohorts
with the ASHA rungs judged inside the packed run (``hpo.population``): the
form here of the reference's fractional-GPU packing + ASHA
(``tune_mil.py:144-149,213-227``).  For graph-MIL (the reference's flagship
1000-sample search, 4 trials a GPU at ``tune_mil.py:33``) the 15
architecture / topology keys are the cohort's shape (sampled once a
cohort) and lr / wd / gnn_dropout / pool_dropout a trial's; each bag's
adjacency is built once and shared by the cohort.  ``--packed never`` runs
the sequential runner.  Training runs on the config's ``device``
(``cli.common.resolve_device``: the card unless it says ``cpu``), in full
float32 (TF32 off).  In several processes (``ISIC_*``,
``cli.common.setup_processes``; JAX :60-61,99-100) each rank runs a
round-robin slice of the trials on its own card, the ASHA rungs, the
failure budget and the results table are shared through the group's store
(``hpo.distributed``), every rank gets the same table and best config, and
rank 0 alone writes the artifacts.
"""

from __future__ import annotations

import argparse
import os
import time

from ..analysis.bags import build_patient_bags
from ..hpo import ASHAScheduler, GRAPH_MIL_SPACE, MIL_SPACE, run_search
from ..hpo import distributed as hdist
from ..hpo.population import (GRAPH_POP_KEYS, GRAPH_SHAPE_KEYS, POP_KEYS,
                              SHAPE_KEYS, run_population_search)
from ..train.mil import train_graph_mil, train_mil
from .common import parse_config, setup_processes


def main(argv=None):
    """Run the search → ``run_population_search``'s or ``run_search``'s
    result."""
    import pandas as pd  # local: host-only dependency
    import yaml

    parser = argparse.ArgumentParser()
    # defaults mirror the reference's hard-coded Namespace (tune_mil.py:26-41)
    parser.add_argument("--model_type", choices=["mil", "graph-mil"],
                        default="graph-mil")
    parser.add_argument("--num_samples", type=int, default=1000)
    parser.add_argument("--max_epochs", type=int, default=200)
    parser.add_argument("--patience", type=int, default=16)
    parser.add_argument("--grace_period", type=int, default=10)
    parser.add_argument("--reduction_factor", type=int, default=2)
    parser.add_argument("--patch_df", type=str,
                        default="dataframes_latents/patch_level_latents_train_df.pkl")
    parser.add_argument("--test_patch_df", type=str, default="")
    parser.add_argument("--output_dir", type=str, default="hpo_out")
    parser.add_argument("--packed", choices=["auto", "always", "never"],
                        default="auto")
    parser.add_argument("--cohort_size", type=int, default=8)
    args, rest = parser.parse_known_args(argv)
    config = parse_config(rest)
    _, _, device = setup_processes(config)

    patch_df = pd.read_pickle(args.patch_df)
    bags, labels, _ = build_patient_bags(patch_df)
    data = {"train_feats": bags, "train_labels": labels}
    if args.test_patch_df:
        te_df = pd.read_pickle(args.test_patch_df)
        te_bags, te_labels, _ = build_patient_bags(te_df)
        data.update({"test_feats": te_bags, "test_labels": te_labels})

    trainable = train_graph_mil if args.model_type == "graph-mil" else train_mil
    space = GRAPH_MIL_SPACE if args.model_type == "graph-mil" else MIL_SPACE
    scheduler = ASHAScheduler(metric="val_bacc", mode="max",
                              grace_period=args.grace_period,
                              reduction_factor=args.reduction_factor,
                              max_t=args.max_epochs)
    # the packed path needs the space to split into cohort shape keys +
    # per-trial continuous keys: true for both built-in spaces
    if args.model_type == "graph-mil":
        shape_keys, pop_keys = GRAPH_SHAPE_KEYS, GRAPH_POP_KEYS
    else:
        shape_keys, pop_keys = SHAPE_KEYS, POP_KEYS
    packable = set(space) == set(shape_keys) | set(pop_keys)
    use_packed = (args.packed == "always"
                  or (args.packed == "auto" and packable))
    if use_packed and not packable:
        raise SystemExit(f"--packed always: space keys {sorted(space)} do not "
                         f"split into shape {shape_keys} + trial {pop_keys}")
    if use_packed:
        out = run_population_search(
            space, data, num_samples=args.num_samples,
            cohort_size=args.cohort_size, seed=config["seed"],
            max_epochs=args.max_epochs, patience=args.patience,
            num_classes=int(config.get("num_classes", 7)),
            scheduler=scheduler, model_type=args.model_type, device=device)
        results = out["results"]
        best_config = out["best_config"]
        best_val = float(results["val_bacc"].astype(float).max())
        if hdist.process_index() != 0:
            args.output_dir = None  # process 0 writes the artifacts
        if args.output_dir:
            os.makedirs(args.output_dir, exist_ok=True)
            stamp = time.strftime("%Y%m%d_%H%M%S")
            results.to_csv(os.path.join(
                args.output_dir, f"hpo_results_{stamp}.csv"), index=False)
            with open(os.path.join(args.output_dir,
                                   f"best_config_{stamp}.yml"), "w") as f:
                yaml.safe_dump({"best_config": best_config,
                                "best_val_bacc": best_val}, f)
        n_stop = int(results["stopped_early"].astype(bool).sum())
        print(f"Packed search: {len(results)} trials, "
              f"{n_stop} ASHA-stopped early, {out['wall_s']:.1f}s")
        print("Best config:", best_config)
        print("Best val_bacc:", best_val)
    else:
        out = run_search(trainable, space, data,
                         num_samples=args.num_samples,
                         scheduler=scheduler, seed=config["seed"],
                         max_epochs=args.max_epochs, patience=args.patience,
                         num_classes=int(config.get("num_classes", 7)),
                         output_dir=args.output_dir, device=device)
        print("Best config:", out["best_config"])
        print("Best val_bacc:", out["best_trial"].final["val_bacc"])
    return out


if __name__ == "__main__":
    main()
