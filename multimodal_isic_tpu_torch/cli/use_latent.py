"""CLI: MIL cross-validation (reference ``use_latent.py``; JAX
``cli/use_latent.py``).

Single-frame mode, CV over one patch-level DataFrame:

    python -m multimodal_isic_tpu_torch.cli.use_latent --config_path config.yml \
        [--model_type mil|graph-mil] [--patch_df <pkl>] [--csv results.csv]

Sweep mode, the reference's cross-checkpoint loop
(``use_latent.py:69-81,142-170,494-547``): for each trained AE checkpoint,
re-extract the latents (``cli.save_latent.extract_latents``: the ConvMAE
encoder, with the fused LN-MLP kernel on ``cuda``), run the CV, and write
the crash-safe cross-model CSV and a config snapshot with its hash:

    python -m multimodal_isic_tpu_torch.cli.use_latent --config_path config.yml \
        --checkpoints ckptA,ckptB [--out_dir mil_results]
    python -m multimodal_isic_tpu_torch.cli.use_latent --config_path config.yml \
        --runs_csv runs_df.csv          # columns: id (or sys/id), best_model_path

The model's configuration is ``config['best_params']`` or
``config['best_params_graph-mil']`` (the reference's HPO records,
``use_latent.py:283,303``).  Training runs on the config's ``device``
(``cli.common.resolve_device``: the card unless it says ``cpu``), in full
float32 (TF32 off).
"""

from __future__ import annotations

import argparse
import os
import time
import uuid

from ..analysis.bags import build_patient_bags
from ..train.cv import cross_validate_mil, sweep_ae_checkpoints
from ..utils.logging import RunLogger
from .common import check_single_process, parse_config, resolve_device


def _sweep(args, config, model_config, logger, device) -> None:
    import pandas as pd  # local: host-only dependency

    from .save_latent import extract_latents

    if args.runs_csv:
        runs_df = pd.read_csv(args.runs_csv)
        id_col = "sys/id" if "sys/id" in runs_df.columns else "id"
        names, run_ids = [], []
        for idx, row in runs_df.iterrows():
            name = row.get("best_model_path")
            if not isinstance(name, str) or name == "nan":  # use_latent.py:146
                print(f"Skipping row {idx} because best_model_path is "
                      "missing")
                continue
            names.append(os.path.basename(name) if not os.path.isabs(name)
                         else name)
            run_ids.append(str(row.get(id_col, f"manual_{idx}")))
    else:
        names = [s for s in args.checkpoints.split(",") if s]
        run_ids = None

    os.makedirs(args.out_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    uid = uuid.uuid4().hex[:6]
    out_csv = os.path.join(args.out_dir,
                           f"runs_df_mil_results_{stamp}_{uid}.csv")
    config_out = os.path.join(args.out_dir, f"config_{stamp}_{uid}.yml")

    def extract_bags(model_name):
        frames = extract_latents(config, path=model_name,
                                 remove_background=False)
        bags, labels, _ = build_patient_bags(frames[0])
        print(f"{len(bags)} patient bags for {model_name}")
        return bags, labels

    results = sweep_ae_checkpoints(
        names, extract_bags, model_kind=args.model_type, config=model_config,
        run_ids=run_ids, n_folds=args.n_folds, seed=config["seed"],
        num_classes=int(config.get("num_classes", 7)),
        max_epochs=args.max_epochs, patience=args.patience,
        out_csv=out_csv, config_snapshot=config.to_dict(),
        config_out=config_out, logger=logger, device=device)
    print(f"\nSaved runs results to {out_csv}")
    if results.empty:
        print("No runnable checkpoints in the sweep (all rows skipped); "
              "no results to report.")
        return results
    with pd.option_context("display.width", 200):
        print(results[["id", "checkpoint_type", "micro_accuracy",
                       "macro_f1", "weighted_f1"]].to_string(index=False))
    return results


def main(argv=None):
    """Run the CLI → the sweep's rows (sweep mode) or the CV's result
    (single-frame mode: folds, summary, frame)."""
    import pandas as pd  # local: host-only dependency

    parser = argparse.ArgumentParser()
    parser.add_argument("--model_type", choices=["mil", "graph-mil"],
                        default="mil")
    parser.add_argument("--patch_df", type=str, default=(
        "dataframes_latents/patch_level_latents_train_df.pkl"))
    parser.add_argument("--csv", type=str, default="cv_results.csv")
    parser.add_argument("--n_folds", type=int, default=5)
    parser.add_argument("--max_epochs", type=int, default=200)
    parser.add_argument("--patience", type=int, default=16)
    # sweep mode
    parser.add_argument("--checkpoints", type=str, default="",
                        help="comma-separated AE checkpoint names to sweep")
    parser.add_argument("--runs_csv", type=str, default="",
                        help="CSV manifest with id/best_model_path columns")
    parser.add_argument("--out_dir", type=str, default="mil_results")
    args, rest = parser.parse_known_args(argv)
    config = parse_config(rest)
    check_single_process(config)
    device = resolve_device(config["device"])

    best_key = ("best_params_graph-mil" if args.model_type == "graph-mil"
                else "best_params")
    model_config = dict(config.get(best_key, {}) or {})
    logger = RunLogger(config.get("log_dir", "runs"), config=config.to_dict())

    if args.checkpoints or args.runs_csv:
        return _sweep(args, config, model_config, logger, device)

    bags, labels, _ = build_patient_bags(pd.read_pickle(args.patch_df))
    print(f"{len(bags)} patient bags")
    out = cross_validate_mil(
        bags, labels, model_kind=args.model_type, config=model_config,
        n_folds=args.n_folds, seed=config["seed"],
        num_classes=int(config.get("num_classes", 7)),
        max_epochs=args.max_epochs, patience=args.patience,
        csv_path=args.csv, logger=logger, device=device)
    for metric, (mean, std) in sorted(out["summary"].items()):
        print(f"{metric}: {mean:.4f} ± {std:.4f}")
    return out


if __name__ == "__main__":
    main()
