"""CLI: aggregate experiment results into LaTeX rows (the reference's
``fetch_experiments.py``, pointed at local runs instead of Neptune; no
network).

    python -m multimodal_isic_tpu_torch.cli.fetch_experiments --log_dir runs \
        [--metric test/accuracy ...] [--group-tag image clinical]

Counterpart of ``multimodal_isic_tpu/cli/fetch_experiments.py`` (:1-43),
the same flags and output.  It reads files only: no device, no config.
"""

from __future__ import annotations

import argparse

from ..utils.reporting import collect_runs, latex_row, parse_classification_report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--log_dir", type=str, default="runs")
    parser.add_argument("--metric", nargs="+",
                        default=["test/accuracy", "test/balanced_accuracy"])
    parser.add_argument("--group-tag", nargs="*", default=None)
    parser.add_argument("--label", type=str, default="")
    args = parser.parse_args(argv)

    frame = collect_runs(args.log_dir)
    if frame.empty:
        print("No runs found.")
        return
    if args.group_tag:
        frame = frame[frame.get("group_tags").apply(
            lambda tags: isinstance(tags, list) and set(args.group_tag) <= set(tags))]
    # expand stored classification reports into flat metric columns
    if "test/classification_report" in frame.columns:
        parsed = frame["test/classification_report"].apply(
            lambda t: parse_classification_report(t) if isinstance(t, str) else {})
        for key in sorted({k for p in parsed for k in p}):
            frame[key] = parsed.apply(lambda p: p.get(key))
    print(f"{len(frame)} runs")
    print(latex_row(frame, [m for m in args.metric if m in frame.columns],
                    label=args.label))


if __name__ == "__main__":
    main()
