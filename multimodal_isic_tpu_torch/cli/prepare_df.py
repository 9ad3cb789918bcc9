"""CLI: build the train/test manifest DataFrames (reference
``prepare_df.py``; JAX ``cli/prepare_df.py``).

    python -m multimodal_isic_tpu_torch.cli.prepare_df --config_path config.yml
"""

from __future__ import annotations

from ..data.manifest import prepare_manifests
from .common import parse_config


def main(argv=None) -> None:
    config = parse_config(argv)
    df_train, df_test = prepare_manifests(config)
    print(f"Train DataFrame saved to {config['dir']['df']} "
          f"({len(df_train)} rows)")
    print(f"Test DataFrame saved to {config['dir']['df_test']} "
          f"({len(df_test)} rows)")


if __name__ == "__main__":
    main()
