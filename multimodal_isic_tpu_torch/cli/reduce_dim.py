"""CLI: radiomics feature reduction (reference ``reduce_dim.py``; JAX
``cli/reduce_dim.py``).

    python -m multimodal_isic_tpu_torch.cli.reduce_dim --config_path config.yml

Reads the extracted frames and the train manifest's labels, reduces them
(the L1-logistic selection on the config's device) and pickles the reduced
frames to ``dir.radiomics_red`` and ``dir.radiomics_test_red``.
"""

from __future__ import annotations

from ..analysis.reduce import reduce_features
from .common import parse_config, resolve_device


def main(argv=None):
    import pandas as pd  # local: host-only dependency

    config = parse_config(argv)
    rad_train = pd.read_pickle(config["dir"]["radiomics"])
    rad_test = pd.read_pickle(config["dir"]["radiomics_test"])
    df_train = pd.read_pickle(config["dir"]["df"])
    tr, te = reduce_features(rad_train, rad_test, df_train["dx"],
                             seed=config["seed"],
                             device=resolve_device(config["device"]))
    tr.to_pickle(config["dir"]["radiomics_red"])
    te.to_pickle(config["dir"]["radiomics_test_red"])
    print(f"Reduced radiomics saved: train {tr.shape} -> "
          f"{config['dir']['radiomics_red']}, test {te.shape} -> "
          f"{config['dir']['radiomics_test_red']}")
    return tr, te


if __name__ == "__main__":
    main()
