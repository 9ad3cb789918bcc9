"""CLI: radiomics feature extraction (reference ``extract_radiomics.py``;
JAX ``cli/extract_radiomics.py``).

    python -m multimodal_isic_tpu_torch.cli.extract_radiomics --config_path config.yml

Reads both manifests, extracts 4 × 1218 features an image on the config's
device in chunks of 16 and pickles the suffixed frames to
``dir.radiomics`` and ``dir.radiomics_test``.
"""

from __future__ import annotations

from ..analysis.radiomics import RadiomicsExtractor, extract_radiomics_frames
from .common import check_single_process, parse_config, resolve_device

CHUNK = 16  # images a chunk on one card (JAX cli/extract_radiomics.py:24)


def chunk_size(config) -> int:
    """The JAX ``_maybe_mesh`` rule on one card: ``mesh.data`` -1 or 1
    gives no mesh and chunks of 16; a mesh over more cards waits for the
    parallel port and raises ``ValueError``."""
    check_single_process(config)
    return CHUNK


def main(argv=None):
    import pandas as pd  # local: host-only dependency

    config = parse_config(argv)
    df_train = pd.read_pickle(config["dir"]["df"])
    df_test = pd.read_pickle(config["dir"]["df_test"])
    extractor = RadiomicsExtractor(batch=chunk_size(config),
                                   device=resolve_device(config["device"]))
    print("Enabled image types:", extractor.get_enabled_image_types())
    print("Enabled features:", extractor.get_enabled_features())
    train, test = extract_radiomics_frames(config, df_train, df_test,
                                           extractor)
    print(f"Radiomics train frame: {train.shape} -> "
          f"{config['dir']['radiomics']}")
    print(f"Radiomics test frame: {test.shape} -> "
          f"{config['dir']['radiomics_test']}")
    return train, test


if __name__ == "__main__":
    main()
