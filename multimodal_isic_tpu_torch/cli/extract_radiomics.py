"""CLI: radiomics feature extraction (reference ``extract_radiomics.py``;
JAX ``cli/extract_radiomics.py``).

    python -m multimodal_isic_tpu_torch.cli.extract_radiomics --config_path config.yml

Reads both manifests, extracts 4 × 1218 features an image on the config's
device in chunks of 16 and pickles the suffixed frames to
``dir.radiomics`` and ``dir.radiomics_test``.  In several processes
(``ISIC_*``, ``cli.common.setup_processes``) the chunks are split across
the ranks, one card each, and rank 0 writes the frames, in the one-process
row order (the JAX ``_maybe_mesh`` :15-27 shards a chunk over a mesh of the
process's chips instead).
"""

from __future__ import annotations

from ..analysis.radiomics import RadiomicsExtractor, extract_radiomics_frames
from ..parallel.distributed import is_coordinator
from .common import parse_config, setup_processes

# images a chunk on one card, whatever mesh.data is: the JAX _maybe_mesh
# rule (cli/extract_radiomics.py:24) with one card a process
CHUNK = 16


def main(argv=None):
    import pandas as pd  # local: host-only dependency

    config = parse_config(argv)
    multiproc, grid, device = setup_processes(config)
    df_train = pd.read_pickle(config["dir"]["df"])
    df_test = pd.read_pickle(config["dir"]["df_test"])
    extractor = RadiomicsExtractor(
        batch=CHUNK, device=device, grid=grid)
    if multiproc:
        print(f"Extraction split over {grid.n_data} processes (rank "
              f"{grid.rank} on {device})")
    print("Enabled image types:", extractor.get_enabled_image_types())
    print("Enabled features:", extractor.get_enabled_features())
    train, test = extract_radiomics_frames(config, df_train, df_test,
                                           extractor)
    if is_coordinator():
        print(f"Radiomics train frame: {train.shape} -> "
              f"{config['dir']['radiomics']}")
        print(f"Radiomics test frame: {test.shape} -> "
              f"{config['dir']['radiomics_test']}")
    return train, test


if __name__ == "__main__":
    main()
