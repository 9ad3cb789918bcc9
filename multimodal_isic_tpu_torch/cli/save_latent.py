"""CLI: latent extraction (reference ``save_latent.py``; JAX
``cli/save_latent.py``).

    python -m multimodal_isic_tpu_torch.cli.save_latent --config_path config.yml \
        [--model_name <checkpoint-dir-name>] [--remove_background]

The encoder-only ConvMAE (compute dtype ``latent_dtype``, bf16 by default;
the fused LN-MLP kernel where the device is ``cuda``), restored from a
``train_ae`` checkpoint where ``manifest.json`` exists (the port's or the
JAX package's), runs over both manifests in batches of 128 with the
``mae_eval`` policy; the six frames go to ``dataframes_latents/`` under the
working directory, PCA(0.90) applied where the config's ``pca`` is true.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..analysis.latent_pipeline import extract_latents as _extract
from ..core import checkpoint as ckpt
from ..core.rng import generator
from ..data import augment
from ..data.pipeline import DermRecords, DeviceLoader
from ..models.convmae import build_convmae
from .common import check_single_process, parse_config, resolve_device
from .train_ae import TINY

LATENT_BS = 128  # JAX cli/save_latent.py:61 (the reference uses 1000)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FRAME_NAMES = ("patch_level_latents_train_df", "patch_level_latents_test_df",
               "latent_pooled_train_df", "latent_pooled_test_df",
               "latent_raw_train_df", "latent_raw_test_df")


def extract_latents(config, path: str, remove_background: bool = False):
    """The reference's importable API (``save_latent.extract_latents(config,
    path, remove_background)``; JAX :21-81) → the six frames.  A relative
    ``path`` is a directory under ``./models``."""
    import pandas as pd  # local: host-only dependency

    check_single_process(config)
    device = resolve_device(config["device"])
    params_cfg = config["training_plan"]["parameters"]
    df_train_val = pd.read_pickle(config["dir"]["df"])
    df_test = pd.read_pickle(config["dir"]["df_test"])
    cfg = dict(with_decoder=False,
               dtype=DTYPES[str(config.get("latent_dtype", "bfloat16"))])
    if params_cfg.get("model_size", "base") == "tiny":
        cfg.update(TINY)
    else:
        cfg["use_fused_mlp"] = (bool(params_cfg.get("use_fused_mlp", True))
                                and device.type == "cuda")
    model = build_convmae(generator(config["seed"], device), **cfg)
    checkpoint_path = (path if os.path.isabs(path)
                       else os.path.join(os.getcwd(), "models", path))
    if os.path.exists(os.path.join(checkpoint_path, ckpt.MANIFEST)):
        # encoder only from a full-model checkpoint: matched by name, the
        # decoder's tensors ignored (the reference's strict=False load,
        # save_latent.py:49)
        model.load_state_dict(ckpt.restore_partial(checkpoint_path,
                                                    model.state_dict()))

    def loader(df):
        return DeviceLoader(DermRecords(df), LATENT_BS,
                            transform=augment.POLICIES["mae_eval"],
                            device=device)

    def paths(df):
        return (df["image_path"].tolist(), df["segmentation_path"].tolist())

    return _extract(model, loader(df_train_val), loader(df_test),
                    paths(df_train_val), paths(df_test),
                    remove_background=remove_background,
                    pca_enabled=bool(config.get("pca", False)))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", type=str, default="")
    parser.add_argument("--remove_background", action="store_true")
    args, rest = parser.parse_known_args(argv)
    config = parse_config(rest)
    frames = extract_latents(config, args.model_name, args.remove_background)
    folder = "dataframes_latents"
    os.makedirs(folder, exist_ok=True)
    for name, frame in zip(FRAME_NAMES, frames):
        frame.to_pickle(os.path.join(folder, f"{name}.pkl"))
    print("Finished saving train_val and test patch-level and pooled "
          "latents.")
    return frames


if __name__ == "__main__":
    main()
