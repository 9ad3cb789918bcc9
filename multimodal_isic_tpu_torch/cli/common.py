"""Shared CLI plumbing: the ``--config_path`` flag and the config's
``device`` key.

Counterpart of ``multimodal_isic_tpu/cli/common.py`` (:13-35).  The device
rule: ``''``, ``'tpu'`` (the JAX default) and ``'cuda'`` mean ``cuda:0``;
``'cuda:N'`` that card; ``'cpu'`` the CPU.  A CUDA device asked for on a
machine without one raises; nothing falls back to the CPU.  The CLI runs
float32 in full float32: TF32 is switched off for cuBLAS and cuDNN, the
setting of every card check of the port.  Multi-process and multi-card
runs wait for the parallel port (:func:`check_single_process`).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from ..core.config import Config, load_config

MULTIPROCESS_ENV = ("ISIC_COORDINATOR", "ISIC_NUM_PROCESSES",
                    "ISIC_PROCESS_ID")


def check_single_process(config) -> None:
    """Raise ``ValueError`` for a multi-process or multi-card run."""
    env = [k for k in MULTIPROCESS_ENV if os.environ.get(k)]
    if env:
        raise ValueError(f"multi-process runs ({', '.join(env)} set) are not "
                         "ported yet: run one process on one card")
    mesh = config["mesh"]
    if mesh["data"] not in (-1, 1) or mesh["model"] != 1:
        raise ValueError(f"mesh {mesh.to_dict()}: the port runs on one card "
                         "(data -1 or 1, model 1)")


def resolve_device(name: str) -> torch.device:
    """The config's ``device`` key → a ``torch.device`` (module docstring)."""
    key = (name or "").strip().lower()
    if key == "cpu":
        return torch.device("cpu")
    if key in ("", "tpu", "cuda"):
        key = "cuda:0"
    if not key.startswith("cuda:") or not key[5:].isdigit():
        raise ValueError(f"device {name!r}: expected '', 'tpu', 'cuda', "
                         "'cuda:N' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} asks for a CUDA card and this "
                           "machine has none; set device: cpu to run on the "
                           "CPU")
    index = int(key[5:])
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"device {name!r}: this machine has "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", index)


def parse_config(argv: Optional[Sequence[str]] = None,
                 default_path: str = "config.yml") -> Config:
    """Parse ``--config_path``, load the config, check its device key and
    switch TF32 off."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", type=str, default=default_path,
                        help="path to .yml config file specifying "
                             "datasets/training params")
    args, _ = parser.parse_known_args(argv)
    config = load_config(args.config_path)
    resolve_device(config.get("device", ""))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return config
