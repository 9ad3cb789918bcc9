"""Shared CLI plumbing: the ``--config_path`` flag and the config's
``device`` key.

Counterpart of ``multimodal_isic_tpu/cli/common.py`` (:13-35).  The device
rule: ``''``, ``'tpu'`` (the JAX default) and ``'cuda'`` mean ``cuda:0``;
``'cuda:N'`` that card; ``'cpu'`` the CPU.  A CUDA device asked for on a
machine without one raises; nothing falls back to the CPU.  The CLI runs
float32 in full float32: TF32 is switched off for cuBLAS and cuDNN, the
setting of every card check of the port.

Several processes (JAX ``parallel.distributed.setup``):
:func:`setup_processes` joins the ``torch.distributed`` group the
``ISIC_*`` variables describe and gives the rank's device (``cuda`` the
rank's card, ``cuda:N`` that card for every rank, ``cpu`` the CPU).
``cli.main``, ``cli.train_ae``, ``cli.extract_radiomics`` and
``cli.tune_mil`` run so, as in the JAX package; ``cli.save_latent``,
``cli.use_latent`` and ``cli.cluster_latents`` run one process there too
and keep :func:`check_single_process`.  No CLI uses tensor parallelism:
``mesh.model`` > 1 is refused.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence, Tuple

import torch

from ..core.config import Config, load_config
from ..parallel import distributed as D
from ..parallel.distributed import MULTIPROCESS_ENV
from ..parallel.sharding import Grid


def check_single_process(config) -> None:
    """Raise ``ValueError`` for a multi-process or multi-card run (the
    CLIs that run one process in the JAX package too)."""
    env = [k for k in MULTIPROCESS_ENV if os.environ.get(k)]
    if env:
        raise ValueError(f"multi-process runs ({', '.join(env)} set): this "
                         "CLI runs one process on one card, as in the JAX "
                         "package")
    mesh = config["mesh"]
    if mesh["data"] not in (-1, 1) or mesh["model"] != 1:
        raise ValueError(f"mesh {mesh.to_dict()}: this CLI runs on one card "
                         "(data -1 or 1, model 1)")


def setup_processes(config) -> Tuple[bool, Optional[Grid], torch.device]:
    """Join the group of the ``ISIC_*`` variables and lay
    the ranks out on ``config.mesh`` → ``(multiproc, grid, device)``:
    ``(False, None, the config's device)`` in one process.  Refuses
    ``mesh.model`` > 1 (no CLI uses tensor parallelism, as in the JAX
    package), a ``mesh.data`` other than -1, 1 or the process count, and
    ``mesh.data`` > 1 in one process (one card a process: start that many
    processes)."""
    key = (config.get("device", "") or "").strip().lower()
    device = resolve_device(key)
    if key in ("", "tpu", "cuda"):  # the rank's card
        device = torch.device("cuda")
    multiproc, grid, device = D.setup(device, n_model=1)
    check_mesh(config, grid.world if multiproc else 1)
    return multiproc, grid, device


def check_mesh(config, world: int) -> None:
    """Raise ``ValueError`` unless ``config.mesh`` fits ``world``
    processes of one card each: ``model`` 1, ``data`` -1, 1 or ``world``."""
    mesh = config["mesh"]
    if mesh["model"] != 1:
        raise ValueError(f"mesh {mesh.to_dict()}: the CLIs run one card a "
                         "process and no tensor parallelism (model 1)")
    if mesh["data"] not in (-1, 1, world):
        raise ValueError(
            f"mesh {mesh.to_dict()} in {world} process(es): one card a "
            f"process, so start {mesh['data']} processes ({D.ENV_COORD}, "
            f"{D.ENV_NPROC}, {D.ENV_PID}) or set data -1")


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
