"""Typed configuration.

Counterpart of ``multimodal_isic_tpu/core/config.py`` (:23-229): the union
of config keys of the reference pipeline as a frozen dataclass tree, the same
defaults, dict-style access (``config["dir"]["df"]``) beside attribute
access, unknown non-None keys rejected with ``KeyError``, ``load_config``
over YAML and ``to_dict``.  yaml is imported inside :func:`load_config`.

Keys whose meaning is the JAX runtime's read differently here:

- ``device``: ``''``, ``'tpu'`` and ``'cuda'`` mean ``cuda:0``,
  ``'cuda:N'`` that card, ``'cpu'`` the CPU (``cli/common.py``).
- ``mesh``: ``data`` and ``model`` lay out the processes' ranks, one card
  a process (``cli.common.setup_processes``).
- ``use_fused_mlp`` / ``use_flash_attention`` name the port's CUDA kernels.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List


class _DictAccess:
    """Mixin giving dataclasses dict-style item access and ``.get``."""

    def __getitem__(self, key: str) -> Any:
        key = key.replace("-", "_")
        if not hasattr(self, key):
            raise KeyError(key)
        return getattr(self, key)

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def __contains__(self, key: str) -> bool:
        return hasattr(self, key.replace("-", "_"))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class DirConfig(_DictAccess):
    """Dataset artifact locations (reference ``config.yml:6-17``)."""

    csv: str = ""
    img: str = ""
    seg: str = ""
    radiomics: str = ""
    radiomics_red: str = ""
    df: str = ""
    csv_test: str = ""
    img_test: str = ""
    seg_test: str = ""
    radiomics_test: str = ""
    radiomics_test_red: str = ""
    df_test: str = ""
    latents: str = ""
    latents_test: str = ""
    isic2019_csv: str = ""
    isic2019_img: str = ""
    isic2019_gt: str = ""


@dataclass(frozen=True)
class TrainParameters(_DictAccess):
    """Union of ``training_plan.parameters.*`` keys."""

    patience: int = 10
    epochs: int = 1
    fold: int = 0
    batch_size: int = 16
    lr: float = 1e-3
    weight_decay: float = 1e-4
    norm_pix_loss: bool = False
    masking_ratio: float = 0.75
    eval_masking_ratio: float = 0.75
    include_lesion_mask: bool = False
    model_size: str = "base"  # 'base' (ConvViT-B) | 'tiny' (tests/demos)
    pretrained_ckpt: str = ""
    use_flash_attention: bool = False
    use_fused_mlp: bool = True
    remat_blocks: bool = False
    # an efficientnet.PARAMS name ('efficientnet-b0' .. 'b7') or a
    # maxvit.PARAMS one ('maxvit-base')
    backbone: str = "efficientnet-b3"
    backbone_remat: str = "none"  # 'none' | 'conv' | 'block'
    # (models/efficientnet.py EfficientNet.remat, models/maxvit.py MaxViT)
    fold_bn_eval: bool = False  # final test pass on the BN-folded net
    device_cache: bool = False  # stage the split's crops on the card once
    augment_fast: bool = False  # fusion_train_fast: the warp kernel


@dataclass(frozen=True)
class TrainingPlan(_DictAccess):
    modality: List[str] = field(
        default_factory=lambda: ["image", "radiomics", "clinical", "artifacts"]
    )
    fusion: str = "concat"  # 'concat' | 'weighted' | 'attention'
    fusion_level: str = "intermediate"  # 'intermediate' | 'late'
    parameters: TrainParameters = field(default_factory=TrainParameters)


@dataclass(frozen=True)
class MeshConfig(_DictAccess):
    """The ranks' grid: ``data`` -1 is every process (one card each)."""

    data: int = -1
    model: int = 1


@dataclass(frozen=True)
class Config(_DictAccess):
    neptune: bool = False  # kept for config-surface parity
    seed: int = 42
    device: str = "tpu"
    dir: DirConfig = field(default_factory=DirConfig)
    model_path: str = "models"
    pca: bool = False
    num_classes: int = 7
    latent_dtype: str = "bfloat16"
    training_plan: TrainingPlan = field(default_factory=TrainingPlan)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    best_params: Dict[str, Any] = field(default_factory=dict)
    best_params_graph_mil: Dict[str, Any] = field(default_factory=dict)
    log_dir: str = "runs"


def _build(cls, data: Dict[str, Any]):
    """Construct dataclass ``cls`` from a dict; unknown keys are skipped
    when None-valued and raise ``KeyError`` otherwise, so a typo in an
    experiment config fails fast."""
    if data is None:
        return cls()
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs: Dict[str, Any] = {}
    for key, value in data.items():
        norm = key.replace("-", "_")
        if norm not in names:
            if value is None:
                continue
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        kwargs[norm] = value
    return cls(**kwargs)


def config_from_dict(data: Dict[str, Any]) -> Config:
    """Build a :class:`Config` from a plain (YAML-loaded) dict."""
    data = dict(data or {})
    kwargs: Dict[str, Any] = {}
    names = {f.name for f in dataclasses.fields(Config)}
    for key, value in data.items():
        norm = key.replace("-", "_")
        if norm not in names:
            if value is None:
                continue
            raise KeyError(f"unknown config key {key!r}")
        if norm == "dir":
            kwargs[norm] = _build(DirConfig, value)
        elif norm == "training_plan":
            tp = dict(value or {})
            params = _build(TrainParameters, tp.pop("parameters", None))
            kwargs[norm] = TrainingPlan(parameters=params, **{
                k.replace("-", "_"): v for k, v in tp.items()
            })
        elif norm == "mesh":
            kwargs[norm] = _build(MeshConfig, value)
        else:
            kwargs[norm] = value
    return Config(**kwargs)


def load_config(path: str) -> Config:
    """Load a YAML config file into a typed :class:`Config`."""
    import yaml  # local: host-only dependency

    with open(path) as f:
        raw = yaml.safe_load(f)
    return config_from_dict(raw or {})
