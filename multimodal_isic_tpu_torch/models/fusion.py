"""Multimodal fusion classifier (eval).

Counterpart of ``multimodal_isic_tpu/models/fusion.py``, which re-creates the
reference's ``MultiModalFusionNet`` (``model.py:42-227``): modality subsets,
intermediate/late fusion × concat/weighted/attention, including late 'concat'
being a sum of logits (``model.py:219-221``).  Submodule names follow the
flax parameter tree, so ``models/convert.py`` maps one onto the other.

Branch dims: image backbone features → 256 → 128; radiomics 780 → 256 → 128;
clinical 13 (age + sex-emb 4 + loc-emb 8) → 64 → 128; artifacts 12
(6 × Embedding(2, 2)) → 64 → 128.  LayerNorm uses flax's eps 1e-6.
The backbone computes in ``dtype``; the branch MLPs and fusion heads stay
float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .efficientnet import EfficientNet, feature_dim, fold_batchnorm

SHARED_DIM = 128
LN_EPS = 1e-6  # flax nn.LayerNorm default


class ProjMlp(nn.Module):
    """Linear→LayerNorm→ReLU ×2 projector (model.py:63-105); dropout is
    inactive in eval."""

    def __init__(self, din: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(din, hidden)
        self.ln1 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.fc2 = nn.Linear(hidden, out)
        self.ln2 = nn.LayerNorm(out, eps=LN_EPS)

    def forward(self, x):
        x = F.relu(self.ln1(self.fc1(x)))
        return F.relu(self.ln2(self.fc2(x)))


class AttentionFusion(nn.Module):
    """Feature-level attention (model.py:6-23): per-modality scalar scores
    Linear(D,128)→Tanh→Linear(128,1), softmax over modalities, weighted sum."""

    def __init__(self, dim: int = SHARED_DIM):
        super().__init__()
        self.attn1 = nn.Linear(dim, 128)
        self.attn2 = nn.Linear(128, 1)

    def forward(self, features: Sequence[torch.Tensor]):
        stacked = torch.stack(list(features), dim=1)  # [B, M, D]
        scores = self.attn2(torch.tanh(self.attn1(stacked)))[..., 0]
        return (stacked * torch.softmax(scores, dim=1)[..., None]).sum(dim=1)


class AttentionFusionLate(nn.Module):
    """Logit-level attention (model.py:25-40): concat logits →
    Linear→ReLU→Linear(M) → softmax weights → weighted logit sum."""

    def __init__(self, num_modalities: int, num_classes: int):
        super().__init__()
        self.attn1 = nn.Linear(num_modalities * num_classes, 128)
        self.attn2 = nn.Linear(128, num_modalities)

    def forward(self, logits: Sequence[torch.Tensor]):
        scores = self.attn2(F.relu(self.attn1(torch.cat(list(logits), dim=1))))
        weights = torch.softmax(scores, dim=1)[..., None]  # [B, M, 1]
        return (torch.stack(list(logits), dim=1) * weights).sum(dim=1)


class MultiModalFusionNet(nn.Module):
    def __init__(self,
                 modality: Sequence[str] = ("image", "radiomics", "clinical",
                                            "artifacts"),
                 fusion_level: str = "intermediate",
                 fusion_strategy: str = "attention",
                 radiomics_dim: int = 780, num_sex_classes: int = 3,
                 num_loc_classes: int = 15, num_artifact_classes: int = 6,
                 num_classes: int = 7, backbone: str = "efficientnet-b3",
                 dtype: torch.dtype = torch.float32,
                 backbone_bn_folded: bool = False,
                 backbone_pallas_serving: bool = False):
        super().__init__()
        if fusion_level not in ("intermediate", "late"):
            raise ValueError(fusion_level)
        if fusion_strategy not in ("concat", "weighted", "attention"):
            raise ValueError(fusion_strategy)
        self.modality = tuple(modality)
        self.fusion_level, self.fusion_strategy = fusion_level, fusion_strategy
        self.num_artifact_classes = num_artifact_classes
        late = fusion_level == "late"
        m = len(self.modality)

        if "image" in self.modality:
            self.image_model = EfficientNet(
                backbone, bn_folded=backbone_bn_folded,
                pallas_serving=backbone_pallas_serving).to(dtype)
            self.image_proj = ProjMlp(feature_dim(backbone), 256, SHARED_DIM)
        if "radiomics" in self.modality:
            self.radiomics_mlp = ProjMlp(radiomics_dim, 256, SHARED_DIM)
        if "clinical" in self.modality:
            self.sex_emb = nn.Embedding(num_sex_classes, 4)
            self.loc_emb = nn.Embedding(num_loc_classes, 8)
            self.clinical_mlp = ProjMlp(13, 64, SHARED_DIM)
        if "artifacts" in self.modality:
            for i in range(num_artifact_classes):
                self.add_module(f"artifact_emb_{i}", nn.Embedding(2, 2))
            self.artifact_mlp = ProjMlp(2 * num_artifact_classes, 64, SHARED_DIM)
        if late:
            for mod in self.modality:
                self.add_module(f"head_{mod}", nn.Linear(SHARED_DIM, num_classes))
        if fusion_strategy == "weighted":
            self.weights = nn.Parameter(torch.ones(m) / m)
        elif fusion_strategy == "attention":
            self.attention = (AttentionFusionLate(m, num_classes) if late
                              else AttentionFusion())
        if not late:
            din = SHARED_DIM if fusion_strategy == "attention" else SHARED_DIM * m
            self.fusion_fc1 = nn.Linear(din, 256)
            self.fusion_fc2 = nn.Linear(256, num_classes)

    def forward(self, image=None, radiomics=None, age=None, sex=None, loc=None,
                artifacts=None, image_features: Optional[torch.Tensor] = None):
        """Per-modality branches → fusion → [B, num_classes] logits.
        ``image`` is NHWC; ``image_features`` (pre-extracted backbone
        features) may replace it."""
        late = self.fusion_level == "late"
        outs = []  # features (intermediate) or logits (late), modality order

        def add(name, feat):
            outs.append(getattr(self, f"head_{name}")(feat) if late else feat)

        if "image" in self.modality:
            if image_features is None:
                image_features = self.image_model(image)
            add("image", self.image_proj(image_features))
        if "radiomics" in self.modality:
            add("radiomics", self.radiomics_mlp(radiomics))
        if "clinical" in self.modality:
            clin = torch.cat([age[:, None], self.sex_emb(sex), self.loc_emb(loc)],
                             dim=1)
            add("clinical", self.clinical_mlp(clin))
        if "artifacts" in self.modality:
            arts = [getattr(self, f"artifact_emb_{i}")(artifacts[:, i])
                    for i in range(self.num_artifact_classes)]
            add("artifacts", self.artifact_mlp(torch.cat(arts, dim=1)))

        if not late:
            if self.fusion_strategy == "concat":
                fused = torch.cat(outs, dim=1)
            elif self.fusion_strategy == "weighted":
                w = torch.softmax(self.weights, dim=0)
                fused = torch.cat([wi * f for wi, f in zip(w, outs)], dim=1)
            else:
                fused = self.attention(outs)
            return self.fusion_fc2(F.relu(self.fusion_fc1(fused)))
        if self.fusion_strategy == "concat":  # sum of logits (model.py:219-221)
            return torch.stack(outs, dim=1).sum(dim=1)
        if self.fusion_strategy == "weighted":
            w = torch.softmax(self.weights, dim=0)
            return sum(wi * z for wi, z in zip(w, outs))
        return self.attention(outs)


def fold_fusion_params(state_dict: Dict[str, torch.Tensor],
                       backbone: str = "efficientnet-b3"
                       ) -> Dict[str, torch.Tensor]:
    """Serving-time transform for the whole fusion net: fold the image
    backbone's BN into its conv weights.  Returns the state dict for
    ``MultiModalFusionNet(backbone_bn_folded=True)``; branch MLPs and heads
    (LayerNorm, no BN) pass through."""
    out = {k: v for k, v in state_dict.items()
           if not k.startswith("image_model.")}
    if any(k.startswith("image_model.") for k in state_dict):
        out.update(fold_batchnorm(state_dict, backbone, prefix="image_model."))
    return out
