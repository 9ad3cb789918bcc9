"""Plain float32 forward of the multimodal fusion classifier: an
EfficientNet backbone (Tan & Le 2019) with TF-SAME padding, BatchNorm
(eps 1e-3), squeeze-excitation and drop-connect, and the radiomics,
clinical and artifact MLPs of the reference ``rbuler/multimodal-isic``
``model.py``, fused by concatenation at the intermediate level.

Functional: the parameters are a dict keyed as the port's state dict, so
one seeded dict feeds both.  ``train`` uses batch statistics and draws
dropout and drop-connect from ``rng`` in module order (the port's order);
eval uses the running statistics.  ``lowp`` (a function on tensors) rounds
both operands of every convolution and product of the backbone: the lower
precision control.  Imports nothing of the port.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..flops import effnet_blocks

BN_EPS = 1e-3
LN_EPS = 1e-6
Params = Dict[str, torch.Tensor]


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """TF-SAME zero padding of an NCHW tensor."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class Net:
    def __init__(self, cfg: Dict, params: Params, lowp: Optional[Callable] = None):
        self.cfg, self.p = cfg, params
        self.q = lowp or (lambda t: t)
        self.blocks = effnet_blocks(cfg["width_coefficient"],
                                    cfg["depth_coefficient"])

    def conv(self, x, name, stride=1, groups=1, bias=False):
        w = self.p[f"{name}.weight"]
        k = w.shape[-1]
        b = self.p[f"{name}.bias"] if bias else None
        return F.conv2d(_same_pad(self.q(x), k, stride), self.q(w), b,
                        stride=stride, groups=groups)

    def bn(self, x, name, train):
        p = self.p
        if train:
            return F.batch_norm(x, None, None, p[f"{name}.weight"],
                                p[f"{name}.bias"], True, 0.0, BN_EPS)
        return F.batch_norm(x, p[f"{name}.running_mean"],
                            p[f"{name}.running_var"], p[f"{name}.weight"],
                            p[f"{name}.bias"], False, 0.0, BN_EPS)

    @staticmethod
    def dropout(x, rate, train, rng):
        if not train or rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def backbone(self, img_nhwc, train, rng):
        pre = "image_model."
        x = img_nhwc.permute(0, 3, 1, 2)
        x = F.silu(self.bn(self.conv(x, pre + "stem_conv", 2), pre + "stem_bn",
                           train))
        n = len(self.blocks)
        for i, (expand, k, stride, cin, cout) in enumerate(self.blocks):
            b = f"{pre}blocks.{i}."
            inp = x
            if expand != 1:
                x = F.silu(self.bn(self.conv(x, b + "expand_conv"), b + "bn0",
                                   train))
            x = self.conv(x, b + "depthwise_conv", stride, groups=x.shape[1])
            x = F.silu(self.bn(x, b + "bn1", train))
            se = x.mean(dim=(2, 3))
            se = F.silu(self.linear(se, b + "se_reduce"))
            se = self.linear(se, b + "se_expand")
            x = x * torch.sigmoid(se)[:, :, None, None]
            x = self.bn(self.conv(x, b + "project_conv"), b + "bn2", train)
            if stride == 1 and cin == cout:
                rate = self.cfg["drop_connect_rate"] * i / n
                if train and rate > 0.0:
                    keep = 1.0 - rate
                    m = torch.rand((x.shape[0], 1, 1, 1), generator=rng,
                                   device=x.device) < keep
                    x = x / keep * m.to(x.dtype)
                x = x + inp
        x = F.silu(self.bn(self.conv(x, pre + "head_conv"), pre + "head_bn",
                           train))
        return self.dropout(x.mean(dim=(2, 3)), self.cfg["feature_dropout"],
                            train, rng)

    def linear(self, x, name):
        """A 1×1 conv's or a Linear's weights on a [B, C] tensor."""
        w = self.p[f"{name}.weight"]
        return F.linear(self.q(x), self.q(w.reshape(w.shape[0], -1)),
                        self.p[f"{name}.bias"])

    def proj(self, x, name, drop1, drop2, train, rng):
        p = self.p
        for i, rate in ((1, drop1), (2, drop2)):
            x = F.linear(x, p[f"{name}.fc{i}.weight"], p[f"{name}.fc{i}.bias"])
            x = F.layer_norm(x, x.shape[-1:], p[f"{name}.ln{i}.weight"],
                             p[f"{name}.ln{i}.bias"], LN_EPS)
            x = self.dropout(F.relu(x), rate, train, rng)
        return x

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """batch: 'image' [B, H, W, 3] float32 (preprocessed), 'radiomics',
        'age', 'sex', 'loc', 'artifacts' → logits [B, classes]."""
        p = self.p
        feats = [self.proj(self.backbone(batch["image"], train, rng),
                           "image_proj", 0.3, 0.2, train, rng),
                 self.proj(batch["radiomics"], "radiomics_mlp", 0.4, 0.3,
                           train, rng)]
        clin = torch.cat([batch["age"][:, None].float(),
                          p["sex_emb.weight"][batch["sex"].long()],
                          p["loc_emb.weight"][batch["loc"].long()]], dim=1)
        feats.append(self.proj(clin, "clinical_mlp", 0.2, 0.2, train, rng))
        arts = torch.cat([p[f"artifact_emb_{i}.weight"][batch["artifacts"][:, i].long()]
                          for i in range(self.cfg["num_artifact_classes"])],
                         dim=1)
        feats.append(self.proj(arts, "artifact_mlp", 0.2, 0.2, train, rng))
        x = F.relu(F.linear(torch.cat(feats, dim=1), p["fusion_fc1.weight"],
                            p["fusion_fc1.bias"]))
        x = self.dropout(x, 0.4, train, rng)
        return F.linear(x, p["fusion_fc2.weight"], p["fusion_fc2.bias"])
