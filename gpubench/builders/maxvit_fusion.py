"""The fusion classifier with a MaxViT image branch: the port's side and the
reference's.

Task ``train``: the CLI's device-resident epoch with ``augment_fast``, as
``effnet_fusion.Train``: each step gathers its rows, runs
``make_fusion_train_fast`` at the configuration's image size (the warp
kernel and the colour-jitter kernel) and the ``make_fusion_train_step`` of
``fusion_optimizer`` (SGD) on ``MultiModalFusionNet(backbone=...)``.  The
reference (``reference/maxvit_fusion.py``) runs the same policy, dropout,
stochastic depth and SGD in plain float32.  Its control is ``tf32``, the
reference with TF32 on; ``fp8`` rounds the operands of its products instead
(a control the CPU can compute).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from gpubench.builders.effnet_fusion import META, Train as EffnetTrain
from gpubench.builders.effnet_fusion import _weights
from gpubench.flops import _mlp_flops
from gpubench.reference import augment as ref_aug
from gpubench.reference.maxvit_fusion import Net
from gpubench.tasks import generator


class Train(EffnetTrain):
    def reference_steps(self, n: int, control: Optional[str] = None) -> Dict:
        from gpubench.reference.lowp import fp8, tf32
        state = _weights(self.cfg, self.seed, self.device)
        p = {k: v.requires_grad_(True) for k, v in state.items()
             if not k.endswith(("running_mean", "running_var"))}
        p0 = {k: v.detach().clone() for k, v in p.items()}
        net = Net(self.cfg, state, fp8 if control == "fp8" else None)
        aug = generator(self.seed, "augment", self.device)
        drop = generator(self.seed, "dropout", self.device)
        lr, wd = self.traffic["lr"], self.traffic["weight_decay"]
        losses, grad = [], None
        with tf32(control == "tf32"):
            for k in range(n):
                batch = self.gather(k)
                inputs = {c: batch[c] for c in META}
                inputs["image"] = ref_aug.fusion_train(batch["image_u8"], aug,
                                                       self.hw)
                logits = net.forward(inputs, train=True, rng=drop)
                loss = F.cross_entropy(logits, batch["target"])
                g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
                if k == 0:
                    grad = {c: v.detach() for c, v in g.items()}
                with torch.no_grad():
                    for c in p:
                        p[c].sub_(lr * (g[c] + wd * p[c]))
                losses.append(loss.detach())
                del logits, loss, g
        return self.reference_result(losses, grad, p0,
                                     {k: v.detach() for k, v in p.items()})


TASKS = {"train": Train}


def make(task: str, cfg: Dict, traffic: Dict, seed: int, device):
    return TASKS[task](cfg, traffic, seed, device)


def maxvit_fusion_flops(cfg: Dict) -> float:
    """Forward FLOPs of one image through the fusion net, 2 a multiply-add
    of every convolution and product: the stem, each block's MBConv
    (shortcut, expand at the input's size, depthwise, SE, project), its two
    attentions (q/k/v and output projections, QKᵀ and PV over groups of
    window² tokens) and two MLPs, then the four branch MLPs and the fusion
    head."""
    s = cfg["image_size"] // 2
    stem = cfg["stem"]
    total = 2 * s * s * 27 * stem + 2 * s * s * 9 * stem * stem
    n = cfg["window"] ** 2
    cin = stem
    for width, depth in zip(cfg["widths"], cfg["depths"]):
        for j in range(depth):
            h_in = s
            if j == 0:
                s //= 2
            t = s * s
            mid = cfg["expansion"] * width
            se = int(width * cfg["se_ratio"])
            if cin != width:
                total += 2 * t * cin * width
            total += (2 * h_in * h_in * cin * mid + 2 * t * 9 * mid
                      + 4 * mid * se + 2 * t * mid * width)
            total += 2 * (2 * t * width * 4 * width + 4 * t * n * width)
            total += 2 * 4 * t * width * cfg["mlp_ratio"] * width
            cin = width
    shared = cfg["shared_dim"]
    total += _mlp_flops([cin, 256, shared])
    total += _mlp_flops([cfg["radiomics_dim"], 256, shared])
    total += _mlp_flops([13, 64, shared])
    total += _mlp_flops([2 * cfg["num_artifact_classes"], 64, shared])
    total += _mlp_flops([4 * shared, 256, cfg["num_classes"]])
    return float(total)


def ln_mlp_calls(cfg: Dict, batch: int) -> List[Tuple[int, int, int, int]]:
    """(batch, side, C, calls a step) of the MLPs the model puts on the
    fused LN-MLP kernels (B9 forward, B10 backward): two a block in each
    stage whose C and F ``check_ln_mlp_kernel_shape`` admits, stage ``i``
    at ``image_size / 2^(i+2)`` a side (MaxViT-B: the 28 of stage 3 at
    24², C 384)."""
    from multimodal_isic_tpu_torch.ops.fused_mlp import \
        check_ln_mlp_kernel_shape
    out = []
    for i, (c, depth) in enumerate(zip(cfg["widths"], cfg["depths"])):
        try:
            check_ln_mlp_kernel_shape(c, cfg["mlp_ratio"] * c)
        except ValueError:
            continue
        out.append((batch, cfg["image_size"] // 2 ** (i + 2), c, 2 * depth))
    return out


def forward_flops(cfg: Dict, traffic: Dict) -> float:
    """FLOPs of one image's forward through the fusion net."""
    return maxvit_fusion_flops(cfg)
