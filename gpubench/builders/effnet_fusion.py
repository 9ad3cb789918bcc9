"""The EfficientNet fusion classifier: the port's side and the reference's.

Tasks:

- ``serve``: the CLI's test pass on the serving path.  Set-up folds the
  backbone's BatchNorm into its convolutions (``fold_fusion_params``) and
  loads the result into the BN-folded net on the fused MBConv kernels
  (``backbone_pallas_serving``) in the traffic's dtype.  A batch is
  ``preprocess_eval_batch`` of its uint8 crops, then the net under
  ``torch.inference_mode()``; the logits are the answer.  The reference is
  the unfolded float32 net with eval BatchNorm.
- ``train``: the CLI's device-resident epoch with ``augment_fast``: each
  step gathers its rows, runs ``make_fusion_train_fast`` (the warp kernel)
  and the ``make_fusion_train_step`` of ``fusion_optimizer`` (SGD).  The
  reference runs the same policy, dropout and SGD in plain float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from gpubench.reference import augment as ref_aug
from gpubench.reference.effnet_fusion import Net
from gpubench.tasks import (TrainTask, fusion_meta, generator, to_host,
                            uint8_noise)
from gpubench.weights import seeded_state

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
META = ("radiomics", "age", "sex", "loc", "artifacts")


def _model_kwargs(cfg: Dict) -> Dict:
    return dict(modality=tuple(cfg["modality"]),
                fusion_level=cfg["fusion_level"],
                fusion_strategy=cfg["fusion"],
                radiomics_dim=cfg["radiomics_dim"],
                num_sex_classes=cfg["num_sex_classes"],
                num_loc_classes=cfg["num_loc_classes"],
                num_artifact_classes=cfg["num_artifact_classes"],
                num_classes=cfg["num_classes"], backbone=cfg["backbone"])


def _empty(device, **kw):
    from multimodal_isic_tpu_torch.models.fusion import MultiModalFusionNet
    with torch.device("meta"):
        model = MultiModalFusionNet(**kw)
    return model.to_empty(device=device)


def _weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded float32 state of the unfolded net (parameters and
    BatchNorm statistics), by name and shape."""
    from multimodal_isic_tpu_torch.models.fusion import MultiModalFusionNet
    with torch.device("meta"):
        shapes = MultiModalFusionNet(**_model_kwargs(cfg)).state_dict()
    return seeded_state(((k, v.shape) for k, v in shapes.items()),
                        seed, device)


class Serve:
    compare = "logits"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        from multimodal_isic_tpu_torch.models.fusion import fold_fusion_params
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.dtype = DTYPES[traffic["dtype"]]
        self.hw = (cfg["image_size"], cfg["image_size"])
        state = _weights(cfg, seed, self.device)
        folded = fold_fusion_params(state, backbone=cfg["backbone"])
        self.net = _empty(self.device, **_model_kwargs(cfg), dtype=self.dtype,
                          backbone_bn_folded=True,
                          backbone_pallas_serving=True)
        self.net.load_state_dict(folded)
        self.net.eval()
        del state, folded
        gen = generator(seed, "pool", self.device)
        n, (h, w) = traffic["pool"], traffic["crop_hw"]
        pin = self.device.type == "cuda"
        images = uint8_noise(gen, (n, h, w, 3), self.device)
        meta = fusion_meta(gen, n, cfg, self.device)
        self.pool = {"image": to_host(images, pin)}
        self.pool.update({k: to_host(meta[k], pin) for k in META})
        del images, meta

    def preprocess(self, batch):
        from multimodal_isic_tpu_torch.data.augment import preprocess_eval_batch
        return preprocess_eval_batch(batch["image"], self.hw, dtype=self.dtype)

    def model(self, x, batch):
        return self.net(image=x, **{k: batch[k] for k in META})

    def out_shape(self):
        return (self.traffic["batch"], self.cfg["num_classes"]), torch.float32

    def release(self):
        del self.net

    @torch.no_grad()
    def reference(self, batch, lowp=None):
        net = Net(self.cfg, _weights(self.cfg, self.seed, self.device),
                  lowp)
        inputs = {k: batch[k] for k in META}
        inputs["image"] = ref_aug.eval_batch(batch["image"], self.hw)
        return net.forward(inputs, train=False)


class Train(TrainTask):
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        from multimodal_isic_tpu_torch.data.augment import make_fusion_train_fast
        from multimodal_isic_tpu_torch.train.fusion import (
            fusion_optimizer, make_fusion_train_step)
        super().__init__(cfg, traffic, seed, device)
        self.hw = (cfg["image_size"], cfg["image_size"])
        self.model = _empty(self.device, **_model_kwargs(cfg))
        self.model.load_state_dict(_weights(cfg, seed, self.device))
        self.model.train()
        self.optimizer = fusion_optimizer(self.model, lr=traffic["lr"],
                                          weight_decay=traffic["weight_decay"])
        self.train_step = make_fusion_train_step(self.model, self.optimizer)
        self.policy = make_fusion_train_fast(self.hw)
        gen = generator(seed, "pool", self.device)
        n, (h, w) = traffic["pool"], traffic["crop_hw"]
        self.images = uint8_noise(gen, (n, h, w, 3), self.device)
        self.meta = fusion_meta(gen, n, cfg, self.device)
        self.aug_gen = generator(seed, "augment", self.device)
        self.drop_gen = generator(seed, "dropout", self.device)
        self.make_order()

    def augment(self, batch):
        x, _ = self.policy(batch["image_u8"], None, self.aug_gen)
        return x

    def model_step(self, x, batch):
        inputs = {k: batch[k] for k in META + ("target",)}
        inputs["image"] = x
        loss, _ = self.train_step(inputs, self.drop_gen)
        return loss

    def grad_leaves(self):
        # SGD without momentum keeps no state: the gradient it was handed
        return {k: p.grad for k, p in self.model.named_parameters()}

    def release(self):
        del self.model, self.optimizer, self.train_step

    def reference_steps(self, n: int, control: Optional[str] = None) -> Dict:
        from gpubench.reference.lowp import tf32
        state = _weights(self.cfg, self.seed, self.device)
        p = {k: v.requires_grad_(True) for k, v in state.items()
             if not k.endswith(("running_mean", "running_var"))}
        p0 = {k: v.detach().clone() for k, v in p.items()}
        net = Net(self.cfg, state)
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
        return self.reference_result(losses, grad, p0,
                                     {k: v.detach() for k, v in p.items()})


TASKS = {"serve": Serve, "train": Train}


def make(task: str, cfg: Dict, traffic: Dict, seed: int, device):
    return TASKS[task](cfg, traffic, seed, device)


def forward_flops(cfg: Dict, traffic: Dict) -> float:
    """FLOPs of one image's forward through the fusion net."""
    from gpubench.flops import effnet_fusion_flops
    return effnet_fusion_flops(cfg)
