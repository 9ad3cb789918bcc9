"""ConvMAE: the port's side and the reference's.

Tasks:

- ``latent``: ``cli.save_latent``'s extraction.  The encoder-only model in
  the traffic's dtype with the flags the CLI sets on a card (the fused
  LN-MLP on, flash attention and the fused front off).  A batch is
  ``mae_eval_batch`` of its uint8 crops and masks, then
  ``make_encoder_step``; the [B, 196, D] float32 latents are the answer.
- ``pretrain``: ``cli.train_ae``'s device-resident epoch: each step gathers
  its rows, runs ``mae_train_batch`` and the ``make_mae_train_step`` of
  ``mae_optimizer`` (AdamW), the model built with the keyword arguments of
  ``cli.train_ae.model_config``, so the kernel flags are the program's.

The reference is the plain float32 ConvMAE with the same draws (crops,
flips, masking) made from the same seeds, and AdamW written out.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from gpubench.reference import augment as ref_aug
from gpubench.reference.convmae import Net, masking
from gpubench.tasks import TrainTask, adamw_, generator, to_host, uint8_noise
from gpubench.weights import seeded_state

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dims(cfg: Dict) -> Dict:
    return dict(img_size=cfg["img_size"], embed_dims=tuple(cfg["embed_dims"]),
                depths=tuple(cfg["depths"]), num_heads=cfg["num_heads"],
                decoder_dim=cfg["decoder_dim"],
                decoder_depth=cfg["decoder_depth"],
                decoder_heads=cfg["decoder_heads"])


def _empty(device, **kw):
    from multimodal_isic_tpu_torch.models.convmae import ConvMAE
    with torch.device("meta"):
        model = ConvMAE(**kw)
    return model.to_empty(device=device)


def _weights(cfg: Dict, seed: int, device, decoder: bool):
    from multimodal_isic_tpu_torch.models.convmae import ConvMAE
    with torch.device("meta"):
        shapes = ConvMAE(**_dims(cfg), with_decoder=decoder).state_dict()
    return seeded_state(((k, v.shape) for k, v in shapes.items()), seed,
                        device)


class Latent:
    compare = "latents"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.hw = (cfg["img_size"], cfg["img_size"])
        self.dtype = DTYPES[traffic["dtype"]]
        from multimodal_isic_tpu_torch.train.mae import make_encoder_step
        # cli/save_latent.py: encoder only, the fused MLP on a card
        self.net = _empty(self.device, **_dims(cfg), with_decoder=False,
                          dtype=self.dtype,
                          use_fused_mlp=self.device.type == "cuda")
        self.net.load_state_dict(_weights(cfg, seed, self.device, False))
        self.encode = make_encoder_step(self.net)
        gen = generator(seed, "pool", self.device)
        n, (h, w) = traffic["pool"], traffic["crop_hw"]
        pin = self.device.type == "cuda"
        self.pool = {"image": to_host(uint8_noise(gen, (n, h, w, 3),
                                                  self.device), pin),
                     "mask": to_host(uint8_noise(gen, (n, h, w), self.device),
                                     pin)}

    def preprocess(self, batch):
        from multimodal_isic_tpu_torch.data.augment import mae_eval_batch
        return mae_eval_batch(batch["image"], batch["mask"], self.hw)[0]

    def model(self, x, batch):
        return self.encode(x)[0]

    def out_shape(self):
        n = (self.cfg["img_size"] // 16) ** 2
        return ((self.traffic["batch"], n, self.cfg["embed_dims"][2]),
                torch.float32)

    def release(self):
        del self.net, self.encode

    @torch.no_grad()
    def reference(self, batch, lowp=None):
        net = Net(self.cfg, _weights(self.cfg, self.seed, self.device, False),
                  lowp)
        return net.encode(ref_aug.eval_batch(batch["image"], self.hw))


class Pretrain(TrainTask):
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        from multimodal_isic_tpu_torch.cli.train_ae import model_config
        from multimodal_isic_tpu_torch.data.augment import mae_train_batch
        from multimodal_isic_tpu_torch.train.mae import (make_mae_train_step,
                                                         mae_optimizer)
        super().__init__(cfg, traffic, seed, device)
        self.hw = (cfg["img_size"], cfg["img_size"])
        kw = model_config({"norm_pix_loss": cfg["norm_pix_loss"],
                           "model_size": "base"}, self.device)
        self.model = _empty(self.device, **{**kw, **_dims(cfg)})
        self.model.load_state_dict(_weights(cfg, seed, self.device, True))
        self.model.train()
        self.optimizer = mae_optimizer(self.model)
        self.train_step = make_mae_train_step(self.model, self.optimizer,
                                              traffic["masking_ratio"])
        self.policy = mae_train_batch
        gen = generator(seed, "pool", self.device)
        n, (h, w) = traffic["pool"], traffic["crop_hw"]
        self.images = uint8_noise(gen, (n, h, w, 3), self.device)
        self.aug_gen = generator(seed, "augment", self.device)
        self.mask_gen = generator(seed, "mask", self.device)
        self.make_order()

    def augment(self, batch):
        return self.policy(batch["image_u8"], None, self.aug_gen, self.hw)[0]

    def model_step(self, x, batch):
        return self.train_step(x, None, self.mask_gen)

    def grad_leaves(self):
        # AdamW's first moment after one step is (1 - beta1) · g; a leaf
        # the optimizer never stepped has none (read as a zero gradient)
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        state = self.optimizer.state
        return {k: state[p]["exp_avg"] / (1.0 - beta1) if "exp_avg" in state[p]
                else torch.zeros_like(p)
                for k, p in self.model.named_parameters()}

    def release(self):
        del self.model, self.optimizer, self.train_step

    def reference_steps(self, n: int, control: Optional[str] = None) -> Dict:
        from gpubench.reference.lowp import tf32
        p = {k: v.requires_grad_(True)
             for k, v in _weights(self.cfg, self.seed, self.device,
                                  True).items()}
        p0 = {k: v.detach().clone() for k, v in p.items()}
        net = Net(self.cfg, p)
        aug = generator(self.seed, "augment", self.device)
        mask = generator(self.seed, "mask", self.device)
        t = self.traffic
        lrs = {k: t["decoder_lr"] if "decoder" in k else t["encoder_lr"]
               for k in p}
        grid = (self.cfg["img_size"] // 16) ** 2
        state, losses, grad = {}, [], None
        with tf32(control == "tf32"):
            for k in range(n):
                x = ref_aug.mae_train(self.gather(k)["image_u8"], aug, self.hw)
                m = masking(mask, x.shape[0], grid, t["masking_ratio"])
                loss = net.loss(x, m)
                g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
                if k == 0:
                    grad = {c: v.detach() for c, v in g.items()}
                with torch.no_grad():
                    adamw_(p, g, state, k + 1, lrs, t["weight_decay"])
                losses.append(loss.detach())
        return self.reference_result(losses, grad, p0,
                                     {k: v.detach() for k, v in p.items()})


TASKS = {"latent": Latent, "pretrain": Pretrain}


def make(task: str, cfg: Dict, traffic: Dict, seed: int, device):
    return TASKS[task](cfg, traffic, seed, device)


def forward_flops(cfg: Dict, traffic: Dict) -> float:
    """FLOPs of one image's forward: the encoder alone for latents, the
    masked encoder and the decoder for pretraining."""
    from gpubench.flops import convmae_flops
    if traffic["task"] == "latent":
        return convmae_flops(cfg, 0.0, decoder=False)
    return convmae_flops(cfg, traffic["masking_ratio"], decoder=True)
