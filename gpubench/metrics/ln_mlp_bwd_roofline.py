"""Share of its roofline of the fused LN-MLP backward (B10
``fused_ln_mlp_backward``, several kernels a call) in a training step: the
bound of each conv-stage block's call at the step's shapes
(``flops.b10_bound_ms``) over the device time of the kernels named below,
per step of the traced segment (layer: kernels)."""

import torch

from gpubench import flops
from gpubench.readers import roofline

PATTERN = r"ln_mlp_bwd_"


def read(ctx):
    cfg, t = ctx["config"], ctx["traffic"]
    dtype = torch.bfloat16 if t["dtype"] == "bfloat16" else torch.float32
    s, b = cfg["img_size"], t["batch"]
    bound = sum(n * flops.bound(flops.b10_bound_ms(dtype, b * hw * hw, c))
                for hw, c, n in ((s // 4, cfg["embed_dims"][0], cfg["depths"][0]),
                                 (s // 8, cfg["embed_dims"][1], cfg["depths"][1])))
    return roofline(ctx, PATTERN, bound, None)
