"""Share of its roofline of the fused LN-MLP backward (B10
``fused_ln_mlp_backward``, several kernels a call) in a MaxViT training
step: the bound of each call the model puts on the kernels (``ln_mlp_calls``
of the builder; ``flops.b10_bound_ms``) over the device time of the kernels
named below, per step of the traced segment (layer: kernels)."""

import torch

from gpubench import flops
from gpubench.readers import roofline

PATTERN = r"ln_mlp_bwd_"


def read(ctx):
    t = ctx["traffic"]
    dtype = torch.bfloat16 if t["dtype"] == "bfloat16" else torch.float32
    calls = ctx["builder"].ln_mlp_calls(ctx["config"], t["batch"])
    bound = sum(n * flops.bound(flops.b10_bound_ms(dtype, b * hw * hw, c))
                for b, hw, c, n in calls)
    return roofline(ctx, PATTERN, bound, None)
