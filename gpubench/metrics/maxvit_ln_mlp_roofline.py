"""Share of its roofline of the fused LN-MLP forward (B9 ``fused_ln_mlp``)
in a MaxViT training step: the bound of each call the model puts on the
kernel (``ln_mlp_calls`` of the builder; ``flops.mae_bound_ms``) over the
device time of the kernel named below, per step of the traced segment
(layer: kernels)."""

import torch

from gpubench import flops
from gpubench.readers import roofline

PATTERN = r"fused_ln_mlp_kernel"


def read(ctx):
    t = ctx["traffic"]
    dtype = torch.bfloat16 if t["dtype"] == "bfloat16" else torch.float32
    calls = ctx["builder"].ln_mlp_calls(ctx["config"], t["batch"])
    bound = sum(n * flops.bound(flops.mae_bound_ms("fused_ln_mlp", dtype,
                                                   (b, hw, c)))
                for b, hw, c, n in calls)
    return roofline(ctx, PATTERN, bound, sum(n for *_, n in calls))
