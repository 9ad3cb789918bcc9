"""Share of its roofline of the fused LN-MLP forward (B9 ``fused_ln_mlp``)
over an encoder forward: the bound of each conv-stage block's call at the
batch's shapes (``flops.mae_bound_ms``) over the device time of the kernel
named below, per batch of the traced segment (layer: kernels)."""

import torch

from gpubench import flops
from gpubench.readers import roofline

PATTERN = r"fused_ln_mlp_kernel"


def calls(cfg, b):
    """(geometry, calls) of the fused MLP in one forward: the conv stages'
    blocks at 1/4 and 1/8 of the image size."""
    s = cfg["img_size"]
    return [((b, s // 4, cfg["embed_dims"][0]), cfg["depths"][0]),
            ((b, s // 8, cfg["embed_dims"][1]), cfg["depths"][1])]


def read(ctx):
    t = ctx["traffic"]
    dtype = torch.bfloat16 if t["dtype"] == "bfloat16" else torch.float32
    geos = calls(ctx["config"], t["batch"])
    bound = sum(n * flops.bound(flops.mae_bound_ms("fused_ln_mlp", dtype, g))
                for g, n in geos)
    return roofline(ctx, PATTERN, bound, sum(n for _, n in geos))
