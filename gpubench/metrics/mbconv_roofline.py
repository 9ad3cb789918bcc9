"""Share of their roofline of the fused MBConv kernels (B1
``expand_dw_silu_pool``, B2 ``dw_silu_pool``) over a serving forward: the
bound of every stride-1 block's call at the batch's shapes (``flops.
fused_bound_ms``) over the device time of the kernels named below, per
batch of the traced segment (layer: kernels)."""

from gpubench import flops
from gpubench.readers import roofline

PATTERN = r"mbconv_(expand|dw)_kernel"


def read(ctx):
    b = ctx["traffic"]["batch"]
    esz = 2 if ctx["traffic"]["dtype"] == "bfloat16" else 4
    geos = flops.serving_geometries(ctx["config"])
    bound = sum(flops.bound(flops.fused_bound_ms(g, b, esz)) for g in geos)
    return roofline(ctx, PATTERN, bound, len(geos))
