"""Share of its roofline of the warp kernel (B3 ``affine_warp_batch``) in
the fast fusion policy: one call a step at the batch's shapes
(``flops.warp_bound_ms``) over the device time of the kernel named below,
per step of the traced segment (layer: kernels)."""

from gpubench import flops
from gpubench.readers import roofline

PATTERN = r"affine_warp_kernel"


def read(ctx):
    s = ctx["config"]["image_size"]
    bound = flops.bound(flops.warp_bound_ms(ctx["traffic"]["batch"], s, s, 3,
                                            (s, s)))
    return roofline(ctx, PATTERN, bound, 1)
