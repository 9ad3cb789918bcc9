"""Three forwards' FLOPs an image trained times the traced window's
img/s, as a share of the peak at the cell's precision (float32 without
TF32: 67 TFLOP/s) (layer: model step)."""

from gpubench.readers import mfu


def read(ctx):
    return mfu(ctx, train=True)
