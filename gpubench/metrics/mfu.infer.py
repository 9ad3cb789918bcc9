"""The forward's FLOPs an image (counted from the configuration's
shapes) times the traced window's img/s, as a share of the peak at the
cell's precision (layer: model step)."""

from gpubench.readers import mfu


def read(ctx):
    return mfu(ctx, train=False)
