"""Median host ms of the harness's call into the training step, without
a sync, over the window (layer: host dispatch)."""

from gpubench.readers import median_of


def read(ctx):
    return median_of(ctx, "dispatch_ms")
