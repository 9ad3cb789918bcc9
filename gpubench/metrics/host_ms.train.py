"""Median host ms of the program's ``step`` span, over the device-only
segment's steps, read under that segment's profiler: not the host's
dispatch time without one (layer: host dispatch; ``spans.py``)."""

from gpubench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "step")
