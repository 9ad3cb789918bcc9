"""Median host ms of the program's forward span a batch (``fusion.forward``
or ``convmae.encode``), over the device-only segment's batches, read under
that segment's profiler: not the host's dispatch time without one (layer:
host dispatch; ``spans.py``)."""

from gpubench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "fusion.forward", "convmae.encode")
