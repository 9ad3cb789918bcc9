"""Share of the traced segment in which no operation ran on the device
(the union of kernel, copy and set intervals in the profiler's timeline)
(layer: device)."""

from gpubench.readers import idle


def read(ctx):
    return idle(ctx)
