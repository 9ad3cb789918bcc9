"""Share of the traced segment in which no operation ran on the device
(layer: device)."""

from gpubench.readers import idle


def read(ctx):
    return idle(ctx)
