"""Stream ms of the program's ``maxvit.mbconv`` spans a step: the MBConv
sub-blocks of the MaxViT's forward (pre-norm BatchNorm to the residual
add), summed over the step's 24, mean over the device-only segment's steps
(layer: model step; ``unit_spans.py``)."""

from gpubench.unit_spans import summed_stream_ms


def read(ctx):
    return summed_stream_ms(ctx, "maxvit.mbconv")
