"""Stream ms of the program's ``maxvit.block_attn`` spans a step: the
block-attention sub-blocks of the MaxViT's forward (LayerNorm, q/k/v, the
window partition, attention, un-partition, projection, residual add),
summed over the step's 24, mean over the device-only segment's steps
(layer: model step; ``unit_spans.py``)."""

from gpubench.unit_spans import summed_stream_ms


def read(ctx):
    return summed_stream_ms(ctx, "maxvit.block_attn")
