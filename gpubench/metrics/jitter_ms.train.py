"""Mean stream ms of the program's ``preprocess.jitter`` span (the fast
policy's ``color_jitter``) a step, over the device-only segment's steps
(layer: preprocess; ``spans.py``)."""

from gpubench.spans import stream_ms


def read(ctx):
    return stream_ms(ctx, "preprocess.jitter")
