"""Mean stream ms of the program's ``preprocess`` span a step (the fast
fusion policy or ``mae_train_batch``), over the device-only segment's steps
(layer: preprocess; ``spans.py``)."""

from gpubench.spans import stream_ms


def read(ctx):
    return stream_ms(ctx, "preprocess")
