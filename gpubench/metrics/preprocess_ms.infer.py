"""Mean stream ms of the program's ``preprocess`` span a batch
(``preprocess_eval_batch`` or ``mae_eval_batch``), over the device-only
segment's batches (layer: preprocess; ``spans.py``)."""

from gpubench.spans import stream_ms


def read(ctx):
    return stream_ms(ctx, "preprocess")
