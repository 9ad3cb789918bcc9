"""Mean stream ms of the program's ``step.forward`` span (the model and the
loss) a step, over the device-only segment's steps (layer: model step;
``spans.py``)."""

from gpubench.spans import stream_ms


def read(ctx):
    return stream_ms(ctx, "step.forward")
