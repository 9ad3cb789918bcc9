"""Mean stream ms of the program's ``step.backward`` span (``zero_grad`` and
``loss.backward()``) a step, over the device-only segment's steps (layer:
model step; ``spans.py``)."""

from gpubench.spans import stream_ms


def read(ctx):
    return stream_ms(ctx, "step.backward")
