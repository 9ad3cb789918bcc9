"""Mean stream ms of the program's ``step.optimizer`` span (the
data-parallel all-reduce where a group is set, then ``optimizer.step()``) a
step, over the device-only segment's steps (layer: model step;
``spans.py``)."""

from gpubench.spans import stream_ms


def read(ctx):
    return stream_ms(ctx, "step.optimizer")
