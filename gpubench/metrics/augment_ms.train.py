"""Mean device ms of the train policy (the fast fusion policy or
``mae_train_batch``) a step, CUDA events around the harness's call, over
the window's steps (layer: preprocess)."""

from gpubench.readers import mean_of


def read(ctx):
    return mean_of(ctx, "augment_ms")
