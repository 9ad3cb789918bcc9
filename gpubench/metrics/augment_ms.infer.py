"""Mean device ms of the preprocess call (``preprocess_eval_batch`` or
``mae_eval_batch``) a batch, CUDA events around the harness's call, over
the window's batches (layer: preprocess)."""

from gpubench.readers import mean_of


def read(ctx):
    return mean_of(ctx, "augment_ms")
