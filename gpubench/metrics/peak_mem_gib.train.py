"""``torch.cuda.max_memory_allocated()`` over the run before the
reference, in GiB (layer: device)."""

from gpubench.readers import peak_gib


def read(ctx):
    return peak_gib(ctx)
