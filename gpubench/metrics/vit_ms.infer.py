"""Mean stream ms of the program's ``convmae.vit`` span (the ViT stage of
``ConvMAE.encode``, from the kept tokens' gather through the final norm) a
batch, over the device-only segment's batches (layer: model step;
``spans.py``)."""

from gpubench.spans import stream_ms


def read(ctx):
    return stream_ms(ctx, "convmae.vit")
