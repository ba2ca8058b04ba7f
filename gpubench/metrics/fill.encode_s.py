"""Seconds per Fill call of the VAE encodes: the ``encode`` spans
(synchronised; the masked image's and the image's, tiled at 2048 px)
over the number of ``fill/inputs`` spans. None where the program opens
no ``fill/inputs`` span."""


def read(ctx):
    calls = sum(name == "fill/inputs" for name, a, b in ctx.spans)
    if not calls:
        return None
    return sum(b - a for name, a, b in ctx.spans
               if name == "encode") / calls
