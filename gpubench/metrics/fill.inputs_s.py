"""Seconds per Fill call of the ``fill/inputs`` span (synchronised): the
uint8 images and masks turned to the compute dtype and copied to the
card, the noise drawn and the prior cast, before the VAE encodes."""


def read(ctx):
    spans = [b - a for name, a, b in ctx.spans if name == "fill/inputs"]
    return sum(spans) / len(spans) if spans else None
