"""Seconds of set-up spent on the weights: drawing the published-layout
tensors from the seed on the card, the program's converters
(``models/convert.py``) and, under W8A8, ``quantize_tree``."""


def read(ctx):
    return ctx.setup.get("weights_s")
