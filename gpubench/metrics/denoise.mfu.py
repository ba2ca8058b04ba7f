"""The denoise step's share of the card's dense bf16 peak: the forward's
exact FLOPs at the cell's batch and token counts (the family's frozen
``counts``, ``ctx.forward_flops``) over the mean synchronised step, in
percent."""

from gpubench.counts import flops


def read(ctx):
    spans = [b - a for name, a, b in ctx.spans if name == "step"]
    if not spans:
        return None
    return 100.0 * ctx.forward_flops / (sum(spans) / len(spans)) \
        / flops.PEAK_BF16
