"""The denoise step's share of the card's dense bf16 peak: the MMDiT
forward's exact FLOPs at the cell's batch and token counts (the frozen
``counts.flops``) over the mean synchronised step, in percent."""

from gpubench.counts import flops


def read(ctx):
    spans = [b - a for name, a, b in ctx.spans if name == "step"]
    if not spans:
        return None
    f = flops.flux_forward_flops(ctx.transformer, ctx.s_img, ctx.s_txt,
                                 ctx.batch)["total"]
    return 100.0 * f / (sum(spans) / len(spans)) / flops.PEAK_BF16
