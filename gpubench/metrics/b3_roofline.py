"""The multi-pass fused attention (B3) of the denoise steps against its
roofline (``counts.flops.attention_bound_s`` per call, one call per
block), in percent; its prep counts with the one-pass group."""

from gpubench.counts import flops


def read(ctx):
    t = ctx.trace
    if t is None or not t["groups"].get("b3"):
        return None
    bound = flops.attention_bound_s(ctx.batch, ctx.s_img + ctx.s_txt) \
        * flops.attention_calls(ctx.transformer)
    return 100.0 * bound * t["steps_traced"] / t["groups"]["b3"]
