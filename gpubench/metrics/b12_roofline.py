"""The one-pass fused attention (B1/B2, with its norm/RoPE prep) of the
denoise steps against its roofline (the family's ``ctx.attention_s`` per
call, ``ctx.attention_calls`` calls a forward), in percent."""


def read(ctx):
    t = ctx.trace
    if t is None or not t["groups"].get("b12"):
        return None
    bound = ctx.attention_s * ctx.attention_calls
    return 100.0 * bound * t["steps_traced"] / t["groups"]["b12"]
