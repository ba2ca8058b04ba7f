"""The int8 fused attention (B7: its ``stats_kernel`` and ``quant_kernel``
prep and ``attn_kernel``) of the denoise steps against its roofline (the
family's ``ctx.i8_attention_s`` per call: QK^T at the int8 peak, P.V at
the peak of the type it runs in; ``ctx.attention_calls`` calls a
forward), in percent."""


def read(ctx):
    t = ctx.trace
    if t is None or not t["groups"].get("b7"):
        return None
    bound = ctx.i8_attention_s * ctx.attention_calls
    return 100.0 * bound * t["steps_traced"] / t["groups"]["b7"]
