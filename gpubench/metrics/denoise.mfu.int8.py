"""The int8 denoise step's share of the card's peaks: the least seconds of
the forward's products at the peaks of the types the int8 path runs them
in (the family's ``ctx.i8_forward_s``: the linears and QK^T at the int8
peak, P.V at the int8 or bf16 peak) over the mean synchronised step, in
percent."""


def read(ctx):
    spans = [b - a for name, a, b in ctx.spans if name == "step"]
    if not spans:
        return None
    return 100.0 * ctx.i8_forward_s / (sum(spans) / len(spans))
