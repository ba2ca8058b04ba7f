"""Device milliseconds per denoise step of every kernel outside the GEMM
and attention groups: modulation, norms, RoPE tables, GELU, residuals,
casts (and, under W8A8, the activation quant)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t["steps_traced"]:
        return None
    return 1e3 * t["groups"].get("other", 0.0) / t["steps_traced"]
