"""Library GEMMs of the denoise steps against their roofline: the least
time of every linear of a forward at its own shape (bf16 operands, the
family's ``ctx.gemms``) times the traced steps, over the device time of
the GEMM kernels inside those steps, in percent."""

from gpubench.counts import flops


def read(ctx):
    t = ctx.trace
    if t is None or not t["groups"].get("gemm"):
        return None
    bound = flops.gemm_bound_s(ctx.gemms)
    return 100.0 * bound * t["steps_traced"] / t["groups"]["gemm"]
