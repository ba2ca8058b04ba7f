"""The int8 GEMMs (B4: ``w8a8_wgmma_kernel``, ``w8a8_gemv_kernel``,
``w8a8_mma_kernel``) of the denoise steps against their roofline: the
least time of every linear of a forward at its own shape (the family's
``ctx.gemms``) with int8 operands at the int8 peak, the output in bf16,
times the traced steps, over the device time of the B4 kernels inside
those steps, in percent. The activations' per-token quantization runs in
torch ops and counts as elementwise."""

from gpubench.counts import flops


def read(ctx):
    t = ctx.trace
    if t is None or not t["groups"].get("b4"):
        return None
    bound = flops.gemm_bound_s(ctx.gemms, flops.PEAK_INT8, in_bytes=1)
    return 100.0 * bound * t["steps_traced"] / t["groups"]["b4"]
