"""The least seconds of the kernels' work on one H100: GEMMs from a list
of shapes, and one fused attention call of given heads and head width.
The attention bounds are those the port's smoke script held its kernels
to. A family's forward FLOPs and GEMM list are its adapter's
(``families/<family>.py`` ``counts``).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, without sparsity
PEAK_BF16 = 989e12          # FLOP/s
PEAK_INT8 = 1979e12         # OP/s
PEAK_BYTES = 3.35e12        # HBM3 bytes/s


def gemm_bound_s(gemms, peak: float = PEAK_BF16, in_bytes: int = 2,
                 out_bytes: int = 2) -> float:
    """The least seconds of the GEMMs: each the larger of its operations
    at ``peak`` and its bytes (both operands read once, the output
    written once) at the memory rate."""
    total = 0.0
    for m, k, n, calls in gemms:
        ops = 2.0 * m * k * n / peak
        nbytes = ((m * k + k * n) * in_bytes + m * n * out_bytes) / PEAK_BYTES
        total += calls * max(ops, nbytes)
    return total


def attention_bound_s(batch: int, s_tot: int, heads: int,
                      head_dim: int) -> float:
    """The least seconds of one fused bf16 attention call: two S x S x D
    products per head at the bf16 peak, or the bytes (q/k/v lanes read
    once, the output written once, the f32 RoPE tables read once)."""
    hd = heads * head_dim
    ops = 4.0 * batch * heads * s_tot * s_tot * head_dim / PEAK_BF16
    nbytes = (batch * 4 * s_tot * hd * 2 + 2 * s_tot * (head_dim // 2) * 4) \
        / PEAK_BYTES
    return max(ops, nbytes)


def i8_attention_bound_s(batch: int, s_tot: int, pv: bool,
                         heads: int, head_dim: int) -> float:
    """The least seconds of one int8 attention call: QK^T at the int8
    peak, P.V at the int8 (``pv``) or bf16 peak, or the same bytes."""
    hd = heads * head_dim
    half = 2.0 * batch * heads * s_tot * s_tot * head_dim
    ops = half / PEAK_INT8 + half / (PEAK_INT8 if pv else PEAK_BF16)
    nbytes = (batch * 4 * s_tot * hd * 2 + 2 * s_tot * (head_dim // 2) * 4) \
        / PEAK_BYTES
    return max(ops, nbytes)
