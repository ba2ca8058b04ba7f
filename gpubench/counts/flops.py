"""Operations and bytes of one Flux MMDiT forward, and the bounds of its
kernels on one H100.

``flux_forward_flops`` is a frozen copy of the port's
``eval/flops.py`` (one multiply-add is 2 FLOPs; attention is
4 * S^2 * hidden per block; norms, nonlinearities and RoPE left out),
taking the configuration file's ``sizes["transformer"]`` dict. The
attention bounds are those the port's smoke script held its kernels to;
the GEMM list prices every linear of a forward at its own shape.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense, without sparsity
PEAK_BF16 = 989e12          # FLOP/s
PEAK_INT8 = 1979e12         # OP/s
PEAK_BYTES = 3.35e12        # HBM3 bytes/s


def flux_forward_flops(cfg: Dict, s_img: int, s_txt: int,
                       batch: int = 1) -> Dict[str, float]:
    """FLOPs of one MMDiT forward by part, and their ``total``."""
    h = cfg["hidden"]
    m = h * cfg["mlp_ratio"]
    s = s_img + s_txt
    stream_params = h * 3 * h + h * h + 2 * h * m
    d_stream = 2 * stream_params * (s_img + s_txt)
    d_attn = 4 * s * s * h
    d_mod = 2 * (2 * h * 6 * h)
    sgl_params = h * (3 * h + m) + (h + m) * h
    s_stream = 2 * sgl_params * s
    s_attn = 4 * s * s * h
    s_mod = 2 * (h * 3 * h)
    emb = 2 * (cfg["in_channels"] * h * s_img
               + cfg["text_dim"] * h * s_txt
               + h * cfg["out_channels"] * s_img
               + (cfg["time_embed_dim"] * h + h * h) * 2
               + cfg["pooled_dim"] * h + h * h
               + h * 2 * h)
    parts = {
        "double_stream": batch * d_stream * cfg["depth_double"],
        "double_attn": batch * d_attn * cfg["depth_double"],
        "double_mod": batch * d_mod * cfg["depth_double"],
        "single_stream": batch * s_stream * cfg["depth_single"],
        "single_attn": batch * s_attn * cfg["depth_single"],
        "single_mod": batch * s_mod * cfg["depth_single"],
        "embedders": batch * emb,
    }
    parts["total"] = sum(parts.values())
    return parts


def forward_gemms(cfg: Dict, s_img: int, s_txt: int,
                  batch: int) -> List[Tuple[int, int, int, int]]:
    """Every linear of one forward as (M, K, N, calls). The conditioning
    vector's linears run one sample at a time (M = 1, ``batch`` calls)."""
    h = cfg["hidden"]
    m = h * cfg["mlp_ratio"]
    s = s_img + s_txt
    td = cfg["time_embed_dim"]
    vec = [(td, h), (h, h), (cfg["pooled_dim"], h), (h, h)]
    if cfg["guidance_embed"]:
        vec += [(td, h), (h, h)]
    g = [(batch * s_img, cfg["in_channels"], h, 1),
         (batch * s_txt, cfg["text_dim"], h, 1),
         (batch * s_img, h, cfg["out_channels"], 1)]
    g += [(1, k, n, batch) for k, n in vec + [(h, 2 * h)]]
    for _ in range(cfg["depth_double"]):
        g += [(1, h, 6 * h, 2 * batch)]
        for rows in (batch * s_img, batch * s_txt):
            g += [(rows, h, 3 * h, 1), (rows, h, h, 1), (rows, h, m, 1),
                  (rows, m, h, 1)]
    for _ in range(cfg["depth_single"]):
        g += [(1, h, 3 * h, batch), (batch * s, h, 3 * h + m, 1),
              (batch * s, h + m, h, 1)]
    return g


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


def attention_bound_s(batch: int, s_tot: int, heads: int = 24,
                      head_dim: int = 128) -> float:
    """The least seconds of one fused bf16 attention call: two S x S x D
    products per head at the bf16 peak, or the bytes (q/k/v lanes read
    once, the output written once, the f32 RoPE tables read once)."""
    hd = heads * head_dim
    ops = 4.0 * batch * heads * s_tot * s_tot * head_dim / PEAK_BF16
    nbytes = (batch * 4 * s_tot * hd * 2 + 2 * s_tot * (head_dim // 2) * 4) \
        / PEAK_BYTES
    return max(ops, nbytes)


def i8_attention_bound_s(batch: int, s_tot: int, pv: bool,
                         heads: int = 24, head_dim: int = 128) -> float:
    """The least seconds of one int8 attention call: QK^T at the int8
    peak, P.V at the int8 (``pv``) or bf16 peak, or the same bytes."""
    hd = heads * head_dim
    half = 2.0 * batch * heads * s_tot * s_tot * head_dim
    ops = half / PEAK_INT8 + half / (PEAK_INT8 if pv else PEAK_BF16)
    nbytes = (batch * 4 * s_tot * hd * 2 + 2 * s_tot * (head_dim // 2) * 4) \
        / PEAK_BYTES
    return max(ops, nbytes)


def attention_calls(cfg: Dict) -> int:
    """Fused attention calls of one forward: one per block."""
    return cfg["depth_double"] + cfg["depth_single"]
