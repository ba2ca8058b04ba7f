"""Exact FLOP count of one Flux MMDiT forward and the model FLOP
utilization (own copy of ``domainrag_tpu/eval/flops.py``, on the port's
``FluxConfig``).

The double blocks' text stream sees only the text tokens, and every
block's modulation producer sees one "token" per sample, so pricing all
parameters at the joint length overcounts. Conventions: one multiply-add
is 2 FLOPs; attention is 4 * S^2 * hidden per block (QK^T and PV); norms,
nonlinearities and RoPE are left out (well under 1%).
"""

from __future__ import annotations

import dataclasses

from ..models.flux.model import FluxConfig


@dataclasses.dataclass(frozen=True)
class FlopBreakdown:
    double_stream: float     # img + txt stream GEMMs in double blocks
    double_attn: float
    double_mod: float        # modulation producers (1 token per sample)
    single_stream: float
    single_attn: float
    single_mod: float
    embedders: float         # io projections + time/vector/guidance MLPs

    @property
    def total(self) -> float:
        return (self.double_stream + self.double_attn + self.double_mod
                + self.single_stream + self.single_attn + self.single_mod
                + self.embedders)


def flux_forward_flops(cfg: FluxConfig, s_img: int, s_txt: int,
                       batch: int = 1) -> FlopBreakdown:
    """FLOPs of one MMDiT forward (one denoise step) at the given token
    counts (1024 px with the Redux prior: s_img 4096, s_txt 1241)."""
    h, m = cfg.hidden, cfg.mlp_hidden
    s = s_img + s_txt

    # double block, per stream (img at s_img tokens, txt at s_txt):
    # qkv h->3h, proj h->h, mlp h->m->h
    stream_params = h * 3 * h + h * h + 2 * h * m
    d_stream = 2 * stream_params * (s_img + s_txt)        # both streams
    d_attn = 4 * s * s * h
    # modulation: vec h -> 6h per stream, 1 token
    d_mod = 2 * (2 * h * 6 * h)

    # single block: linear1 h->(3h+m), linear2 (h+m)->h on all s tokens
    sgl_params = h * (3 * h + m) + (h + m) * h
    s_stream = 2 * sgl_params * s
    s_attn = 4 * s * s * h
    s_mod = 2 * (h * 3 * h)                               # vec h -> 3h

    # embedders/final: img_in, txt_in, final_proj at token counts;
    # time/vector/guidance MLPs + final_mod at 1 token
    emb = 2 * (cfg.in_channels * h * s_img
               + cfg.text_dim * h * s_txt
               + h * cfg.out_channels * s_img
               + (cfg.time_embed_dim * h + h * h) * 2      # time + guidance
               + cfg.pooled_dim * h + h * h                # vector_in
               + h * 2 * h)                                # final_mod

    return FlopBreakdown(
        double_stream=batch * d_stream * cfg.depth_double,
        double_attn=batch * d_attn * cfg.depth_double,
        double_mod=batch * d_mod * cfg.depth_double,
        single_stream=batch * s_stream * cfg.depth_single,
        single_attn=batch * s_attn * cfg.depth_single,
        single_mod=batch * s_mod * cfg.depth_single,
        embedders=batch * emb,
    )


# dense bf16 peak TFLOP/s per device, for MFU: the JAX package's entries
# and the port's card (H100 SXM, dense bf16 without sparsity)
PEAK_TFLOPS = {"tpu-v5e": 197.0, "tpu-v5p": 459.0, "a100": 312.0,
               "h100-sxm": 989.0}


def mfu(step_flops: float, step_seconds: float,
        peak_tflops: float = PEAK_TFLOPS["h100-sxm"]) -> float:
    """Model FLOP utilization of one denoise step."""
    return step_flops / step_seconds / (peak_tflops * 1e12)
