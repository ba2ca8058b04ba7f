"""CLIP text tower — Flux's pooled text vector (port of the text half of
``domainrag_tpu/models/clip.py``: ``ClipTextConfig :42``,
``init_text``/``apply_text :152-188``).

Pre-LN transformer with quick-gelu and a causal mask; the pooled output
is the final-LN hidden state at the first EOS position (transformers
``CLIPTextModel.pooler_output``, which Flux consumes directly).
"""

from __future__ import annotations

import dataclasses

import torch

from .common import (Init, Params, causal_mask, layernorm, layernorm_init,
                     linear, linear_init, mha, mha_init, quick_gelu)


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    max_len: int = 77
    hidden: int = 768          # CLIP-L text (Flux)
    layers: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    projection_dim: int = 768
    eos_token_id: int = 49407


CLIP_L_TEXT = ClipTextConfig()
TINY_TEXT = ClipTextConfig(vocab_size=100, max_len=16, hidden=64, layers=2,
                           heads=4, projection_dim=32, eos_token_id=99)


def _block_init(ini: Init, hidden: int, mlp_ratio: int) -> Params:
    return {
        "ln1": layernorm_init(ini, hidden),
        "attn": mha_init(ini, hidden, bias=True),
        "ln2": layernorm_init(ini, hidden),
        "fc1": linear_init(ini, hidden, hidden * mlp_ratio),
        "fc2": linear_init(ini, hidden * mlp_ratio, hidden),
    }


def _block_apply(p: Params, x: torch.Tensor, heads: int, mask=None
                 ) -> torch.Tensor:
    x = x + mha(p["attn"], layernorm(p["ln1"], x), heads, mask=mask)
    h = linear(p["fc1"], layernorm(p["ln2"], x))
    return x + linear(p["fc2"], quick_gelu(h))


def init_text(cfg: ClipTextConfig, ini: Init) -> Params:
    return {
        "tok_emb": ini.normal((cfg.vocab_size, cfg.hidden), 0.02),
        "pos_emb": ini.normal((cfg.max_len, cfg.hidden), 0.01),
        "ln_final": layernorm_init(ini, cfg.hidden),
        "proj": ini.normal((cfg.hidden, cfg.projection_dim),
                           cfg.hidden ** -0.5),
        "blocks": [_block_init(ini, cfg.hidden, cfg.mlp_ratio)
                   for _ in range(cfg.layers)],
    }


def apply_text(params: Params, token_ids: torch.Tensor, cfg: ClipTextConfig):
    """token_ids (B, S) -> (hidden_states (B, S, H), pooled (B, H)), f32."""
    b, s = token_ids.shape
    x = params["tok_emb"].float()[token_ids.long()]
    x = x + params["pos_emb"].float()[:s]
    mask = causal_mask(s, device=x.device)
    for block in params["blocks"]:
        x = _block_apply(block, x, cfg.heads, mask=mask)
    x = layernorm(params["ln_final"], x)
    eos_pos = torch.argmax((token_ids == cfg.eos_token_id).to(torch.int32),
                           dim=1)
    pooled = x[torch.arange(b, device=x.device), eos_pos]
    return x, pooled
