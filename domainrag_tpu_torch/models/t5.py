"""T5 v1.1 encoder — Flux's T5-XXL text encoder (port of
``domainrag_tpu/models/t5.py:41-180``, with the transformers converter
``convert_hf_t5``).

RMSNorm (no mean subtraction), relative position bias computed from
block 0's table and shared by all layers, UNSCALED attention logits (T5
bakes the 1/sqrt(d) into init), gated-gelu MLP, final RMSNorm. Runs in
``dtype`` (f32 by default, the dtype the JAX package's ``encode_prompt``
runs it in).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..core import device as device_mod
from ..core import prng
from .common import (Params, RenamedKeys, ckpt_linear, ckpt_tensor, linear,
                     linear_init, normal_init, rmsnorm, rmsnorm_init)


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    layers: int = 24
    heads: int = 64
    rel_buckets: int = 32
    rel_max_distance: int = 128
    layer_norm_eps: float = 1e-6


T5_XXL = T5Config()
TINY_T5 = T5Config(vocab_size=120, d_model=32, d_kv=8, d_ff=64, layers=2,
                   heads=4)


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional bucketing (transformers
    ``T5Attention._relative_position_bucket``)."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int64) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).to(torch.int64)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def _attn_init(key, cfg: T5Config, with_rel_bias: bool) -> Params:
    ks = prng.split(key, 5)
    inner = cfg.heads * cfg.d_kv
    p = {
        "q": linear_init(ks[0], cfg.d_model, inner, bias=False),
        "k": linear_init(ks[1], cfg.d_model, inner, bias=False),
        "v": linear_init(ks[2], cfg.d_model, inner, bias=False),
        "o": linear_init(ks[3], inner, cfg.d_model, bias=False),
    }
    if with_rel_bias:
        p["rel_bias"] = normal_init(ks[4], (cfg.rel_buckets, cfg.heads),
                                    0.02)
    return p


def init(key, cfg: T5Config = T5_XXL) -> Params:
    """JAX's tree: ``split(key, 3 * layers + 2)``, the embedding on key 0,
    each block's attention, ``wi_0`` and (split in two) ``wi_1`` / ``wo``
    on the next three; the relative bias on block 0 only."""
    ks = prng.split(prng.check_key(key, "init"), cfg.layers * 3 + 2)
    dev = key.device
    params: Params = {"embed": normal_init(ks[0], (cfg.vocab_size,
                                                   cfg.d_model), 1.0),
                      "final_norm": rmsnorm_init(cfg.d_model, device=dev),
                      "blocks": []}
    for i in range(cfg.layers):
        k_attn, k_ff0, k_ff1 = ks[1 + 3 * i:4 + 3 * i]
        kf = prng.split(k_ff1, 2)
        params["blocks"].append({
            "ln_attn": rmsnorm_init(cfg.d_model, device=dev),
            "attn": _attn_init(k_attn, cfg, with_rel_bias=(i == 0)),
            "ln_ff": rmsnorm_init(cfg.d_model, device=dev),
            "wi_0": linear_init(k_ff0, cfg.d_model, cfg.d_ff, bias=False),
            "wi_1": linear_init(kf[0], cfg.d_model, cfg.d_ff, bias=False),
            "wo": linear_init(kf[1], cfg.d_ff, cfg.d_model, bias=False),
        })
    return params


def _self_attention(p: Params, x: torch.Tensor, bias: torch.Tensor,
                    mask: Optional[torch.Tensor], cfg: T5Config
                    ) -> torch.Tensor:
    b, s, _ = x.shape

    def heads(t):
        return t.reshape(b, s, cfg.heads, cfg.d_kv).transpose(1, 2)

    q = heads(linear(p["q"], x))
    k = heads(linear(p["k"], x))
    v = heads(linear(p["v"], x))
    # NO 1/sqrt(d) scaling (T5 convention)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
    if mask is not None:
        # masked keys take -1e9 before the f32 softmax (JAX t5.py:107)
        logits = logits.masked_fill(~mask.bool()[:, None, None, :], -1e9)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v)
    out = out.transpose(1, 2).reshape(b, s, cfg.heads * cfg.d_kv)
    return linear(p["o"], out)


def apply(params: Params, token_ids: torch.Tensor, cfg: T5Config = T5_XXL,
          attention_mask: Optional[torch.Tensor] = None,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """token_ids (B, S) -> encoder hidden states (B, S, d_model) in
    ``dtype``; keys where ``attention_mask`` (B, S) is 0 are not
    attended."""
    s = token_ids.shape[1]
    x = params["embed"].to(dtype)[token_ids.long()]
    pos = torch.arange(s, device=token_ids.device)
    rel = pos[None, :] - pos[:, None]                    # key - query
    buckets = relative_position_bucket(rel, cfg.rel_buckets,
                                       cfg.rel_max_distance)
    table = params["blocks"][0]["attn"]["rel_bias"].float()
    bias = table[buckets].permute(2, 0, 1)[None]         # (1, H, S, S)
    for block in params["blocks"]:
        h = rmsnorm(block["ln_attn"], x, cfg.layer_norm_eps)
        x = x + _self_attention(block["attn"], h, bias, attention_mask, cfg)
        h = rmsnorm(block["ln_ff"], x, cfg.layer_norm_eps)
        gated = torch.nn.functional.gelu(linear(block["wi_0"], h),
                                         approximate="tanh") \
            * linear(block["wi_1"], h)
        x = x + linear(block["wo"], gated)
    return rmsnorm(params["final_norm"], x, cfg.layer_norm_eps)


def convert_hf_t5(state_dict, cfg: T5Config, *, device=None) -> Params:
    """transformers ``T5EncoderModel`` state dict -> param tree, f32 on
    ``device`` (the card unless ``device="cpu"``); a bf16 checkpoint
    crosses at bf16 and widens on the device, exactly."""
    dev = device_mod.resolve(device)
    sd = RenamedKeys(state_dict, "encoder.")

    def scale(key):
        return {"scale": ckpt_tensor(sd[key], dev)}

    params: Params = {
        "embed": ckpt_tensor(state_dict["shared.weight"], dev),
        "final_norm": scale("final_layer_norm.weight"),
        "blocks": [],
    }
    i = 0
    while f"block.{i}.layer.0.SelfAttention.q.weight" in sd:
        pre = f"block.{i}"
        attn = {k: ckpt_linear(sd, f"{pre}.layer.0.SelfAttention.{k}", dev)
                for k in ("q", "k", "v", "o")}
        rb = f"{pre}.layer.0.SelfAttention.relative_attention_bias.weight"
        if rb in sd:
            attn["rel_bias"] = ckpt_tensor(sd[rb], dev)
        ff = f"{pre}.layer.1.DenseReluDense"
        params["blocks"].append({
            "ln_attn": scale(f"{pre}.layer.0.layer_norm.weight"),
            "attn": attn,
            "ln_ff": scale(f"{pre}.layer.1.layer_norm.weight"),
            "wi_0": ckpt_linear(sd, f"{ff}.wi_0", dev),
            "wi_1": ckpt_linear(sd, f"{ff}.wi_1", dev),
            "wo": ckpt_linear(sd, f"{ff}.wo", dev),
        })
        i += 1
    return params
