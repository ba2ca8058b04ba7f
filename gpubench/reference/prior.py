"""The Redux prior in float32: T5-XXL and CLIP-L text encoders (transformers'
``T5EncoderModel``, ``CLIPTextModel``), the SigLIP so400m vision tower
(``SiglipVisionModel``'s last hidden state), diffusers'
``ReduxImageEncoder``, and ``FluxPriorReduxPipeline``'s weighted sum over
the images of a group. Over the published keys; nothing of the program.

The prompt is tokenized by the rule of the program's stub tokenizers
(no tokenizer files ship with generated weights): lowercased words
hashed into the vocabulary, a BOS where the tower has one, an EOS, then
padding with 0. The stage prompts of the benchmark's cells are empty.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from .ops import (attention, conv, gelu_tanh, layer_norm, linear,
                  quick_gelu, rms_norm)


def stub_tokens(text: str, max_len: int, vocab: int, bos: Optional[int],
                eos: int) -> List[int]:
    ids = [] if bos is None else [bos]
    ids += [abs(hash(w)) % (vocab - 3) + 1 for w in text.lower().split()]
    ids = (ids + [eos])[:max_len]
    return ids + [0] * (max_len - len(ids))


def siglip_pixels(path: str, size: int) -> np.ndarray:
    """Bicubic resize to size x size, [0, 1], normalized by mean 0.5 and
    std 0.5 (the SigLIP image processor): HWC float32."""
    img = Image.open(path).convert("RGB").resize((size, size), Image.BICUBIC)
    return (np.asarray(img, np.float32) / 255.0 - 0.5) / 0.5


def _bucket(rel: torch.Tensor, buckets: int, max_distance: int):
    """transformers' bidirectional T5 relative-position bucket."""
    buckets //= 2
    out = (rel > 0).long() * buckets
    rel = rel.abs()
    exact = buckets // 2
    large = exact + (torch.log(rel.float().clamp_min(1) / exact)
                     / math.log(max_distance / exact)
                     * (buckets - exact)).long()
    large = large.clamp(max=buckets - 1)
    return out + torch.where(rel < exact, rel, large)


def t5_encode(w, cfg: dict, ids: torch.Tensor) -> torch.Tensor:
    """(B, S) ids -> (B, S, d_model); no attention mask (FLUX encodes the
    padded prompt unmasked)."""
    top = w.group("_top")
    x = top["shared.weight"].float()[ids]
    s = ids.shape[1]
    pos = torch.arange(s, device=ids.device)
    buckets = _bucket(pos[None, :] - pos[:, None], cfg["rel_buckets"],
                      cfg["rel_max_distance"])
    heads = cfg["heads"]
    bias = None
    for i in range(cfg["layers"]):
        g = w.group(f"encoder.block.{i}")
        pre = f"encoder.block.{i}.layer"
        if bias is None:
            table = g[f"{pre}.0.SelfAttention.relative_attention_bias.weight"]
            bias = table.float()[buckets].permute(2, 0, 1)[None]
        h = rms_norm(x, g[f"{pre}.0.layer_norm.weight"], cfg["layer_norm_eps"])

        def split(name):
            y = linear(g, f"{pre}.0.SelfAttention.{name}", h)
            return y.reshape(y.shape[0], s, heads, -1).transpose(1, 2)

        a = attention(split("q"), split("k"), split("v"), 1.0, bias=bias)
        a = a.transpose(1, 2).reshape(x.shape[0], s, -1)
        x = x + linear(g, f"{pre}.0.SelfAttention.o", a)
        h = rms_norm(x, g[f"{pre}.1.layer_norm.weight"], cfg["layer_norm_eps"])
        ff = f"{pre}.1.DenseReluDense"
        x = x + linear(g, f"{ff}.wo", gelu_tanh(linear(g, f"{ff}.wi_0", h))
                       * linear(g, f"{ff}.wi_1", h))
    top = w.group("_top")
    return rms_norm(x, top["encoder.final_layer_norm.weight"],
                    cfg["layer_norm_eps"])


def _vit_layers(w, prefix: str, layers: int, heads: int, x, eps: float,
                act, mask=None):
    b, s, d = x.shape
    for i in range(layers):
        pre = f"{prefix}.encoder.layers.{i}"
        g = w.group(pre)
        h = layer_norm(x, g[f"{pre}.layer_norm1.weight"],
                       g[f"{pre}.layer_norm1.bias"], eps)

        def split(name):
            return linear(g, f"{pre}.self_attn.{name}", h).reshape(
                b, s, heads, -1).transpose(1, 2)

        a = attention(split("q_proj"), split("k_proj"), split("v_proj"),
                      1.0 / math.sqrt(d // heads), mask=mask)
        x = x + linear(g, f"{pre}.self_attn.out_proj",
                       a.transpose(1, 2).reshape(b, s, d))
        h = layer_norm(x, g[f"{pre}.layer_norm2.weight"],
                       g[f"{pre}.layer_norm2.bias"], eps)
        x = x + linear(g, f"{pre}.mlp.fc2", act(linear(g, f"{pre}.mlp.fc1", h)))
    return x


def clip_pooled(w, cfg: dict, ids: torch.Tensor) -> torch.Tensor:
    """CLIP text tower's pooled output (final norm at the first EOS)."""
    top = w.group("_top")
    s = ids.shape[1]
    x = top["text_model.embeddings.token_embedding.weight"].float()[ids] \
        + top["text_model.embeddings.position_embedding.weight"].float()[:s]
    causal = torch.ones(s, s, dtype=torch.bool, device=ids.device).tril()
    x = _vit_layers(w, "text_model", cfg["layers"], cfg["heads"], x, 1e-5,
                    quick_gelu, mask=causal)
    top = w.group("_top")
    x = layer_norm(x, top["text_model.final_layer_norm.weight"],
                   top["text_model.final_layer_norm.bias"], 1e-5)
    eos = (ids == cfg["eos_token_id"]).int().argmax(dim=1)
    return x[torch.arange(x.shape[0], device=x.device), eos]


def siglip_tokens(w, cfg: dict, pixels: torch.Tensor) -> torch.Tensor:
    """(N, S, S, 3) normalized pixels -> (N, 729, 1152) last hidden state."""
    top = w.group("_top")
    v = "vision_model"
    x = conv(top, f"{v}.embeddings.patch_embedding",
             pixels.permute(0, 3, 1, 2), stride=cfg["patch_size"], padding=0)
    x = x.flatten(2).transpose(1, 2)
    x = x + top[f"{v}.embeddings.position_embedding.weight"].float()[None]
    x = _vit_layers(w, v, cfg["layers"], cfg["heads"], x,
                    cfg["layer_norm_eps"], gelu_tanh)
    top = w.group("_top")
    return layer_norm(x, top[f"{v}.post_layernorm.weight"],
                      top[f"{v}.post_layernorm.bias"], cfg["layer_norm_eps"])


def redux(w, tokens: torch.Tensor) -> torch.Tensor:
    top = w.group("_top")
    return linear(top, "redux_down", F.silu(linear(top, "redux_up", tokens)))


def prompt_embeds(comps: dict, sizes: dict, prompt: str, t5_len: int):
    """(T5 embeds (1, t5_len, 4096), CLIP pooled (1, 768)) of ``prompt``."""
    dev = comps["t5"].device
    t5c, cc = sizes["t5"], sizes["clip_text"]
    t5_ids = torch.tensor([stub_tokens(prompt, t5_len, t5c["vocab_size"],
                                       None, 1)], device=dev)
    v = cc["vocab_size"]
    clip_len = min(77, cc["max_len"])
    clip_ids = torch.tensor([stub_tokens(prompt, clip_len, v, v - 2, v - 1)],
                            device=dev)
    txt = t5_encode(comps["t5"], t5c, t5_ids)
    comps["t5"].release()
    pooled = clip_pooled(comps["clip_text"], cc, clip_ids)
    comps["clip_text"].release()
    return txt, pooled


def prior(comps: dict, sizes: dict, image_paths: Sequence[str],
          pair_idx: np.ndarray, prompt: str, image_scales: Sequence[float],
          text_scales: Sequence[float], t5_len: int):
    """Groups of K images (``pair_idx`` (N, K) into ``image_paths``) ->
    (embeds (N, t5_len + 729, 4096), pooled (N, 768)): per image the prompt's
    T5 embeds joined with its Redux tokens, times its scale, summed over
    the group; the pooled prompt embedding likewise."""
    txt, pooled = prompt_embeds(comps, sizes, prompt, t5_len)
    dev = txt.device
    px = torch.as_tensor(np.stack([siglip_pixels(p, sizes["siglip"]
                                                 ["image_size"])
                                   for p in image_paths]), device=dev)
    img = redux(comps["redux"], siglip_tokens(comps["siglip"],
                                              sizes["siglip"], px))
    comps["siglip"].release()
    idx = torch.as_tensor(np.asarray(pair_idx), device=dev)
    joint = torch.cat([txt.expand(img.shape[0], -1, -1), img], dim=1)
    sc = torch.tensor(image_scales, dtype=torch.float32, device=dev)
    ps = torch.tensor(text_scales, dtype=torch.float32, device=dev)
    embeds = (joint[idx] * sc[None, :, None, None]).sum(1)
    pooled = (pooled[0][None, None] * ps[None, :, None]).expand(
        idx.shape[0], -1, -1).sum(1)
    return embeds, pooled
