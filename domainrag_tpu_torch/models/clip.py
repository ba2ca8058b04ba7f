"""CLIP: the ViT image tower (stage-2 retrieval embeddings) and the text
tower (Flux's pooled text vector). Port of ``domainrag_tpu/models/clip.py``
(``ClipVisionConfig :27``, ``init_vision``/``_patchify``/``apply_vision``/
``encode_image :85-145``, ``ClipTextConfig :42``,
``init_text``/``apply_text :152-188``, and the transformers converters
``convert_hf_clip_vision``/``convert_hf_clip_text :215-260``).

Both towers are the pre-LN transformer with quick-gelu over the dense
``common.mha`` (the JAX package has no Pallas kernel here). The image
tower embeds patches by a matmul over channel-last flattened patches with
``patch_w`` of shape (P*P*3, hidden), so the weight stays 2-D across the
bridge; ``encode_image`` L2-normalises in f32. The text tower's pooled
output is the final-LN hidden state at the first EOS position
(transformers ``CLIPTextModel.pooler_output``, which Flux consumes
directly).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import device as device_mod
from ..core import prng
from .common import (Params, RenamedKeys, causal_mask, ckpt_linear,
                     ckpt_tensor, layernorm, layernorm_init, linear,
                     linear_init, mha, mha_init, normal_init, quick_gelu)


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    projection_dim: int = 512

    @property
    def seq_len(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


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
TINY_VISION = ClipVisionConfig(image_size=32, patch_size=8, hidden=64,
                               layers=2, heads=4, projection_dim=32)
TINY_TEXT = ClipTextConfig(vocab_size=100, max_len=16, hidden=64, layers=2,
                           heads=4, projection_dim=32, eos_token_id=99)


def _block_init(key, hidden: int, mlp_ratio: int) -> Params:
    k1, k2, k3 = prng.split(key, 3)
    return {
        "ln1": layernorm_init(hidden, device=key.device),
        "attn": mha_init(k1, hidden, bias=True),
        "ln2": layernorm_init(hidden, device=key.device),
        "fc1": linear_init(k2, hidden, hidden * mlp_ratio),
        "fc2": linear_init(k3, hidden * mlp_ratio, hidden),
    }


def _block_apply(p: Params, x: torch.Tensor, heads: int, mask=None
                 ) -> torch.Tensor:
    x = x + mha(p["attn"], layernorm(p["ln1"], x), heads, mask=mask)
    h = linear(p["fc1"], layernorm(p["ln2"], x))
    return x + linear(p["fc2"], quick_gelu(h))


def init_vision(key, cfg: ClipVisionConfig) -> Params:
    ks = prng.split(prng.check_key(key, "init_vision"), cfg.layers + 4)
    scale = cfg.hidden ** -0.5
    return {
        "patch_w": normal_init(ks[0], (cfg.patch_size * cfg.patch_size * 3,
                                       cfg.hidden), scale),
        "class_emb": normal_init(ks[1], (cfg.hidden,), scale),
        "pos_emb": normal_init(ks[2], (cfg.seq_len, cfg.hidden), scale),
        "ln_pre": layernorm_init(cfg.hidden, device=key.device),
        "ln_post": layernorm_init(cfg.hidden, device=key.device),
        "proj": normal_init(ks[3], (cfg.hidden, cfg.projection_dim), scale),
        "blocks": [_block_init(ks[4 + i], cfg.hidden, cfg.mlp_ratio)
                   for i in range(cfg.layers)],
    }


def _patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, N, P*P*3), channel-last within each patch (the
    order of an HWIO conv kernel reshaped to (P*P*I, O))."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)               # B, gh, gw, P, P, C
    return x.reshape(b, gh * gw, patch * patch * c)


def apply_vision(params: Params, images: torch.Tensor,
                 cfg: ClipVisionConfig, project: bool = True
                 ) -> torch.Tensor:
    """images: (B, H, W, 3) preprocessed (``imaging.clip_preprocess``).
    Returns (B, projection_dim) un-normalized embeddings (or the pooled
    (B, hidden) with ``project=False``)."""
    dtype = images.dtype
    x = torch.matmul(_patchify(images, cfg.patch_size),
                     params["patch_w"].to(dtype))
    cls = params["class_emb"].to(dtype).expand(x.shape[0], 1, cfg.hidden)
    x = torch.cat([cls, x], dim=1) + params["pos_emb"].to(dtype)
    x = layernorm(params["ln_pre"], x)
    for block in params["blocks"]:
        x = _block_apply(block, x, cfg.heads)
    pooled = layernorm(params["ln_post"], x[:, 0])
    if not project:
        return pooled
    return torch.matmul(pooled, params["proj"].to(dtype))


def encode_image(params: Params, images: torch.Tensor,
                 cfg: ClipVisionConfig) -> torch.Tensor:
    """L2-normalized retrieval embeddings in f32 (index exactness)."""
    feats = apply_vision(params, images, cfg).float()
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


def init_text(key, cfg: ClipTextConfig) -> Params:
    ks = prng.split(prng.check_key(key, "init_text"), cfg.layers + 3)
    return {
        "tok_emb": normal_init(ks[0], (cfg.vocab_size, cfg.hidden), 0.02),
        "pos_emb": normal_init(ks[1], (cfg.max_len, cfg.hidden), 0.01),
        "ln_final": layernorm_init(cfg.hidden, device=key.device),
        "proj": normal_init(ks[2], (cfg.hidden, cfg.projection_dim),
                            cfg.hidden ** -0.5),
        "blocks": [_block_init(ks[3 + i], cfg.hidden, cfg.mlp_ratio)
                   for i in range(cfg.layers)],
    }


def apply_text(params: Params, token_ids: torch.Tensor, cfg: ClipTextConfig,
               dtype: torch.dtype = torch.float32):
    """token_ids (B, S) -> (hidden_states (B, S, H), pooled (B, H)) in
    ``dtype``."""
    b, s = token_ids.shape
    x = params["tok_emb"].to(dtype)[token_ids.long()]
    x = x + params["pos_emb"].to(dtype)[:s]
    mask = causal_mask(s, device=x.device)
    for block in params["blocks"]:
        x = _block_apply(block, x, cfg.heads, mask=mask)
    x = layernorm(params["ln_final"], x)
    eos_pos = torch.argmax((token_ids == cfg.eos_token_id).to(torch.int32),
                           dim=1)
    pooled = x[torch.arange(b, device=x.device), eos_pos]
    return x, pooled


# ---------------------------------------------------------------------------
# HF weight conversion (transformers state dict -> param tree, f32)
# ---------------------------------------------------------------------------

def _convert_block(sd, prefix: str, dev: torch.device) -> Params:
    def ln(name):
        return {"scale": ckpt_tensor(sd[f"{prefix}.{name}.weight"], dev),
                "bias": ckpt_tensor(sd[f"{prefix}.{name}.bias"], dev)}

    attn = {k: ckpt_linear(sd, f"{prefix}.self_attn.{name}", dev)
            for k, name in (("q", "q_proj"), ("k", "k_proj"),
                            ("v", "v_proj"), ("o", "out_proj"))}
    return {"ln1": ln("layer_norm1"), "attn": attn, "ln2": ln("layer_norm2"),
            "fc1": ckpt_linear(sd, f"{prefix}.mlp.fc1", dev),
            "fc2": ckpt_linear(sd, f"{prefix}.mlp.fc2", dev)}


def _blocks(sd, dev: torch.device) -> list:
    blocks, i = [], 0
    while f"encoder.layers.{i}.layer_norm1.weight" in sd:
        blocks.append(_convert_block(sd, f"encoder.layers.{i}", dev))
        i += 1
    return blocks


def convert_hf_clip_vision(state_dict, cfg: ClipVisionConfig, *,
                           device=None) -> Params:
    """Convert a transformers ``CLIPVisionModelWithProjection`` (or the
    vision half of ``CLIPModel``) state dict; tensors land on ``device``
    (the card unless ``device="cpu"``) in f32."""
    dev = device_mod.resolve(device)
    sd = RenamedKeys(state_dict, "vision_model.")
    conv_w = ckpt_tensor(sd["embeddings.patch_embedding.weight"], dev)
    patch_w = conv_w.permute(2, 3, 1, 0).reshape(-1, conv_w.shape[0])
    return {
        "patch_w": patch_w.contiguous(),
        "class_emb": ckpt_tensor(sd["embeddings.class_embedding"], dev),
        "pos_emb": ckpt_tensor(sd["embeddings.position_embedding.weight"],
                               dev),
        "ln_pre": {"scale": ckpt_tensor(sd["pre_layrnorm.weight"], dev),
                   "bias": ckpt_tensor(sd["pre_layrnorm.bias"], dev)},
        "ln_post": {"scale": ckpt_tensor(sd["post_layernorm.weight"], dev),
                    "bias": ckpt_tensor(sd["post_layernorm.bias"], dev)},
        "proj": ckpt_tensor(sd["visual_projection.weight"], dev).t()
        .contiguous(),
        "blocks": _blocks(sd, dev),
    }


def convert_hf_clip_text(state_dict, cfg: ClipTextConfig, *,
                         device=None) -> Params:
    """Convert a transformers ``CLIPTextModel(WithProjection)`` (or the
    text half of ``CLIPModel``) state dict; without a
    ``text_projection`` the projection is the identity."""
    dev = device_mod.resolve(device)
    sd = RenamedKeys(state_dict, "text_model.")
    params: Params = {
        "tok_emb": ckpt_tensor(sd["embeddings.token_embedding.weight"], dev),
        "pos_emb": ckpt_tensor(sd["embeddings.position_embedding.weight"],
                               dev),
        "ln_final": {"scale": ckpt_tensor(sd["final_layer_norm.weight"],
                                          dev),
                     "bias": ckpt_tensor(sd["final_layer_norm.bias"], dev)},
    }
    if "text_projection.weight" in sd:
        params["proj"] = ckpt_tensor(sd["text_projection.weight"],
                                     dev).t().contiguous()
    else:
        params["proj"] = torch.eye(cfg.hidden, cfg.projection_dim,
                                   device=dev)
    params["blocks"] = _blocks(sd, dev)
    return params
