"""SigLIP vision tower — the FLUX.1-Redux image encoder (port of
``domainrag_tpu/models/siglip.py``).

Patch tokens of SigLIP-so400m/384 (27x27 = 729 tokens, width 1152),
``last_hidden_state`` only (post layernorm, no pooling head), and the
transformers converter ``convert_hf_siglip``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import device as device_mod
from ..core import prng
from .common import (Params, RenamedKeys, ckpt_linear, ckpt_tensor,
                     gelu_tanh, layernorm, layernorm_init, linear,
                     linear_init, mha, mha_init, normal_init)


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    image_size: int = 384
    patch_size: int = 14
    hidden: int = 1152
    layers: int = 27
    heads: int = 16
    mlp_dim: int = 4304
    layer_norm_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid ** 2


SIGLIP_SO400M = SiglipVisionConfig()
TINY_SIGLIP = SiglipVisionConfig(image_size=28, patch_size=7, hidden=48,
                                 layers=2, heads=4, mlp_dim=96)


def init(key, cfg: SiglipVisionConfig = SIGLIP_SO400M) -> Params:
    ks = prng.split(prng.check_key(key, "init"), cfg.layers + 3)
    dev = key.device
    params: Params = {
        "patch_w": normal_init(ks[0], (cfg.patch_size * cfg.patch_size * 3,
                                       cfg.hidden), 0.02),
        "patch_b": torch.zeros((cfg.hidden,), device=dev),
        "pos_emb": normal_init(ks[1], (cfg.seq_len, cfg.hidden), 0.02),
        "post_ln": layernorm_init(cfg.hidden, device=dev),
        "blocks": [],
    }
    for i in range(cfg.layers):
        k1, k2, k3 = prng.split(ks[2 + i], 3)
        params["blocks"].append({
            "ln1": layernorm_init(cfg.hidden, device=dev),
            "attn": mha_init(k1, cfg.hidden, bias=True),
            "ln2": layernorm_init(cfg.hidden, device=dev),
            "fc1": linear_init(k2, cfg.hidden, cfg.mlp_dim),
            "fc2": linear_init(k3, cfg.mlp_dim, cfg.hidden),
        })
    return params


def _patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    # floor like the HF strided conv: 384 px with patch 14 gives 27x27
    # patches and the trailing 384 - 27*14 = 6 pixels are discarded
    x = images[:, :gh * patch, :gw * patch]
    x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def apply(params: Params, images: torch.Tensor,
          cfg: SiglipVisionConfig = SIGLIP_SO400M) -> torch.Tensor:
    """images (B, S, S, 3) siglip-preprocessed -> (B, seq, hidden)."""
    dtype = images.dtype
    x = torch.matmul(_patchify(images, cfg.patch_size),
                     params["patch_w"].to(dtype))
    x = x + params["patch_b"].to(dtype)
    x = x + params["pos_emb"].to(dtype)
    for block in params["blocks"]:
        h = layernorm(block["ln1"], x, cfg.layer_norm_eps)
        x = x + mha(block["attn"], h, cfg.heads)
        h = layernorm(block["ln2"], x, cfg.layer_norm_eps)
        x = x + linear(block["fc2"], gelu_tanh(linear(block["fc1"], h)))
    return layernorm(params["post_ln"], x, cfg.layer_norm_eps)


def convert_hf_siglip(state_dict, cfg: SiglipVisionConfig, *,
                      device=None) -> Params:
    """transformers ``SiglipVisionModel`` state dict -> param tree, f32 on
    ``device`` (the card unless ``device="cpu"``)."""
    dev = device_mod.resolve(device)
    sd = RenamedKeys(state_dict, "vision_model.")

    def ln(key):
        return {"scale": ckpt_tensor(sd[f"{key}.weight"], dev),
                "bias": ckpt_tensor(sd[f"{key}.bias"], dev)}

    conv_w = ckpt_tensor(sd["embeddings.patch_embedding.weight"], dev)
    params: Params = {
        "patch_w": conv_w.permute(2, 3, 1, 0).reshape(-1, conv_w.shape[0])
        .contiguous(),
        "patch_b": ckpt_tensor(sd["embeddings.patch_embedding.bias"], dev),
        "pos_emb": ckpt_tensor(sd["embeddings.position_embedding.weight"],
                               dev),
        "post_ln": ln("post_layernorm"),
        "blocks": [],
    }
    i = 0
    while f"encoder.layers.{i}.layer_norm1.weight" in sd:
        pre = f"encoder.layers.{i}"
        params["blocks"].append({
            "ln1": ln(f"{pre}.layer_norm1"),
            "attn": {k: ckpt_linear(sd, f"{pre}.self_attn.{name}", dev)
                     for k, name in (("q", "q_proj"), ("k", "k_proj"),
                                     ("v", "v_proj"), ("o", "out_proj"))},
            "ln2": ln(f"{pre}.layer_norm2"),
            "fc1": ckpt_linear(sd, f"{pre}.mlp.fc1", dev),
            "fc2": ckpt_linear(sd, f"{pre}.mlp.fc2", dev),
        })
        i += 1
    return params
