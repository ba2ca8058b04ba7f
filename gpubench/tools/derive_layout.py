"""Derive a configuration's published key layout (keys, shapes, dtypes and
the scale of each draw) from the port's inits and export layouts.

Run once when a configuration is added; its output is frozen as data in
``gpubench/configs/<name>.json``, so the benchmark's weights do not move
when the port's own trees change later. Every random draw of the inits
is replaced by a constant tensor expanded to its shape, carrying minus
its standard deviation, so a full-width derivation allocates next to
nothing; constant leaves (norm scales, biases) keep their values.

    python -m gpubench.tools.derive_layout flux-dev > layout.json
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import sys

import torch

# the first dotted part that carries a layer index closes a group
_GROUP = re.compile(r"^(.*?\.\d+)\.")
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


@contextlib.contextmanager
def _marked_draws():
    """Every ``models.common._draw`` returns a zero-stride tensor holding
    -std, in the dtype the init stores."""
    from domainrag_tpu_torch.models import common

    def draw(key, shape, std, dtype, draw_dtype=torch.float32, oihw=False):
        x = torch.full((1,) * len(shape), -float(std), dtype=dtype)
        x = x.expand(shape)
        return x.permute(3, 2, 0, 1) if oihw else x

    real = common._draw
    common._draw = draw
    try:
        yield
    finally:
        common._draw = real


def _lin(sd, prefix, p):
    sd[f"{prefix}.weight"] = p["w"].t()
    if "b" in p:
        sd[f"{prefix}.bias"] = p["b"]


def _ln(sd, prefix, p):
    sd[f"{prefix}.weight"] = p["scale"]
    sd[f"{prefix}.bias"] = p["bias"]


def _layers(sd, prefix, blocks):
    for i, b in enumerate(blocks):
        pre = f"{prefix}.encoder.layers.{i}"
        _ln(sd, f"{pre}.layer_norm1", b["ln1"])
        for k, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                        ("o", "out_proj")):
            _lin(sd, f"{pre}.self_attn.{name}", b["attn"][k])
        _ln(sd, f"{pre}.layer_norm2", b["ln2"])
        _lin(sd, f"{pre}.mlp.fc1", b["fc1"])
        _lin(sd, f"{pre}.mlp.fc2", b["fc2"])


def _patch(patch_w, patch):
    return patch_w.reshape(patch, patch, 3, -1).permute(3, 2, 0, 1)


def hf_t5(p):
    sd = {"shared.weight": p["embed"],
          "encoder.final_layer_norm.weight": p["final_norm"]["scale"]}
    for i, b in enumerate(p["blocks"]):
        pre = f"encoder.block.{i}.layer"
        for k in ("q", "k", "v", "o"):
            sd[f"{pre}.0.SelfAttention.{k}.weight"] = b["attn"][k]["w"].t()
        if "rel_bias" in b["attn"]:
            sd[f"{pre}.0.SelfAttention.relative_attention_bias.weight"] = \
                b["attn"]["rel_bias"]
        sd[f"{pre}.0.layer_norm.weight"] = b["ln_attn"]["scale"]
        sd[f"{pre}.1.layer_norm.weight"] = b["ln_ff"]["scale"]
        for k in ("wi_0", "wi_1", "wo"):
            sd[f"{pre}.1.DenseReluDense.{k}.weight"] = b[k]["w"].t()
    return sd


def hf_clip_text(p):
    sd = {"text_model.embeddings.token_embedding.weight": p["tok_emb"],
          "text_model.embeddings.position_embedding.weight": p["pos_emb"],
          "text_projection.weight": p["proj"].t()}
    _ln(sd, "text_model.final_layer_norm", p["ln_final"])
    _layers(sd, "text_model", p["blocks"])
    return sd


def hf_siglip(p, patch):
    v = "vision_model"
    sd = {f"{v}.embeddings.patch_embedding.weight": _patch(p["patch_w"], patch),
          f"{v}.embeddings.patch_embedding.bias": p["patch_b"],
          f"{v}.embeddings.position_embedding.weight": p["pos_emb"]}
    _ln(sd, f"{v}.post_layernorm", p["post_ln"])
    _layers(sd, v, p["blocks"])
    return sd


def hf_redux(p):
    sd = {}
    _lin(sd, "redux_up", p["up"])
    _lin(sd, "redux_down", p["down"])
    return sd


def port_configs(fill: bool, tiny: bool):
    """The port's configs of one deployment: full width, or the tiny
    bundle's (``pipeline.tiny_configs``)."""
    from domainrag_tpu_torch.models import clip, redux, siglip, t5
    from domainrag_tpu_torch.models.flux import model as fm
    from domainrag_tpu_torch.models.flux import pipeline, vae
    if tiny:
        c = pipeline.tiny_configs(fill)
        return dict(transformer=c["flux_cfg"], vae=c["vae_cfg"],
                    t5=c["t5_cfg"], clip_text=c["clip_text_cfg"],
                    siglip=c["siglip_cfg"], redux=c["redux_cfg"])
    return dict(transformer=fm.FLUX_FILL_DEV if fill else fm.FLUX_DEV,
                vae=vae.FLUX_VAE, t5=t5.T5_XXL,
                clip_text=clip.ClipTextConfig(),
                siglip=siglip.SIGLIP_SO400M, redux=redux.REDUX_DEV)


def published_state(component: str, cfg, dtype: torch.dtype) -> dict:
    """One component's published-layout tensors with marked draws."""
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.models import clip, redux, siglip, t5
    from domainrag_tpu_torch.models.export_diffusers import (
        export_flux_to_diffusers, export_vae_to_diffusers)
    from domainrag_tpu_torch.models.flux import model as fm
    from domainrag_tpu_torch.models.flux import vae
    key = prng.PRNGKey(0, device="cpu")
    with _marked_draws():
        if component == "transformer":
            return export_flux_to_diffusers(fm.init(key, cfg, dtype=dtype),
                                            cfg)
        if component == "vae":
            return export_vae_to_diffusers(vae.init(key, cfg))
        if component == "t5":
            return hf_t5(t5.init(key, cfg))
        if component == "clip_text":
            return hf_clip_text(clip.init_text(key, cfg))
        if component == "siglip":
            return hf_siglip(siglip.init(key, cfg), cfg.patch_size)
        if component == "redux":
            return hf_redux(redux.init(key, cfg))
    raise ValueError(component)


def _entry(key: str, t: torch.Tensor) -> list:
    if all(st == 0 for st, n in zip(t.stride(), t.shape) if n > 1):
        lo = hi = float(t[(0,) * t.dim()])     # an expanded draw
    else:
        lo, hi = float(t.min()), float(t.max())
    if lo != hi:
        raise ValueError(f"{key}: neither a marked draw nor a constant")
    if lo < 0.0:           # a marked draw: the constants are 0 and 1
        return [key, list(t.shape), _DTYPE_NAMES[t.dtype], "normal", -lo]
    return [key, list(t.shape), _DTYPE_NAMES[t.dtype], "const", lo]


def group_of(key: str) -> str:
    m = _GROUP.match(key)
    return m.group(1) if m else "_top"


def layout(component: str, cfg, dtype: torch.dtype) -> dict:
    """{group: [[key, shape, dtype, "normal"|"const", std|value], ...]},
    keys in the export's order within each group."""
    groups: dict = {}
    for key, t in published_state(component, cfg, dtype).items():
        groups.setdefault(group_of(key), []).append(_entry(key, t))
    return groups


# the dtype each component is served in (the port's bundles)
SERVED = {"transformer": torch.bfloat16, "vae": torch.float32,
          "t5": torch.float32, "clip_text": torch.float32,
          "siglip": torch.float32, "redux": torch.float32}


def derive(fill: bool, tiny: bool = False) -> dict:
    cfgs = port_configs(fill, tiny)
    return {name: layout(name, cfgs[name], SERVED[name]) for name in SERVED}


def port_sizes(fill: bool, tiny: bool = False) -> dict:
    """The port's config dataclasses as plain dicts."""
    return {k: dataclasses.asdict(v)
            for k, v in port_configs(fill, tiny).items()}


# the published configs each file restates (diffusers / transformers
# config.json of the checkpoints the layout is named after)
_PUBLISHED_TOWERS = {
    "vae": {"source": "black-forest-labs/FLUX.1-dev vae/config.json",
            "latent_channels": 16, "block_out_channels": [128, 256, 512, 512],
            "layers_per_block": 2, "norm_num_groups": 32,
            "scaling_factor": 0.3611, "shift_factor": 0.1159},
    "t5": {"source": "google/t5-v1_1-xxl encoder (FLUX.1-dev text_encoder_2)",
           "d_model": 4096, "d_kv": 64, "d_ff": 10240, "num_layers": 24,
           "num_heads": 64, "relative_attention_num_buckets": 32,
           "relative_attention_max_distance": 128, "vocab_size": 32128,
           "feed_forward_proj": "gated-gelu", "max_sequence_length": 512},
    "clip_text": {"source": "openai/clip-vit-large-patch14 text tower "
                            "(FLUX.1-dev text_encoder)",
                  "hidden_size": 768, "intermediate_size": 3072,
                  "num_hidden_layers": 12, "num_attention_heads": 12,
                  "max_position_embeddings": 77, "vocab_size": 49408,
                  "hidden_act": "quick_gelu"},
    "siglip": {"source": "google/siglip-so400m-patch14-384 vision tower "
                         "(FLUX.1-Redux-dev image_encoder)",
               "hidden_size": 1152, "intermediate_size": 4304,
               "num_hidden_layers": 27, "num_attention_heads": 16,
               "image_size": 384, "patch_size": 14},
    "redux": {"source": "black-forest-labs/FLUX.1-Redux-dev "
                        "image_embedder/config.json",
              "redux_dim": 1152, "txt_in_features": 4096},
}
_PUBLISHED_MMDIT = {
    "flux-dev": {"source": "black-forest-labs/FLUX.1-dev "
                           "transformer/config.json",
                 "attention_head_dim": 128, "axes_dims_rope": [16, 56, 56],
                 "guidance_embeds": True, "in_channels": 64,
                 "joint_attention_dim": 4096, "num_attention_heads": 24,
                 "num_layers": 19, "num_single_layers": 38, "patch_size": 1,
                 "pooled_projection_dim": 768},
    "flux-fill-dev": {"source": "black-forest-labs/FLUX.1-Fill-dev "
                                "transformer/config.json",
                      "attention_head_dim": 128,
                      "axes_dims_rope": [16, 56, 56], "guidance_embeds": True,
                      "in_channels": 384, "out_channels": 64,
                      "joint_attention_dim": 4096, "num_attention_heads": 24,
                      "num_layers": 19, "num_single_layers": 38,
                      "patch_size": 1, "pooled_projection_dim": 768},
}


def config_file(name: str) -> dict:
    """The whole configuration file of ``name``."""
    fill = name == "flux-fill-dev"
    return {
        "name": name,
        "source": "https://huggingface.co/black-forest-labs/"
                  + ("FLUX.1-Fill-dev" if fill else "FLUX.1-dev"),
        "reduced": [],
        "published": dict(transformer=_PUBLISHED_MMDIT[name],
                          **_PUBLISHED_TOWERS),
        "served_dtype": {k: _DTYPE_NAMES[v] for k, v in SERVED.items()},
        "sizes": port_sizes(fill),
        "t5_max_len": 512,
        "layout": derive(fill),
    }


if __name__ == "__main__":
    for name in sys.argv[1:]:
        with open(f"gpubench/configs/{name}.json", "w") as f:
            json.dump(config_file(name), f, separators=(",", ":"))
            f.write("\n")
