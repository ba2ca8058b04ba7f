"""Export the port's Flux param trees to the diffusers state-dict layout
(port of ``domainrag_tpu/models/export_diffusers.py``).

Exact inverses of ``convert.convert_flux_transformer`` /
``convert.convert_flux_vae``: the returned dicts hold the same tensors
the converters read, on the tree's device. Where a diffusers tensor is a
slice or transpose of a tree tensor it is returned as a view (no copy);
``.contiguous()`` it before writing it out. Two uses: shipping weights
to diffusers users, and writing checkpoint trees of random weights (the
smoke run writes full-width ones this way).
"""

from __future__ import annotations

import torch


def _lin_t(sd, prefix, p):
    sd[f"{prefix}.weight"] = p["w"].t()
    if "b" in p:
        sd[f"{prefix}.bias"] = p["b"]


def _split_lin(sd, prefixes, p, sizes):
    off = 0
    for prefix, size in zip(prefixes, sizes):
        sd[f"{prefix}.weight"] = p["w"][:, off:off + size].t()
        if "b" in p:
            sd[f"{prefix}.bias"] = p["b"][off:off + size]
        off += size


def export_flux_to_diffusers(params, cfg) -> dict:
    """MMDiT param tree -> diffusers ``FluxTransformer2DModel`` keys."""
    sd = {}
    _lin_t(sd, "x_embedder", params["img_in"])
    _lin_t(sd, "context_embedder", params["txt_in"])
    for name, ours in [("timestep_embedder", "time_in"),
                       ("text_embedder", "vector_in"),
                       ("guidance_embedder", "guidance_in")]:
        if ours in params:
            _lin_t(sd, f"time_text_embed.{name}.linear_1",
                   params[ours]["in"])
            _lin_t(sd, f"time_text_embed.{name}.linear_2",
                   params[ours]["out"])
    h = cfg.hidden
    for i, blk in enumerate(params["double"]):
        pre = f"transformer_blocks.{i}"
        _lin_t(sd, f"{pre}.norm1.linear", blk["img_mod"])
        _lin_t(sd, f"{pre}.norm1_context.linear", blk["txt_mod"])
        _split_lin(sd, [f"{pre}.attn.to_q", f"{pre}.attn.to_k",
                        f"{pre}.attn.to_v"], blk["img_qkv"], [h, h, h])
        _split_lin(sd, [f"{pre}.attn.add_q_proj", f"{pre}.attn.add_k_proj",
                        f"{pre}.attn.add_v_proj"], blk["txt_qkv"],
                   [h, h, h])
        sd[f"{pre}.attn.norm_q.weight"] = blk["img_qknorm"]["q"]["scale"]
        sd[f"{pre}.attn.norm_k.weight"] = blk["img_qknorm"]["k"]["scale"]
        sd[f"{pre}.attn.norm_added_q.weight"] = \
            blk["txt_qknorm"]["q"]["scale"]
        sd[f"{pre}.attn.norm_added_k.weight"] = \
            blk["txt_qknorm"]["k"]["scale"]
        _lin_t(sd, f"{pre}.attn.to_out.0", blk["img_proj"])
        _lin_t(sd, f"{pre}.attn.to_add_out", blk["txt_proj"])
        _lin_t(sd, f"{pre}.ff.net.0.proj", blk["img_mlp1"])
        _lin_t(sd, f"{pre}.ff.net.2", blk["img_mlp2"])
        _lin_t(sd, f"{pre}.ff_context.net.0.proj", blk["txt_mlp1"])
        _lin_t(sd, f"{pre}.ff_context.net.2", blk["txt_mlp2"])
    mh = cfg.mlp_hidden
    for i, blk in enumerate(params["single"]):
        pre = f"single_transformer_blocks.{i}"
        _lin_t(sd, f"{pre}.norm.linear", blk["mod"])
        _split_lin(sd, [f"{pre}.attn.to_q", f"{pre}.attn.to_k",
                        f"{pre}.attn.to_v", f"{pre}.proj_mlp"],
                   blk["linear1"], [h, h, h, mh])
        sd[f"{pre}.attn.norm_q.weight"] = blk["qknorm"]["q"]["scale"]
        sd[f"{pre}.attn.norm_k.weight"] = blk["qknorm"]["k"]["scale"]
        _lin_t(sd, f"{pre}.proj_out", blk["linear2"])
    # the tree's final_mod is (shift, scale); diffusers stores (scale, shift)
    w, b = params["final_mod"]["w"], params["final_mod"]["b"]
    half = w.shape[1] // 2
    sd["norm_out.linear.weight"] = torch.cat(
        [w[:, half:], w[:, :half]], dim=1).t()
    sd["norm_out.linear.bias"] = torch.cat([b[half:], b[:half]])
    _lin_t(sd, "proj_out", params["final_proj"])
    return sd


def export_vae_to_diffusers(params) -> dict:
    """VAE param tree -> diffusers ``AutoencoderKL`` keys (convolutions
    are (out, in, kh, kw) on both sides)."""
    sd = {}

    def conv(prefix, p):
        sd[f"{prefix}.weight"] = p["w"]
        if "b" in p:
            sd[f"{prefix}.bias"] = p["b"]

    def gn(prefix, p):
        sd[f"{prefix}.weight"] = p["scale"]
        sd[f"{prefix}.bias"] = p["bias"]

    def resnet(prefix, p):
        gn(f"{prefix}.norm1", p["norm1"])
        conv(f"{prefix}.conv1", p["conv1"])
        gn(f"{prefix}.norm2", p["norm2"])
        conv(f"{prefix}.conv2", p["conv2"])
        if "shortcut" in p:
            conv(f"{prefix}.conv_shortcut", p["shortcut"])

    def attn(prefix, p):
        gn(f"{prefix}.group_norm", p["norm"])
        for name, key in [("to_q", "q"), ("to_k", "k"), ("to_v", "v"),
                          ("to_out.0", "o")]:
            # 1x1 conv (out, in, 1, 1) -> linear (out, in)
            sd[f"{prefix}.{name}.weight"] = p[key]["w"][:, :, 0, 0]
            if "b" in p[key]:
                sd[f"{prefix}.{name}.bias"] = p[key]["b"]

    enc = params["encoder"]
    conv("encoder.conv_in", enc["conv_in"])
    for i, stage in enumerate(enc["down"]):
        for j, res in enumerate(stage["res"]):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", res)
        if "down" in stage:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv",
                 stage["down"])
    resnet("encoder.mid_block.resnets.0", enc["mid"]["res1"])
    attn("encoder.mid_block.attentions.0", enc["mid"]["attn"])
    resnet("encoder.mid_block.resnets.1", enc["mid"]["res2"])
    gn("encoder.conv_norm_out", enc["norm_out"])
    conv("encoder.conv_out", enc["conv_out"])

    dec = params["decoder"]
    conv("decoder.conv_in", dec["conv_in"])
    resnet("decoder.mid_block.resnets.0", dec["mid"]["res1"])
    attn("decoder.mid_block.attentions.0", dec["mid"]["attn"])
    resnet("decoder.mid_block.resnets.1", dec["mid"]["res2"])
    for i, stage in enumerate(dec["up"]):
        for j, res in enumerate(stage["res"]):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", res)
        if "up" in stage:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", stage["up"])
    gn("decoder.conv_norm_out", dec["norm_out"])
    conv("decoder.conv_out", dec["conv_out"])
    return sd
