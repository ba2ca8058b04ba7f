"""FLUX.1 MMDiT forward in float32, as diffusers' ``FluxTransformer2DModel``
computes it, over the published keys.

``weights`` is a published-layout component (``gpubench.weights``); each
block's bfloat16 tensors are drawn again and upcast one block at a time,
so the 12B model never sits in float32 beside its activations.
Departures from diffusers: none in the arithmetic; attention runs a row
and a few heads at a time to bound the scores.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .ops import attention, gelu_tanh, layer_norm, linear, rms_norm


def timestep_proj(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers ``Timesteps(dim, flip_sin_to_cos=True, shift 0)`` of
    t * 1000 (sigma to the trained timestep)."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half
    args = (t.float() * 1000.0)[:, None] * torch.exp(exponent)[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _mlp(w, prefix, x):
    return linear(w, f"{prefix}.linear_2", F.silu(linear(w, f"{prefix}.linear_1", x)))


def rope_tables(ids: torch.Tensor, axes_dim, theta: int = 10000):
    """(S, 3) ids -> cos, sin (S, D/2): per axis 1/theta^(2i/d)."""
    cos, sin = [], []
    for axis, d in enumerate(axes_dim):
        omega = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                             device=ids.device) / d)
        ang = ids[:, axis].double()[:, None] * omega[None]
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
    return torch.cat(cos, -1).float(), torch.cat(sin, -1).float()


def apply_rope(x, cos, sin):
    """Rotate each pair (x[2i], x[2i+1]) by its angle; x (B, H, S, D)."""
    xr = x.float().reshape(x.shape[:-1] + (-1, 2))
    a, b = xr[..., 0], xr[..., 1]
    return torch.stack([a * cos - b * sin, a * sin + b * cos],
                       dim=-1).reshape(x.shape)


def image_ids(grid_h: int, grid_w: int, device) -> torch.Tensor:
    ids = torch.zeros(grid_h, grid_w, 3, device=device)
    ids[..., 1] = torch.arange(grid_h, device=device)[:, None]
    ids[..., 2] = torch.arange(grid_w, device=device)[None, :]
    return ids.reshape(-1, 3)


def _heads(x, heads):
    b, s, _ = x.shape
    return x.reshape(b, s, heads, -1).transpose(1, 2)


def _joint_attention(w, pre, streams, cos, sin, heads, head_dim):
    """streams: [(prefix names of q/k/v/norms, x)] joined in order."""
    qs, ks, vs = [], [], []
    for (nq, nk, nv, norm_q, norm_k), x in streams:
        q = _heads(linear(w, f"{pre}.attn.{nq}", x), heads)
        k = _heads(linear(w, f"{pre}.attn.{nk}", x), heads)
        qs.append(rms_norm(q, w[f"{pre}.attn.{norm_q}.weight"]))
        ks.append(rms_norm(k, w[f"{pre}.attn.{norm_k}.weight"]))
        vs.append(_heads(linear(w, f"{pre}.attn.{nv}", x), heads))
    q = apply_rope(torch.cat(qs, 2), cos, sin)
    k = apply_rope(torch.cat(ks, 2), cos, sin)
    out = attention(q, k, torch.cat(vs, 2), 1.0 / math.sqrt(head_dim))
    b, _, s, _ = out.shape
    return out.transpose(1, 2).reshape(b, s, heads * head_dim)


def _modulate(x, shift, scale):
    return layer_norm(x) * (1.0 + scale[:, None]) + shift[:, None]


def _double(w, pre, img, txt, vec, cos, sin, heads, hd):
    act = F.silu(vec)
    (sh1, sc1, g1, sh2, sc2, g2) = linear(
        w, f"{pre}.norm1.linear", act).chunk(6, dim=-1)
    (tsh1, tsc1, tg1, tsh2, tsc2, tg2) = linear(
        w, f"{pre}.norm1_context.linear", act).chunk(6, dim=-1)
    joint = _joint_attention(
        w, pre,
        [(("add_q_proj", "add_k_proj", "add_v_proj", "norm_added_q",
           "norm_added_k"), _modulate(txt, tsh1, tsc1)),
         (("to_q", "to_k", "to_v", "norm_q", "norm_k"),
          _modulate(img, sh1, sc1))], cos, sin, heads, hd)
    s_txt = txt.shape[1]
    txt_attn, img_attn = joint[:, :s_txt], joint[:, s_txt:]
    img = img + g1[:, None] * linear(w, f"{pre}.attn.to_out.0", img_attn)
    txt = txt + tg1[:, None] * linear(w, f"{pre}.attn.to_add_out", txt_attn)
    h = gelu_tanh(linear(w, f"{pre}.ff.net.0.proj", _modulate(img, sh2, sc2)))
    img = img + g2[:, None] * linear(w, f"{pre}.ff.net.2", h)
    h = gelu_tanh(linear(w, f"{pre}.ff_context.net.0.proj",
                         _modulate(txt, tsh2, tsc2)))
    txt = txt + tg2[:, None] * linear(w, f"{pre}.ff_context.net.2", h)
    return img, txt


def _single(w, pre, x, vec, cos, sin, heads, hd):
    shift, scale, gate = linear(w, f"{pre}.norm.linear",
                                F.silu(vec)).chunk(3, dim=-1)
    nx = _modulate(x, shift, scale)
    mlp = gelu_tanh(linear(w, f"{pre}.proj_mlp", nx))
    attn = _joint_attention(w, pre, [(("to_q", "to_k", "to_v", "norm_q",
                                       "norm_k"), nx)], cos, sin, heads, hd)
    return x + gate[:, None] * linear(w, f"{pre}.proj_out",
                                      torch.cat([attn, mlp], dim=-1))


def embed(weights, cfg: dict, hidden, context, pooled, timestep, guidance):
    """The input projections and the conditioning vector -> (img, txt,
    vec), f32."""
    td = cfg["time_embed_dim"]
    top = weights.group("_top")
    img = linear(top, "x_embedder", hidden.float())
    txt = linear(top, "context_embedder", context.float())
    vec = _mlp(top, "time_text_embed.timestep_embedder",
               timestep_proj(timestep, td))
    if cfg["guidance_embed"]:
        vec = vec + _mlp(top, "time_text_embed.guidance_embedder",
                         timestep_proj(guidance, td))
    vec = vec + _mlp(top, "time_text_embed.text_embedder", pooled.float())
    return img, txt, vec


def rope(cfg: dict, s_txt: int, grid_h: int, grid_w: int, device):
    """cos, sin of the joint [text; image] sequence."""
    ids = torch.cat([torch.zeros(s_txt, 3, device=device),
                     image_ids(grid_h, grid_w, device)])
    return rope_tables(ids, cfg["axes_dim"], cfg["theta"])


def double_block(weights, cfg: dict, i: int, img, txt, vec, cos, sin):
    pre = f"transformer_blocks.{i}"
    return _double(weights.group(pre), pre, img.float(), txt.float(),
                   vec.float(), cos, sin, cfg["heads"], cfg["head_dim"])


def single_block(weights, cfg: dict, i: int, x, vec, cos, sin):
    pre = f"single_transformer_blocks.{i}"
    return _single(weights.group(pre), pre, x.float(), vec.float(), cos,
                   sin, cfg["heads"], cfg["head_dim"])


def single_linear1(weights, i: int, x):
    """A single block's fused input linear: [q k v | mlp] of ``x``."""
    pre = f"single_transformer_blocks.{i}"
    w = weights.group(pre)
    return torch.cat([linear(w, f"{pre}.{n}", x.float())
                      for n in ("attn.to_q", "attn.to_k", "attn.to_v",
                                "proj_mlp")], dim=-1)


def single_linear2(weights, i: int, x):
    """A single block's output linear of [attention | mlp]."""
    pre = f"single_transformer_blocks.{i}"
    return linear(weights.group(pre), f"{pre}.proj_out", x.float())


def single_attention(weights, cfg: dict, i: int, qkv, cos, sin):
    """A single block's attention from its q, k, v lanes (B, S, 3h):
    the q/k RMS norms, RoPE, softmax attention, heads merged."""
    pre = f"single_transformer_blocks.{i}"
    w = weights.group(pre)
    heads, hd = cfg["heads"], cfg["head_dim"]
    q, k, v = (_heads(t, heads) for t in qkv.float().chunk(3, dim=-1))
    q = apply_rope(rms_norm(q, w[f"{pre}.attn.norm_q.weight"]), cos, sin)
    k = apply_rope(rms_norm(k, w[f"{pre}.attn.norm_k.weight"]), cos, sin)
    out = attention(q, k, v, 1.0 / math.sqrt(hd))
    b, _, s, _ = out.shape
    return out.transpose(1, 2).reshape(b, s, heads * hd)


def final_proj(weights, x):
    """The output layer's projection of its modulated input."""
    return linear(weights.group("_top"), "proj_out", x.float())


def final(weights, img, vec):
    """The output norm, modulated by the conditioning, and projection."""
    top = weights.group("_top")
    scale, shift = linear(top, "norm_out.linear",
                          F.silu(vec.float())).chunk(2, -1)
    return linear(top, "proj_out", _modulate(img.float(), shift, scale))


def forward(weights, cfg: dict, hidden: torch.Tensor, context: torch.Tensor,
            pooled: torch.Tensor, timestep: torch.Tensor,
            guidance: torch.Tensor, grid_h: int, grid_w: int
            ) -> torch.Tensor:
    """Velocity (B, S_img, out_channels), f32. ``hidden`` (B, S_img,
    in_channels) packed latents (with the Fill conditioning joined),
    ``context`` (B, S_txt, 4096), ``pooled`` (B, 768), ``timestep`` and
    ``guidance`` (B,) as the pipeline passes them (sigma; guidance
    scale)."""
    img, txt, vec = embed(weights, cfg, hidden, context, pooled, timestep,
                          guidance)
    cos, sin = rope(cfg, txt.shape[1], grid_h, grid_w, img.device)
    for i in range(cfg["depth_double"]):
        img, txt = double_block(weights, cfg, i, img, txt, vec, cos, sin)
    x = torch.cat([txt, img], dim=1)
    for i in range(cfg["depth_single"]):
        x = single_block(weights, cfg, i, x, vec, cos, sin)
    return final(weights, x[:, txt.shape[1]:], vec)
