"""The FLUX VAE's encoder in float32, as diffusers' ``AutoencoderKL``
computes it (the posterior's mode, normalized by the shift and scaling
factors), over the published keys, and the tiled encode the stage runs
at 2048 px and above: overlapping tiles of 96 latent cells with 16 of
overlap, each encoded alone, blended by linear ramps across the overlaps.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .ops import attention, conv, group_norm, linear


def _resnet(w, pre, x, groups):
    h = conv(w, f"{pre}.conv1", F.silu(group_norm(
        x, w[f"{pre}.norm1.weight"], w[f"{pre}.norm1.bias"], groups)))
    h = conv(w, f"{pre}.conv2", F.silu(group_norm(
        h, w[f"{pre}.norm2.weight"], w[f"{pre}.norm2.bias"], groups)))
    if f"{pre}.conv_shortcut.weight" in w:
        x = conv(w, f"{pre}.conv_shortcut", x, padding=0)
    return x + h


def _mid_attention(w, pre, x, groups):
    b, c, h, w_ = x.shape
    y = group_norm(x, w[f"{pre}.group_norm.weight"],
                   w[f"{pre}.group_norm.bias"], groups)
    y = y.flatten(2).transpose(1, 2)                       # (B, HW, C)
    q, k, v = (linear(w, f"{pre}.{n}", y)[:, None]
               for n in ("to_q", "to_k", "to_v"))
    a = attention(q, k, v, 1.0 / math.sqrt(c), head_chunk=1)[:, 0]
    out = linear(w, f"{pre}.to_out.0", a)
    return x + out.transpose(1, 2).reshape(b, c, h, w_)


def encode(w, cfg: dict, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [-1, 1] -> normalized latents (B, H/8, W/8, C)."""
    g = cfg["norm_groups"]
    enc = w.group("_top")
    x = conv(enc, "encoder.conv_in", images.float().permute(0, 3, 1, 2))
    for i in range(len(cfg["block_out"])):
        pre = f"encoder.down_blocks.{i}"
        blk = w.group(pre)
        for j in range(cfg["layers_per_block"]):
            x = _resnet(blk, f"{pre}.resnets.{j}", x, g)
        if f"{pre}.downsamplers.0.conv.weight" in blk:
            x = conv(blk, f"{pre}.downsamplers.0.conv",
                     F.pad(x, (0, 1, 0, 1)), stride=2, padding=0)
    mid = w.group("encoder.mid_block.resnets.0")
    x = _resnet(mid, "encoder.mid_block.resnets.0", x, g)
    att = w.group("encoder.mid_block.attentions.0")
    x = _mid_attention(att, "encoder.mid_block.attentions.0", x, g)
    mid = w.group("encoder.mid_block.resnets.1")
    x = _resnet(mid, "encoder.mid_block.resnets.1", x, g)
    enc = w.group("_top")
    x = F.silu(group_norm(x, enc["encoder.conv_norm_out.weight"],
                          enc["encoder.conv_norm_out.bias"], g))
    moments = conv(enc, "encoder.conv_out", x)
    mean = moments[:, :cfg["latent_channels"]].permute(0, 2, 3, 1)
    return (mean - cfg["shift_factor"]) * cfg["scaling_factor"]


def _ramp(n: int, lo: int, hi: int, device) -> torch.Tensor:
    w = torch.ones(n, device=device)
    if lo:
        w[:lo] = torch.arange(1, lo + 1, device=device) / (lo + 1.0)
    if hi:
        w[n - hi:] = torch.arange(hi, 0, -1, device=device) / (hi + 1.0)
    return w


def encode_tiled(w, cfg: dict, images: torch.Tensor, tile: int = 96,
                 overlap: int = 16) -> torch.Tensor:
    f = 2 ** (len(cfg["block_out"]) - 1)
    lh, lw = images.shape[1] // f, images.shape[2] // f
    if lh <= tile and lw <= tile:
        return encode(w, cfg, images)
    out = torch.zeros(images.shape[0], lh, lw, cfg["latent_channels"],
                      device=images.device)
    weight = torch.zeros(1, lh, lw, 1, device=images.device)
    starts = lambda n: range(0, max(n - overlap, 1), tile - overlap)  # noqa
    for ty in starts(lh):
        for tx in starts(lw):
            y1, x1 = min(ty + tile, lh), min(tx + tile, lw)
            y0, x0 = max(y1 - tile, 0), max(x1 - tile, 0)
            z = encode(w, cfg, images[:, y0 * f:y1 * f, x0 * f:x1 * f])
            wy = _ramp(y1 - y0, overlap * (y0 > 0), overlap * (y1 < lh),
                       images.device)
            wx = _ramp(x1 - x0, overlap * (x0 > 0), overlap * (x1 < lw),
                       images.device)
            wm = (wy[:, None] * wx[None, :])[None, :, :, None]
            out[:, y0:y1, x0:x1] += z * wm
            weight[:, y0:y1, x0:x1] += wm
    return out / weight.clamp_min(1e-8)


def pack(latents: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2 * W/2, C * 4), feature c * 4 + dy * 2 + dx
    (diffusers ``_pack_latents``)."""
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def pack_mask(mask: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, H, W) mask -> (B, S, factor^2 * 4): each factor x factor cell's
    pixels as channels, then packed 2 x 2 (``FluxFillPipeline``)."""
    b, h, w = mask.shape
    x = mask.reshape(b, h // factor, factor, w // factor, factor)
    x = x.permute(0, 1, 3, 2, 4).reshape(b, h // factor, w // factor,
                                         factor * factor)
    return pack(x)
