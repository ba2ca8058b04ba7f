"""Flux AutoencoderKL: 16 latent channels, 8x spatial factor (port of
``domainrag_tpu/models/flux/vae.py``).

Resnet blocks with GroupNorm/silu, a single-head mid-block attention
(dense: the JAX package has no Pallas kernel for it), stride-2
downsampling with diffusers' asymmetric (0, 1) padding, nearest-2x
upsampling. Latents are normalized as ``(mean - shift) * scaling`` and
denormalized as ``z / scaling + shift``. Every op runs in its input's
dtype (the weights are cast to it), so the fill's encode runs in bf16 at
full width and the decode in f32, as in the JAX package; TF32 is off
(``core.device.resolve``).

The tiled paths (:func:`encode_tiled`, :func:`decode_tiled`) bound the
activation memory of the >=2048 px fill: overlapping latent tiles run one
after another and are blended linearly into an f32 accumulator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ...core import prng
from ..common import (Params, conv2d, conv_init, groupnorm,
                      groupnorm_init)


@dataclasses.dataclass(frozen=True)
class VaeConfig:
    latent_channels: int = 16
    block_out: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159

    @property
    def spatial_factor(self) -> int:
        return 2 ** (len(self.block_out) - 1)


TINY_VAE = VaeConfig(latent_channels=4, block_out=(8, 16), layers_per_block=1,
                     norm_groups=4, scaling_factor=0.5, shift_factor=0.1)

FLUX_VAE = VaeConfig()


def _resnet_init(key, c_in: int, c_out: int) -> Params:
    k1, k2, k3 = prng.split(key, 3)
    p = {
        "norm1": groupnorm_init(c_in, device=key.device),
        "conv1": conv_init(k1, 3, 3, c_in, c_out),
        "norm2": groupnorm_init(c_out, device=key.device),
        "conv2": conv_init(k2, 3, 3, c_out, c_out),
    }
    if c_in != c_out:
        p["shortcut"] = conv_init(k3, 1, 1, c_in, c_out)
    return p


def _resnet(p: Params, x: torch.Tensor, groups: int,
            conv=conv2d) -> torch.Tensor:
    """The residual block; ``conv`` runs its convolutions (the decoder's
    :func:`_conv_rows`). The activations and the sum are taken in place
    on fresh tensors: the same values, and one full-size tensor fewer."""
    h = conv(p["conv1"], F.silu(groupnorm(p["norm1"], x, groups),
                                inplace=True))
    h = conv(p["conv2"], F.silu(groupnorm(p["norm2"], h, groups),
                                inplace=True))
    if "shortcut" in p:
        x = conv(p["shortcut"], x)
    h += x
    return h


# The decoder's convolutions run this many output rows per call: cuDNN's
# f32 workspace for a channels-last convolution grows with the rows of
# the call (2.1 GB for one 1024 x 1024 x 256 image at once on an H100).
DECODE_ROWS = 128


def _conv_rows(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``conv2d(p, x)`` (stride 1, SAME padding), :data:`DECODE_ROWS`
    output rows at a time, each from its rows of x and their halo."""
    h, r = x.shape[1], p["w"].shape[2] // 2
    if h <= DECODE_ROWS:
        return conv2d(p, x)
    out = None
    for r0 in range(0, h, DECODE_ROWS):
        r1 = min(r0 + DECODE_ROWS, h)
        lo, hi = max(r0 - r, 0), min(r1 + r, h)
        y = conv2d(p, x[:, lo:hi],
                   padding=((lo - (r0 - r), r1 + r - hi), (r, r)))
        if out is None:
            out = y.new_empty((x.shape[0], h) + tuple(y.shape[2:]))
        out[:, r0:r1] = y
    return out


def _attn_init(key, c: int) -> Params:
    ks = prng.split(key, 4)
    p = {"norm": groupnorm_init(c, device=key.device)}
    for name, k in zip(("q", "k", "v", "o"), ks):
        p[name] = conv_init(k, 1, 1, c, c)
    return p


def _attn(p: Params, x: torch.Tensor, groups: int) -> torch.Tensor:
    b, h, w, c = x.shape
    y = groupnorm(p["norm"], x, groups)
    q = conv2d(p["q"], y).reshape(b, h * w, c)
    k = conv2d(p["k"], y).reshape(b, h * w, c)
    v = conv2d(p["v"], y).reshape(b, h * w, c)
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) \
        / math.sqrt(c)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v).reshape(b, h, w, c)
    return x + conv2d(p["o"], out)


def _mid_init(key, c: int) -> Params:
    k1, k2, k3 = prng.split(key, 3)
    return {"res1": _resnet_init(k1, c, c), "attn": _attn_init(k2, c),
            "res2": _resnet_init(k3, c, c)}


def _mid(p: Params, x: torch.Tensor, groups: int) -> torch.Tensor:
    x = _resnet(p["res1"], x, groups)
    x = _attn(p["attn"], x, groups)
    return _resnet(p["res2"], x, groups)


def init(key, cfg: VaeConfig = FLUX_VAE) -> Params:
    """Encoder and decoder weights (the JAX package's tree), drawn from
    ``iter(split(key, 1024))`` in JAX's order."""
    ks = iter(prng.split(prng.check_key(key, "init"), 1024))
    dev = key.device
    blocks = cfg.block_out
    enc: Params = {"conv_in": conv_init(next(ks), 3, 3, 3, blocks[0]),
                   "down": []}
    c_prev = blocks[0]
    for i, c in enumerate(blocks):
        stage: Params = {"res": []}
        for _ in range(cfg.layers_per_block):
            stage["res"].append(_resnet_init(next(ks), c_prev, c))
            c_prev = c
        if i < len(blocks) - 1:
            stage["down"] = conv_init(next(ks), 3, 3, c, c)
        enc["down"].append(stage)
    enc["mid"] = _mid_init(next(ks), c_prev)
    enc["norm_out"] = groupnorm_init(c_prev, device=dev)
    enc["conv_out"] = conv_init(next(ks), 3, 3, c_prev,
                                2 * cfg.latent_channels)

    dec: Params = {"conv_in": conv_init(next(ks), 3, 3, cfg.latent_channels,
                                        blocks[-1]),
                   "mid": _mid_init(next(ks), blocks[-1]),
                   "up": []}
    c_prev = blocks[-1]
    for i, c in enumerate(reversed(blocks)):
        stage = {"res": []}
        for _ in range(cfg.layers_per_block + 1):
            stage["res"].append(_resnet_init(next(ks), c_prev, c))
            c_prev = c
        if i < len(blocks) - 1:
            stage["up"] = conv_init(next(ks), 3, 3, c, c)
        dec["up"].append(stage)
    dec["norm_out"] = groupnorm_init(c_prev, device=dev)
    dec["conv_out"] = conv_init(next(ks), 3, 3, c_prev, 3)
    return {"encoder": enc, "decoder": dec}


def encode_moments(params: Params, images: torch.Tensor,
                   cfg: VaeConfig = FLUX_VAE) -> torch.Tensor:
    """Images (B, H, W, 3) in [-1, 1] -> moments (B, H/f, W/f, 2*C)."""
    enc = params["encoder"]
    g = cfg.norm_groups
    x = conv2d(enc["conv_in"], images)
    for stage in enc["down"]:
        for res in stage["res"]:
            x = _resnet(res, x, g)
        if "down" in stage:
            # diffusers downsampler: asymmetric pad (0, 1) then stride 2
            x = conv2d(stage["down"], x, stride=2, padding=((0, 1), (0, 1)))
    x = _mid(enc["mid"], x, g)
    x = F.silu(groupnorm(enc["norm_out"], x, g))
    return conv2d(enc["conv_out"], x)


def encode(params: Params, images: torch.Tensor,
           cfg: VaeConfig = FLUX_VAE,
           key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalized latents of the posterior's mode (the fill path draws no
    sample), or, with a PRNG ``key`` (``core.prng``), of a sample: ``mean
    + exp(0.5 * clip(logvar, -30, 20)) * normal(key, mean.shape,
    mean.dtype)``, JAX's draw."""
    moments = encode_moments(params, images, cfg)
    mean = moments[..., :cfg.latent_channels]
    if key is not None:
        key = prng.check_key(key, "vae.encode").to(mean.device)
        logvar = moments[..., cfg.latent_channels:].clamp(-30.0, 20.0)
        mean = mean + torch.exp(0.5 * logvar) * prng.normal(
            key, mean.shape, mean.dtype)
    return (mean - cfg.shift_factor) * cfg.scaling_factor


def decode(params: Params, latents: torch.Tensor,
           cfg: VaeConfig = FLUX_VAE) -> torch.Tensor:
    """Normalized latents (B, h, w, C) -> images (B, H, W, 3) in [-1, 1]."""
    dec = params["decoder"]
    g = cfg.norm_groups
    z = latents / cfg.scaling_factor + cfg.shift_factor
    x = conv2d(dec["conv_in"], z)
    x = _mid(dec["mid"], x, g)
    for stage in dec["up"]:
        for res in stage["res"]:
            x = _resnet(res, x, g, _conv_rows)
        if "up" in stage:
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            x = _conv_rows(stage["up"], x)
    x = F.silu(groupnorm(dec["norm_out"], x, g))
    return _conv_rows(dec["conv_out"], x)


def _blend_profile(n: int, ramp_lo: int, ramp_hi: int,
                   device=None) -> torch.Tensor:
    w = torch.ones(n, dtype=torch.float32, device=device)
    if ramp_lo > 0:
        w[:ramp_lo] = (torch.arange(ramp_lo, device=device) + 1.0) \
            / (ramp_lo + 1.0)
    if ramp_hi > 0:
        r = (torch.arange(ramp_hi, device=device) + 1.0) / (ramp_hi + 1.0)
        w[n - ramp_hi:] = r.flip(0)
    return w


def _tile_starts(n: int, tile: int, overlap: int) -> List[int]:
    return list(range(0, max(n - overlap, 1), tile - overlap))


def _tiled(fn, x: torch.Tensor, lh: int, lw: int, scale_in: int,
           scale_out: int, channels: int, tile: int,
           overlap: int) -> torch.Tensor:
    """``fn`` over overlapping tiles of ``tile`` latent cells, one tile
    after another, blended into an f32 accumulator. ``x`` is cut at
    ``scale_in`` pixels per latent cell and ``fn``'s output placed at
    ``scale_out``."""
    out = weight = None
    dtype = None
    for y in _tile_starts(lh, tile, overlap):
        for xx in _tile_starts(lw, tile, overlap):
            y1, x1 = min(y + tile, lh), min(xx + tile, lw)
            y0, x0 = max(y1 - tile, 0), max(x1 - tile, 0)
            patch = fn(x[:, y0 * scale_in:y1 * scale_in,
                         x0 * scale_in:x1 * scale_in])
            ph, pw = patch.shape[1], patch.shape[2]
            r = overlap * scale_out
            wy = _blend_profile(ph, (y0 > 0) * r, (y1 < lh) * r, x.device)
            wx = _blend_profile(pw, (x0 > 0) * r, (x1 < lw) * r, x.device)
            wmap = (wy[:, None] * wx[None, :])[None, :, :, None]
            if out is None:
                dtype = patch.dtype
                out = torch.zeros((x.shape[0], lh * scale_out, lw * scale_out,
                                   channels), dtype=torch.float32,
                                  device=x.device)
                weight = torch.zeros((1, lh * scale_out, lw * scale_out, 1),
                                     dtype=torch.float32, device=x.device)
            ys, xs = slice(y0 * scale_out, y1 * scale_out), \
                slice(x0 * scale_out, x1 * scale_out)
            out[:, ys, xs] += patch.float() * wmap
            weight[:, ys, xs] += wmap
    return (out / weight.clamp_min(1e-8)).to(dtype)


def decode_tiled(params: Params, latents: torch.Tensor,
                 cfg: VaeConfig = FLUX_VAE, tile: int = 96,
                 overlap: int = 16) -> torch.Tensor:
    """:func:`decode` over overlapping latent tiles with linear blending
    (exact :func:`decode` when one tile covers the latents)."""
    _, lh, lw, _ = latents.shape
    if lh <= tile and lw <= tile:
        return decode(params, latents, cfg)
    return _tiled(lambda z: decode(params, z, cfg), latents, lh, lw, 1,
                  cfg.spatial_factor, 3, tile, overlap)


def encode_tiled(params: Params, images: torch.Tensor,
                 cfg: VaeConfig = FLUX_VAE, tile: int = 96,
                 overlap: int = 16,
                 key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`encode` over overlapping tiles (``tile``/``overlap`` in
    latent cells, as :func:`decode_tiled`), blending the normalized
    latents (seams see a truncated receptive field, as in diffusers'
    tiled VAE). Every tile samples with the same ``key``, as in the JAX
    package."""
    f = cfg.spatial_factor
    lh, lw = images.shape[1] // f, images.shape[2] // f
    if lh <= tile and lw <= tile:
        return encode(params, images, cfg, key)
    return _tiled(lambda x: encode(params, x, cfg, key), images, lh, lw, f,
                  1, cfg.latent_channels, tile, overlap)
