"""Flux AutoencoderKL decoder: 16 latent channels, 8x spatial factor
(port of ``domainrag_tpu/models/flux/vae.py:27-200``; the encoder comes
with the fill path).

Resnet blocks with GroupNorm/silu, a single-head mid-block attention
(dense: the JAX package has no Pallas kernel for it), nearest-2x
upsampling. Latents are denormalized as ``z / scaling + shift``. Runs in
f32 with TF32 off (``core.device.resolve``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..common import (Init, Params, conv2d, conv_init, groupnorm,
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


def _resnet_init(ini: Init, c_in: int, c_out: int) -> Params:
    p = {
        "norm1": groupnorm_init(ini, c_in),
        "conv1": conv_init(ini, 3, 3, c_in, c_out),
        "norm2": groupnorm_init(ini, c_out),
        "conv2": conv_init(ini, 3, 3, c_out, c_out),
    }
    if c_in != c_out:
        p["shortcut"] = conv_init(ini, 1, 1, c_in, c_out)
    return p


def _resnet(p: Params, x: torch.Tensor, groups: int) -> torch.Tensor:
    h = conv2d(p["conv1"], F.silu(groupnorm(p["norm1"], x, groups)))
    h = conv2d(p["conv2"], F.silu(groupnorm(p["norm2"], h, groups)))
    if "shortcut" in p:
        x = conv2d(p["shortcut"], x)
    return x + h


def _attn_init(ini: Init, c: int) -> Params:
    p = {"norm": groupnorm_init(ini, c)}
    for name in ("q", "k", "v", "o"):
        p[name] = conv_init(ini, 1, 1, c, c)
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


def _mid_init(ini: Init, c: int) -> Params:
    return {"res1": _resnet_init(ini, c, c), "attn": _attn_init(ini, c),
            "res2": _resnet_init(ini, c, c)}


def _mid(p: Params, x: torch.Tensor, groups: int) -> torch.Tensor:
    x = _resnet(p["res1"], x, groups)
    x = _attn(p["attn"], x, groups)
    return _resnet(p["res2"], x, groups)


def init(cfg: VaeConfig, ini: Init) -> Params:
    """Decoder weights (the tree the JAX package keeps under "decoder")."""
    blocks = cfg.block_out
    dec: Params = {"conv_in": conv_init(ini, 3, 3, cfg.latent_channels,
                                        blocks[-1]),
                   "mid": _mid_init(ini, blocks[-1]),
                   "up": []}
    c_prev = blocks[-1]
    for i, c in enumerate(reversed(blocks)):
        stage = {"res": []}
        for _ in range(cfg.layers_per_block + 1):
            stage["res"].append(_resnet_init(ini, c_prev, c))
            c_prev = c
        if i < len(blocks) - 1:
            stage["up"] = conv_init(ini, 3, 3, c, c)
        dec["up"].append(stage)
    dec["norm_out"] = groupnorm_init(ini, c_prev)
    dec["conv_out"] = conv_init(ini, 3, 3, c_prev, 3)
    return {"decoder": dec}


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
            x = _resnet(res, x, g)
        if "up" in stage:
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            x = conv2d(stage["up"], x)
    x = F.silu(groupnorm(dec["norm_out"], x, g))
    return conv2d(dec["conv_out"], x)
