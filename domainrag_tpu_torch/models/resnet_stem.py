"""ResNet50-stem style encoder of the stage-2 re-rank (port of
``domainrag_tpu/models/resnet_stem.py``).

The reference's second-stage re-ranker embeds images with the first four
layers of torchvision resnet50 — conv1 (7x7/2) -> bn1 -> relu -> maxpool
(3x3/2) — then takes per-channel spatial mean/std as a 128-d "style" vector
(retrieval/clip100_resnet_style_all_shots.py:51-74,180-203).

Parity notes baked in here:
- torch ``.var`` is UNBIASED (correction=1); eps=1e-5 added to var then sqrt.
- input is raw RGB/255 at 256x256, NO ImageNet normalization (ref :188-190).
- conv1 padding 3, maxpool padding 1 (torch explicit padding, not SAME).

Activations are NHWC at every function; conv1's weight is in the port's
(out, in, kh, kw) layout, so :func:`convert_torch_stem` keeps torchvision's
tensor as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .common import (Params, batchnorm, batchnorm_init, conv2d,
                     conv_init, max_pool)


@dataclasses.dataclass(frozen=True)
class ResNetStemConfig:
    channels: int = 64
    eps: float = 1e-5


def init(key, cfg: ResNetStemConfig = ResNetStemConfig()) -> Params:
    """The conv drawn straight from ``key``, batchnorm at identity
    statistics, as in JAX."""
    return {"conv1": conv_init(key, 7, 7, 3, cfg.channels, bias=False),
            "bn1": batchnorm_init(cfg.channels, device=key.device)}


def apply_stem(params: Params, images: torch.Tensor,
               cfg: ResNetStemConfig = ResNetStemConfig()) -> torch.Tensor:
    """images: (B, H, W, 3) in [0,1]. Returns (B, H/4, W/4, 64)."""
    x = conv2d(params["conv1"], images, stride=2, padding=((3, 3), (3, 3)))
    x = torch.relu(batchnorm(params["bn1"], x))
    return max_pool(x, window=3, stride=2, padding=((1, 1), (1, 1)))


def calc_mean_std(feat: torch.Tensor, eps: float = 1e-5
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel spatial mean/std over an NHWC feature map: unbiased
    variance + eps, then sqrt (the reference ``calc_mean_std``,
    retrieval/...py:67-74). Returns two (B, C) tensors."""
    f = feat.float()
    b, h, w, c = f.shape
    flat = f.reshape(b, h * w, c)
    mean = flat.mean(dim=1)
    n = h * w
    var = (flat - mean[:, None]).square().mean(dim=1) * (n / max(n - 1, 1))
    return mean, torch.sqrt(var + eps)


def style_features(params: Params, images: torch.Tensor,
                   cfg: ResNetStemConfig = ResNetStemConfig()
                   ) -> torch.Tensor:
    """(B, H, W, 3)/[0,1] -> (B, 128) style vector = mean ++ std."""
    mean, std = calc_mean_std(apply_stem(params, images, cfg), cfg.eps)
    return torch.cat([mean, std], dim=-1)


def style_distance(query: torch.Tensor, candidates: torch.Tensor):
    """L2 distances (ref :474) and similarities 1/(1+d) (ref :492).
    query: (128,), candidates: (N, 128)."""
    d = torch.linalg.vector_norm(candidates.float() - query.float(), dim=-1)
    return d, 1.0 / (1.0 + d)


def convert_torch_stem(conv1_weight, bn_weight, bn_bias, bn_mean, bn_var
                       ) -> Params:
    """torchvision tensors -> the stem's tree. The port keeps conv weights
    as (O, I, kh, kw), torchvision's layout, so conv1 goes across as it
    is."""
    def f32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32))

    return {"conv1": {"w": f32(conv1_weight)},
            "bn1": {"scale": f32(bn_weight), "bias": f32(bn_bias),
                    "mean": f32(bn_mean), "var": f32(bn_var)}}
