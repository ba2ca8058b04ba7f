"""FLUX.1-Redux prior: SigLIP tokens -> T5-space image tokens, plus the
multi-image weighted-sum conditioning of stage 3 (port of
``domainrag_tpu/models/redux.py:34-104``).

diffusers ``FluxPriorReduxPipeline`` semantics: per image, text embeds
(512 T5 tokens) and Redux image tokens (729) are concatenated to 1241
tokens, scaled by ``prompt_embeds_scale[i]`` (pooled by
``pooled_prompt_embeds_scale[i]``) and summed over the images.
``convert_hf_redux`` reads diffusers' ``ReduxImageEncoder`` weights.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core import device as device_mod
from ..core import prng
from .common import Params, ckpt_linear, linear, linear_init


@dataclasses.dataclass(frozen=True)
class ReduxEncoderConfig:
    siglip_hidden: int = 1152
    txt_dim: int = 4096           # T5 space

    @property
    def mid_dim(self) -> int:
        return 3 * self.txt_dim


REDUX_DEV = ReduxEncoderConfig()
TINY_REDUX = ReduxEncoderConfig(siglip_hidden=48, txt_dim=32)


def init(key, cfg: ReduxEncoderConfig = REDUX_DEV) -> Params:
    k1, k2 = prng.split(prng.check_key(key, "init"))
    return {"up": linear_init(k1, cfg.siglip_hidden, cfg.mid_dim),
            "down": linear_init(k2, cfg.mid_dim, cfg.txt_dim)}


def apply(params: Params, siglip_tokens: torch.Tensor) -> torch.Tensor:
    """(N, 729, siglip_hidden) -> (N, 729, txt_dim)."""
    return linear(params["down"], F.silu(linear(params["up"], siglip_tokens)))


def combine_prior(text_embeds: torch.Tensor, pooled_embeds: torch.Tensor,
                  image_embeds: torch.Tensor,
                  prompt_embeds_scale: Sequence[float],
                  pooled_prompt_embeds_scale: Sequence[float]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """text (N, S_txt, D), pooled (N, P), image (N, S_img, D) ->
    ((1, S_txt + S_img, D), (1, P))."""
    scales = torch.as_tensor(prompt_embeds_scale, dtype=text_embeds.dtype,
                             device=text_embeds.device)[:, None, None]
    pscales = torch.as_tensor(pooled_prompt_embeds_scale,
                              dtype=pooled_embeds.dtype,
                              device=pooled_embeds.device)[:, None]
    embeds = torch.cat([text_embeds, image_embeds], dim=1) * scales
    pooled = pooled_embeds * pscales
    return embeds.sum(0, keepdim=True), pooled.sum(0, keepdim=True)


def combine_prior_pairs(text_embeds: torch.Tensor,
                        pooled_embeds: torch.Tensor,
                        image_embeds: torch.Tensor,
                        prompt_embeds_scale, pooled_prompt_embeds_scale
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """N groups of K images each. text (N, K, S_t, D), pooled (N, K, P),
    image (N, K, S_i, D); scales (K,) shared or (N, K).
    Returns ((N, S_t + S_i, D), (N, P))."""
    scales = torch.as_tensor(prompt_embeds_scale, dtype=text_embeds.dtype,
                             device=text_embeds.device)
    pscales = torch.as_tensor(pooled_prompt_embeds_scale,
                              dtype=pooled_embeds.dtype,
                              device=pooled_embeds.device)
    scales = scales.expand(text_embeds.shape[:2])
    pscales = pscales.expand(pooled_embeds.shape[:2])
    embeds = torch.cat([text_embeds, image_embeds], dim=2)
    embeds = embeds * scales[:, :, None, None]
    pooled = pooled_embeds * pscales[:, :, None]
    return embeds.sum(1), pooled.sum(1)


def convert_hf_redux(state_dict, *, device=None) -> Params:
    """diffusers ``ReduxImageEncoder`` state dict (redux_up/redux_down) ->
    param tree, f32 on ``device`` (the card unless ``device="cpu"``)."""
    dev = device_mod.resolve(device)
    return {"up": ckpt_linear(state_dict, "redux_up", dev),
            "down": ckpt_linear(state_dict, "redux_down", dev)}
