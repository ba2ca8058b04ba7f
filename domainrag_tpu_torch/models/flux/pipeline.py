"""Flux text/Redux-conditioned generation — the stage-3 serving path
(port of ``domainrag_tpu/models/flux/pipeline.py:40-252, 304-310,
440-448, 1000-1157``).

First-party equivalent of diffusers' ``FluxPriorReduxPipeline`` +
``FluxPipeline`` as the reference drives them for background generation
(batch_generate_flux_kshot.py:139-151, 459-474: dual-image Redux prior,
guidance 2.5, 50 steps, 1024x1024, fixed seed). Eager PyTorch: prompt
encode, prior fusion, the Euler loop over the MMDiT, VAE decode.

Dtypes follow the JAX package: the MMDiT runs in ``compute_dtype`` (bf16
at full width), T5 / CLIP text / SigLIP / Redux in f32, the VAE decode in
f32. Out of this slice: velocity and block caches, meshes, int8 modes and
fill; ``generate`` takes those arguments only at their defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...core import device as device_mod
from ...core import text as text_util
from ...core.log import StepTimer
from .. import clip as clip_mod
from .. import redux as redux_mod
from .. import siglip as siglip_mod
from .. import t5 as t5_mod
from ..common import Init
from . import model as flux_mod
from . import scheduler as sched_mod
from . import vae as vae_mod


@dataclasses.dataclass
class FluxBundle:
    """All weights + configs for one Flux deployment, on one device."""

    flux_params: dict
    flux_cfg: flux_mod.FluxConfig
    vae_params: dict
    vae_cfg: vae_mod.VaeConfig
    t5_params: dict
    t5_cfg: t5_mod.T5Config
    clip_text_params: dict
    clip_text_cfg: clip_mod.ClipTextConfig
    siglip_params: Optional[dict] = None
    siglip_cfg: Optional[siglip_mod.SiglipVisionConfig] = None
    redux_params: Optional[dict] = None
    redux_cfg: Optional[redux_mod.ReduxEncoderConfig] = None
    clip_tokenizer: text_util.TokenizerLike = None
    t5_tokenizer: text_util.TokenizerLike = None
    t5_max_len: int = 512
    clip_max_len: int = 77
    compute_dtype: torch.dtype = torch.bfloat16
    device: torch.device = torch.device("cuda")

    @property
    def latent_factor(self) -> int:
        # token grid cell covers vae_factor * 2 pixels (2x2 latent packing)
        return self.vae_cfg.spatial_factor * 2


def tiny_configs():
    """The JAX package's ``tiny_bundle`` configs (pipeline.py:80-116):
    structure-identical to the 12B deployment, toy sizes."""
    vae_cfg = vae_mod.TINY_VAE
    t5_cfg = t5_mod.TINY_T5
    flux_cfg = dataclasses.replace(
        flux_mod.TINY_FLUX, in_channels=vae_cfg.latent_channels * 4,
        out_channels=vae_cfg.latent_channels * 4, text_dim=t5_cfg.d_model,
        pooled_dim=64)
    clip_cfg = dataclasses.replace(clip_mod.TINY_TEXT, hidden=64)
    siglip_cfg = siglip_mod.TINY_SIGLIP
    redux_cfg = redux_mod.ReduxEncoderConfig(
        siglip_hidden=siglip_cfg.hidden, txt_dim=t5_cfg.d_model)
    return dict(flux_cfg=flux_cfg, vae_cfg=vae_cfg, t5_cfg=t5_cfg,
                clip_text_cfg=clip_cfg, siglip_cfg=siglip_cfg,
                redux_cfg=redux_cfg)


def tiny_tokenizers(cfgs: dict) -> dict:
    return dict(
        clip_tokenizer=text_util.StubTokenizer(
            vocab_size=cfgs["clip_text_cfg"].vocab_size, bos_id=98,
            eos_id=99),
        t5_tokenizer=text_util.StubTokenizer(
            vocab_size=cfgs["t5_cfg"].vocab_size, bos_id=None, eos_id=1),
        t5_max_len=16, clip_max_len=16)


def _random_bundle(cfgs: dict, seed: int, dev: torch.device,
                   flux_dtype: torch.dtype, compute_dtype: torch.dtype,
                   **extra) -> FluxBundle:
    """Random weights drawn on ``dev`` by the port's own inits (the JAX
    ``init`` scales). The MMDiT is stored in ``flux_dtype``; the towers
    and the VAE in f32, the dtypes they run in."""
    g = device_mod.generator(seed, dev)
    f32 = Init(g, dev, torch.float32)
    return FluxBundle(
        flux_params=flux_mod.init(cfgs["flux_cfg"], Init(g, dev, flux_dtype)),
        vae_params=vae_mod.init(cfgs["vae_cfg"], f32),
        t5_params=t5_mod.init(cfgs["t5_cfg"], f32),
        clip_text_params=clip_mod.init_text(cfgs["clip_text_cfg"], f32),
        siglip_params=siglip_mod.init(cfgs["siglip_cfg"], f32),
        redux_params=redux_mod.init(cfgs["redux_cfg"], f32),
        compute_dtype=compute_dtype, device=dev, **cfgs, **extra)


def tiny_bundle(seed: int = 0, device=None) -> FluxBundle:
    """Random tiny bundle (f32 compute) on ``device`` (the card unless
    ``device="cpu"``)."""
    cfgs = tiny_configs()
    return _random_bundle(cfgs, seed, device_mod.resolve(device),
                          torch.float32, torch.float32,
                          **tiny_tokenizers(cfgs))


def full_bundle(seed: int = 0, device=None) -> FluxBundle:
    """Random full-width FLUX.1-dev deployment drawn on the device: the
    12B MMDiT (3072 hidden, 24x128 heads, 19 + 38 blocks) in bf16, T5-XXL,
    CLIP-L text, SigLIP so400m, Redux 1152->12288->4096 and the FLUX VAE
    decoder in f32 — about 46 GB."""
    cfgs = dict(flux_cfg=flux_mod.FLUX_DEV, vae_cfg=vae_mod.FLUX_VAE,
                t5_cfg=t5_mod.T5_XXL, clip_text_cfg=clip_mod.CLIP_L_TEXT,
                siglip_cfg=siglip_mod.SIGLIP_SO400M,
                redux_cfg=redux_mod.REDUX_DEV)
    clip_cfg = cfgs["clip_text_cfg"]
    tokenizers = dict(
        clip_tokenizer=text_util.StubTokenizer(
            vocab_size=clip_cfg.vocab_size, bos_id=clip_cfg.eos_token_id - 1,
            eos_id=clip_cfg.eos_token_id),
        t5_tokenizer=text_util.StubTokenizer(
            vocab_size=cfgs["t5_cfg"].vocab_size, bos_id=None, eos_id=1))
    return _random_bundle(cfgs, seed, device_mod.resolve(device),
                          torch.bfloat16, torch.bfloat16, **tokenizers)


# ---------------------------------------------------------------------------
# prompt + prior encoding
# ---------------------------------------------------------------------------

def encode_prompt(bundle: FluxBundle, prompts: Sequence[str]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T5 embeds (N, S, D_t5), CLIP pooled (N, D_clip)) per prompt, f32."""
    t5_ids = text_util.batch_tokenize(bundle.t5_tokenizer, prompts,
                                      bundle.t5_max_len)
    clip_ids = text_util.batch_tokenize(bundle.clip_tokenizer, prompts,
                                        bundle.clip_max_len)
    dev = bundle.device
    t5_out = t5_mod.apply(bundle.t5_params,
                          torch.as_tensor(t5_ids, device=dev), bundle.t5_cfg)
    _, pooled = clip_mod.apply_text(bundle.clip_text_params,
                                    torch.as_tensor(clip_ids, device=dev),
                                    bundle.clip_text_cfg)
    return t5_out, pooled


def _image_tokens(bundle: FluxBundle, images: np.ndarray) -> torch.Tensor:
    if bundle.siglip_params is None:
        raise ValueError("bundle lacks Redux weights")
    x = torch.as_tensor(np.asarray(images, np.float32), device=bundle.device)
    sig = siglip_mod.apply(bundle.siglip_params, x, bundle.siglip_cfg)
    return redux_mod.apply(bundle.redux_params, sig)


def redux_prior(bundle: FluxBundle, images: np.ndarray,
                prompts: Sequence[str],
                prompt_embeds_scale: Sequence[float],
                pooled_prompt_embeds_scale: Sequence[float]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (N, S, S, 3) siglip-preprocessed -> fused
    ((1, S_txt + S_img, D), (1, P))."""
    txt, pooled = encode_prompt(bundle, prompts)
    return redux_mod.combine_prior(txt, pooled, _image_tokens(bundle, images),
                                   prompt_embeds_scale,
                                   pooled_prompt_embeds_scale)


def redux_prior_pairs_indexed(bundle: FluxBundle,
                              unique_images: np.ndarray,
                              pair_idx: np.ndarray,
                              prompt: str,
                              prompt_embeds_scale: Sequence[float],
                              pooled_prompt_embeds_scale: Sequence[float]
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dual-image priors with the SigLIP tower run once per UNIQUE image
    and the per-pair embeddings gathered by index. ``unique_images``
    (U, S, S, 3); ``pair_idx`` (N, K) indices into it. The text encoders
    run once for the shared prompt. Returns ((N, S_txt + S_img, D),
    (N, P))."""
    pair_idx = np.asarray(pair_idx)
    n, k = pair_idx.shape
    txt1, pooled1 = encode_prompt(bundle, [prompt])
    txt = txt1[:, None].expand((n, k) + tuple(txt1.shape[1:]))
    pooled = pooled1[:, None].expand((n, k) + tuple(pooled1.shape[1:]))
    img_unique = _image_tokens(bundle, unique_images)      # (U, S_i, D)
    img_embeds = img_unique[torch.as_tensor(pair_idx, device=bundle.device)]
    return redux_mod.combine_prior_pairs(txt, pooled, img_embeds,
                                         prompt_embeds_scale,
                                         pooled_prompt_embeds_scale)


# ---------------------------------------------------------------------------
# generation (text/Redux -> image)
# ---------------------------------------------------------------------------

def _decode_tokens(vae_params, tokens, grid_h, grid_w, vae_cfg):
    lat = flux_mod.unpack_latents(tokens.float(), grid_h, grid_w)
    return vae_mod.decode(vae_params, lat, vae_cfg)


def _noise(bundle: FluxBundle, seeds: Sequence[int], seq: int, c: int
           ) -> torch.Tensor:
    """(B, seq, c) f32 standard normal, one generator per seed on the
    bundle's device. The JAX package draws from ``jax.random``, whose bits
    differ: comparisons hand both the same noise instead."""
    return torch.stack([
        torch.randn((seq, c), generator=device_mod.generator(s, bundle.device),
                    device=bundle.device, dtype=torch.float32)
        for s in seeds])


def _generate_float(bundle: FluxBundle, prompt_embeds: torch.Tensor,
                    pooled: torch.Tensor, height: int, width: int,
                    num_steps: int, guidance: float, noise: torch.Tensor,
                    scheduler_overrides: Optional[dict] = None,
                    timer: Optional[StepTimer] = None) -> torch.Tensor:
    """The denoise + decode core -> (B, H, W, 3) f32 in [-1, 1]. Each
    denoise step is a ``step`` span of ``timer``, the decode a ``decode``
    span."""
    timer = timer or StepTimer()
    dev = bundle.device
    lf = bundle.latent_factor
    grid_h, grid_w = height // lf, width // lf
    schedule = sched_mod.make_schedule(
        num_steps, image_seq_len=grid_h * grid_w,
        **(scheduler_overrides or {}))
    sigmas = torch.as_tensor(schedule.sigmas, dtype=torch.float32, device=dev)
    x = noise.to(device=dev, dtype=bundle.compute_dtype)
    embeds = prompt_embeds.to(device=dev, dtype=bundle.compute_dtype)
    pooled_c = pooled.to(device=dev, dtype=bundle.compute_dtype)
    img_ids = torch.as_tensor(flux_mod.make_image_ids(grid_h, grid_w),
                              device=dev)
    txt_ids = torch.as_tensor(flux_mod.make_text_ids(embeds.shape[1]),
                              device=dev)
    b = x.shape[0]
    guid = torch.full((b,), float(guidance), dtype=torch.float32, device=dev)
    for i in range(schedule.num_steps):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        with timer.span("step"):
            v = flux_mod.apply(bundle.flux_params, x, embeds, pooled_c,
                               sigma.expand(b), img_ids, txt_ids,
                               bundle.flux_cfg, guidance=guid)
            x = sched_mod.euler_step(x, v, sigma, sigma_next)
    with timer.span("decode"):
        return _decode_tokens(bundle.vae_params, x, grid_h, grid_w,
                              bundle.vae_cfg)


@torch.inference_mode()
def generate(bundle: FluxBundle, prompt_embeds: torch.Tensor,
             pooled: torch.Tensor, height: int, width: int,
             num_steps: int = 50, guidance: float = 2.5,
             seed=0,
             scheduler_overrides: Optional[dict] = None,
             mesh=None, pipe_axis: Optional[str] = None,
             block_cache_interval: int = 1,
             velocity_cache_interval: int = 1,
             noise: Optional[torch.Tensor] = None,
             timer: Optional[StepTimer] = None) -> np.ndarray:
    """Full text/Redux-to-image run. Returns (B, H, W, 3) uint8 when
    ``prompt_embeds`` is batched (B > 1), else (H, W, 3).

    Defaults mirror the background-gen stage (guidance 2.5, 50 steps,
    fixed seed). ``noise``: (B, S_img, 4*latent_channels) initial latents
    in place of the per-seed draw (how tests hand the JAX package's noise
    to the port). ``timer`` gets a ``step`` span per denoise step and a
    ``decode`` span. Images with a non-finite value before quantisation
    are counted in ``generate.nonfinite_images``. Meshes, pipelining and
    the cache accelerators are not part of this slice and raise when
    asked for."""
    if mesh is not None or pipe_axis is not None:
        raise NotImplementedError("meshes and pipelining are not ported")
    if block_cache_interval != 1 or velocity_cache_interval != 1:
        raise NotImplementedError("the denoise caches are not ported")
    b = prompt_embeds.shape[0]
    if noise is None:
        seeds = list(seed) if isinstance(seed, (list, tuple)) else [seed] * b
        if len(seeds) != b:
            raise ValueError(f"{len(seeds)} seeds for a batch of {b}")
        lf = bundle.latent_factor
        noise = _noise(bundle, seeds, (height // lf) * (width // lf),
                       bundle.vae_cfg.latent_channels * 4)
    img = _generate_float(bundle, prompt_embeds, pooled, height, width,
                          num_steps, guidance, noise, scheduler_overrides,
                          timer).float().cpu().numpy()
    generate.nonfinite_images += int((~np.isfinite(img)).any(
        axis=(1, 2, 3)).sum())
    out = to_uint8(img)
    return out if b > 1 else out[0]


generate.nonfinite_images = 0


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8 (diffusers postprocess convention)."""
    return (np.clip(img / 2.0 + 0.5, 0.0, 1.0) * 255.0).round().astype(
        np.uint8)
