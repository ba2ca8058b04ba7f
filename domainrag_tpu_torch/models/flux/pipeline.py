"""Flux text/Redux-conditioned generation and Flux-Fill — the serving
paths of stages 3 and 4 (port of ``domainrag_tpu/models/flux/pipeline.py:
40-252, 304-310, 440-477, 1000-1272, 1475-1649``).

First-party equivalent of diffusers' ``FluxPriorReduxPipeline`` +
``FluxPipeline`` as the reference drives them for background generation
(batch_generate_flux_kshot.py:139-151, 459-474: dual-image Redux prior,
guidance 2.5, 50 steps, 1024x1024, fixed seed), and of
``FluxFillPipeline`` for the compose stage (strength-trimmed partial
denoise from the noised image latents, conditioned on the masked-image
latents and the packed mask). Eager PyTorch: prompt encode, prior
fusion, VAE encode, the Euler loop over the MMDiT, VAE decode; at
``hires_threshold_px`` and above the VAE runs tiled.

Dtypes follow the JAX package: the MMDiT runs in ``compute_dtype`` (bf16
at full width), T5 / CLIP text / SigLIP / Redux in f32. The fill's image
enters the VAE encoder in ``compute_dtype`` (so the encode runs in bf16
at full width) and the latents and conditioning enter the MMDiT in it;
the VAE decode runs in f32. The int8 serving modes need no argument
here: a bundle whose MMDiT was quantized by ``models.quant.quantize_tree``
runs weight-only int8, W8A8 under ``common.set_int8_activations(True)``
and int8 attention under ``ops.mmdit_attention.set_int8_qk`` /
``set_int8_pv``. Out of these slices: velocity and block caches, meshes
and pipelining; ``generate`` and ``fill_batch`` take those arguments only
at their defaults and raise otherwise.
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


def tiny_configs(fill: bool = False):
    """The JAX package's ``tiny_bundle`` configs (pipeline.py:80-116):
    structure-identical to the 12B deployment, toy sizes. ``fill`` widens
    the MMDiT input to latents + masked-image latents + f^2*4 mask
    channels."""
    vae_cfg = vae_mod.TINY_VAE
    t5_cfg = t5_mod.TINY_T5
    lat_packed = vae_cfg.latent_channels * 4
    fill_in = 2 * lat_packed + vae_cfg.spatial_factor ** 2 * 4
    flux_cfg = dataclasses.replace(
        flux_mod.TINY_FLUX, in_channels=fill_in if fill else lat_packed,
        out_channels=lat_packed, text_dim=t5_cfg.d_model, pooled_dim=64)
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


def tiny_bundle(seed: int = 0, device=None, fill: bool = False
                ) -> FluxBundle:
    """Random tiny bundle (f32 compute) on ``device`` (the card unless
    ``device="cpu"``); a Flux-Fill one with ``fill``."""
    cfgs = tiny_configs(fill)
    return _random_bundle(cfgs, seed, device_mod.resolve(device),
                          torch.float32, torch.float32,
                          **tiny_tokenizers(cfgs))


def full_bundle(seed: int = 0, device=None, fill: bool = False
                ) -> FluxBundle:
    """Random full-width FLUX.1-dev deployment drawn on the device: the
    12B MMDiT (3072 hidden, 24x128 heads, 19 + 38 blocks) in bf16, T5-XXL,
    CLIP-L text, SigLIP so400m, Redux 1152->12288->4096 and the FLUX VAE
    (encoder and decoder) in f32 — about 46 GB. ``fill`` gives the
    FLUX.1-Fill-dev MMDiT (384 input channels)."""
    flux_cfg = flux_mod.FLUX_FILL_DEV if fill else flux_mod.FLUX_DEV
    cfgs = dict(flux_cfg=flux_cfg, vae_cfg=vae_mod.FLUX_VAE,
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


def redux_prior_pairs(bundle: FluxBundle, images: np.ndarray, prompt: str,
                      prompt_embeds_scale: Sequence[float],
                      pooled_prompt_embeds_scale: Sequence[float]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched K-image priors: images (N, K, S, S, 3) siglip-preprocessed,
    one shared prompt, scales (K,). Returns ((N, S_txt + S_img, D),
    (N, P)) — :func:`redux_prior_pairs_indexed` with every image its own
    entry."""
    images = np.asarray(images)
    n, k = images.shape[:2]
    return redux_prior_pairs_indexed(
        bundle, images.reshape((n * k,) + images.shape[2:]),
        np.arange(n * k).reshape(n, k), prompt, prompt_embeds_scale,
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

def _decode_tokens(vae_params, tokens, grid_h, grid_w, vae_cfg,
                   tiled: bool = False, tile: int = 96, overlap: int = 16):
    """Packed tokens -> (B, H, W, 3) image, the decode in f32."""
    lat = flux_mod.unpack_latents(tokens.float(), grid_h, grid_w)
    if tiled:
        return vae_mod.decode_tiled(vae_params, lat, vae_cfg, tile=tile,
                                    overlap=overlap)
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


def _denoise(bundle: FluxBundle, x: torch.Tensor, prompt_embeds, pooled,
             sigmas: torch.Tensor, guidance: float, grid_h: int,
             grid_w: int, timer: StepTimer,
             cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Euler loop over the MMDiT in ``compute_dtype``, one ``step``
    span per step. ``cond`` (the fill's conditioning tokens) joins the
    latents' channels at every call."""
    dev, dt = bundle.device, bundle.compute_dtype
    embeds = prompt_embeds.to(device=dev, dtype=dt)
    pooled_c = pooled.to(device=dev, dtype=dt)
    img_ids = torch.as_tensor(flux_mod.make_image_ids(grid_h, grid_w),
                              device=dev)
    txt_ids = torch.as_tensor(flux_mod.make_text_ids(embeds.shape[1]),
                              device=dev)
    b = x.shape[0]
    guid = torch.full((b,), float(guidance), dtype=torch.float32, device=dev)
    for i in range(sigmas.shape[0] - 1):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        with timer.span("step"):
            inp = x if cond is None else torch.cat([x, cond], dim=-1)
            v = flux_mod.apply(bundle.flux_params, inp, embeds, pooled_c,
                               sigma.expand(b), img_ids, txt_ids,
                               bundle.flux_cfg, guidance=guid)
            x = sched_mod.euler_step(x, v, sigma, sigma_next)
    return x


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
    x = _denoise(bundle, noise.to(device=dev, dtype=bundle.compute_dtype),
                 prompt_embeds, pooled, sigmas, guidance, grid_h, grid_w,
                 timer)
    with timer.span("decode"):
        return _decode_tokens(bundle.vae_params, x, grid_h, grid_w,
                              bundle.vae_cfg)


@torch.inference_mode()
def generate(bundle: FluxBundle, prompt_embeds: torch.Tensor,
             pooled: torch.Tensor, height: int, width: int,
             num_steps: int = 50, guidance: float = 2.5,
             seed=0,
             scheduler_overrides: Optional[dict] = None,
             mesh=None, data_axis: str = "data",
             pipe_axis: Optional[str] = None,
             microbatches: Optional[int] = None,
             block_cache_interval: int = 1,
             velocity_cache_interval: int = 1,
             velocity_cache_order: int = 1, *,
             noise: Optional[torch.Tensor] = None,
             timer: Optional[StepTimer] = None) -> np.ndarray:
    """Full text/Redux-to-image run. Returns (B, H, W, 3) uint8 when
    ``prompt_embeds`` is batched (B > 1), else (H, W, 3).

    Defaults mirror the background-gen stage (guidance 2.5, 50 steps,
    fixed seed). ``noise``: (B, S_img, 4*latent_channels) initial latents
    in place of the per-seed draw (how tests hand the JAX package's noise
    to the port). ``timer`` gets a ``step`` span per denoise step and a
    ``decode`` span. Images with a non-finite value before quantisation
    are counted in ``generate.nonfinite_images``. The parameters are the
    JAX package's, in its order and with its defaults; ``noise`` and
    ``timer`` are the port's own and keyword-only. Meshes, pipelining
    (``microbatches``) and the cache accelerators (``velocity_cache_order``
    too) are not part of this slice and raise when asked for;
    ``data_axis`` is read only by the mesh path."""
    if mesh is not None or pipe_axis is not None or microbatches is not None:
        raise NotImplementedError("meshes and pipelining are not ported")
    if block_cache_interval != 1 or velocity_cache_interval != 1 \
            or velocity_cache_order != 1:
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


def from_uint8(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) / 127.5 - 1.0


# ---------------------------------------------------------------------------
# fill (inpaint/outpaint composition)
# ---------------------------------------------------------------------------

def pack_mask(mask: torch.Tensor, vae_factor: int) -> torch.Tensor:
    """(B, H, W) binary mask (1 = repaint) -> (B, S, vae_factor^2 * 4)
    tokens: f x f pixel-unshuffle into channels, then 2x2 latent packing
    (diffusers FluxFillPipeline mask conditioning)."""
    b, h, w = mask.shape
    f = vae_factor
    x = mask.reshape(b, h // f, f, w // f, f).permute(0, 1, 3, 2, 4)
    return flux_mod.pack_latents(x.reshape(b, h // f, w // f, f * f))


def _fill_conditioning(vae_params, image, mask, noise, sigma0, vae_cfg,
                       tiled_vae: bool, vae_tile: int, vae_overlap: int,
                       timer: StepTimer):
    """-> (initial latents at sigma_0, conditioning tokens), both in the
    noise's dtype (the compute dtype). The image and mask arrive in it, so
    the VAE encode runs in it too; each encode is an ``encode`` span."""
    def enc(x):
        with timer.span("encode"):
            if tiled_vae:
                return vae_mod.encode_tiled(vae_params, x, vae_cfg,
                                            tile=vae_tile,
                                            overlap=vae_overlap)
            return vae_mod.encode(vae_params, x, vae_cfg)

    masked_tokens = flux_mod.pack_latents(enc(image * (1.0 - mask[..., None])))
    mask_tokens = pack_mask(mask, vae_cfg.spatial_factor)
    image_tokens = flux_mod.pack_latents(enc(image))
    # scale_noise works in f32; the denoise stream must come back to the
    # compute dtype (in the JAX package a promoted f32 stream once sent
    # the whole fill transformer to f32 and the unfused attention)
    latents = sched_mod.scale_noise(image_tokens, noise, sigma0).to(
        noise.dtype)
    cond = torch.cat([masked_tokens, mask_tokens], dim=-1).to(latents.dtype)
    return latents, cond


def _fill_float(bundle: FluxBundle, image: torch.Tensor, mask: torch.Tensor,
                noise: torch.Tensor, prompt_embeds, pooled,
                sigmas: torch.Tensor, guidance: float, hires: bool,
                vae_tile: int = 96, vae_overlap: int = 16,
                timer: Optional[StepTimer] = None) -> torch.Tensor:
    """The fill core -> (B, H, W, 3) f32 in [-1, 1]. ``image`` (B, H, W, 3)
    in [-1, 1], ``mask`` (B, H, W) 0/1 (1 = repaint) and ``noise``
    (B, S_img, 4*latent_channels), all in ``compute_dtype`` on the
    bundle's device; ``sigmas`` the strength-trimmed schedule. ``hires``
    runs the VAE encode and decode tiled. Spans: ``encode`` per encode,
    ``step`` per denoise step, ``decode``."""
    timer = timer or StepTimer()
    lf = bundle.latent_factor
    grid_h, grid_w = image.shape[1] // lf, image.shape[2] // lf
    latents, cond = _fill_conditioning(
        bundle.vae_params, image, mask, noise, sigmas[0], bundle.vae_cfg,
        hires, vae_tile, vae_overlap, timer)
    x = _denoise(bundle, latents, prompt_embeds, pooled, sigmas, guidance,
                 grid_h, grid_w, timer, cond=cond)
    with timer.span("decode"):
        return _decode_tokens(bundle.vae_params, x, grid_h, grid_w,
                              bundle.vae_cfg, hires, vae_tile, vae_overlap)


def fill(bundle: FluxBundle, image: np.ndarray, mask: np.ndarray,
         prompt_embeds: torch.Tensor, pooled: torch.Tensor,
         num_steps: int = 50, guidance: float = 30.0,
         strength: float = 0.75, seed: int = 0) -> np.ndarray:
    """Flux-Fill outpaint. image (H, W, 3) uint8; mask (H, W) uint8 with
    255 = repaint, 0 = keep (the compose-stage keep-mask,
    outpainting_updown_sampling_redux.py:836-870). Returns uint8 image."""
    return fill_batch(bundle, image[None],
                      np.broadcast_to(mask, (1,) + mask.shape),
                      prompt_embeds, pooled, num_steps=num_steps,
                      guidance=guidance, strength=strength, seeds=[seed])[0]


@torch.inference_mode()
def fill_batch(bundle: FluxBundle, images: np.ndarray, masks: np.ndarray,
               prompt_embeds: torch.Tensor, pooled: torch.Tensor,
               num_steps: int = 50, guidance: float = 30.0,
               strength: float = 0.75,
               seeds: Sequence[int] = (0,),
               mesh=None, data_axis: str = "data",
               pipe_axis: Optional[str] = None,
               microbatches: Optional[int] = None,
               hires_threshold_px: int = 2048 * 2048,
               vae_tile: int = 96, vae_overlap: int = 16,
               velocity_cache_interval: int = 1,
               velocity_cache_order: int = 1,
               vcache_divergence_budget: float = 0.05, *,
               noise: Optional[torch.Tensor] = None,
               timer: Optional[StepTimer] = None) -> np.ndarray:
    """Batched Fill over same-shape samples: images (B, H, W, 3) uint8,
    masks (B, H, W) uint8 (255 = repaint), prompt_embeds (B, S, D), pooled
    (B, P), one seed per row. Returns (B, H, W, 3) uint8.

    ``strength`` trims the schedule: the denoise starts from the image
    latents noised to the first kept sigma. At ``hires_threshold_px``
    pixels and above (the reference's >= 2048 px upscale / <= 2800 px
    cap, outpainting_updown_sampling_redux.py:72-82,104-108) the VAE runs
    tiled (``vae_tile``/``vae_overlap`` latent cells). ``noise``:
    (B, S_img, 4*latent_channels) in place of the per-seed draw, as in
    :func:`generate`; ``timer`` gets the spans of :func:`_fill_float`.
    Images with a non-finite value before quantisation are counted in
    ``fill_batch.nonfinite_images``. The parameters are the JAX package's,
    in its order and with its defaults; ``noise`` and ``timer`` are the
    port's own and keyword-only. Meshes, pipelining (``microbatches``) and
    the velocity cache (``velocity_cache_order`` too) are not ported and
    raise when asked for; ``data_axis`` and ``vcache_divergence_budget``
    are read only by those paths."""
    if mesh is not None or pipe_axis is not None or microbatches is not None:
        raise NotImplementedError("meshes and pipelining are not ported")
    if velocity_cache_interval != 1 or velocity_cache_order != 1:
        raise NotImplementedError("the velocity cache is not ported")
    dev, dt = bundle.device, bundle.compute_dtype
    b, h, w = images.shape[:3]
    lf = bundle.latent_factor
    seq = (h // lf) * (w // lf)
    hires = hires_threshold_px > 0 and h * w >= hires_threshold_px
    schedule = sched_mod.make_schedule(num_steps, image_seq_len=seq,
                                       strength=strength)
    img = torch.as_tensor(from_uint8(np.asarray(images)), device=dev).to(dt)
    m = torch.as_tensor((np.asarray(masks, np.float32) / 255.0) > 0.5,
                        device=dev).to(dt)
    if noise is None:
        noise = _noise(bundle, seeds, seq, bundle.vae_cfg.latent_channels * 4)
    out = _fill_float(
        bundle, img, m, noise.to(device=dev, dtype=dt), prompt_embeds,
        pooled, torch.as_tensor(schedule.sigmas, dtype=torch.float32,
                                device=dev),
        guidance, hires, vae_tile, vae_overlap, timer).float().cpu().numpy()
    fill_batch.nonfinite_images += int((~np.isfinite(out)).any(
        axis=(1, 2, 3)).sum())
    return to_uint8(out)


fill_batch.nonfinite_images = 0
