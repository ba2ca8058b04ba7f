"""Flux text/Redux-conditioned generation and Flux-Fill — the serving
paths of stages 3 and 4 (port of ``domainrag_tpu/models/flux/pipeline.py``).

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
``set_int8_pv``.

The denoise caches: the velocity cache (:func:`_vcache_denoise`; an
interval, an anchor tuple, ``"auto"`` or ``"sched:K"``) on both paths,
and the block-residual cache (``model.apply_with_cache``) on
``generate``, with their one-time calibrations. The JAX static unroll and
tail mask of the cached loop is a plain loop over each group's steps
here. The noise per seed and the calibrations' probe latents are the
JAX package's draws from ``PRNGKey(seed)`` (``core.prng``).

Scale-out (``parallel/``): ``generate`` and ``fill_batch`` take the JAX
package's ``mesh`` / ``data_axis`` / ``pipe_axis`` / ``microbatches``
(data parallel, sequence parallel in the hires fill, pipelined depth),
and a bundle from ``parallel.deploy.shard_bundle`` runs tensor-parallel.
Every rank of the mesh makes the same call and returns the whole result.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...core import device as device_mod
from ...core import prng
from ...core import text as text_util
from ...core.log import StepTimer, get_logger
from .. import clip as clip_mod
from .. import redux as redux_mod
from .. import siglip as siglip_mod
from .. import t5 as t5_mod
from ..common import leaves
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
    # the port's own: the device every tensor of the bundle lives on
    device: torch.device = dataclasses.field(default=torch.device("cuda"),
                                             kw_only=True)
    # set by parallel.deploy.shard_bundle: the MMDiT holds this rank's
    # tensor-parallel share over this mesh's axis (ops.attention.tp_attention)
    tp_mesh: Optional[object] = None
    tp_axis: str = "model"
    # per-prompt (t5_embeds (1, S, D), clip_pooled (1, P)) cache filled by
    # :func:`precompute_prompts`; once every prompt a run uses is cached,
    # the T5 / CLIP-text params may be released
    # (:func:`release_text_encoders`)
    prompt_cache: Optional[dict] = None

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


def _random_bundle(cfgs: dict, key, dev: torch.device,
                   flux_dtype: torch.dtype, compute_dtype: torch.dtype,
                   **extra) -> FluxBundle:
    """Random weights drawn on ``dev`` by the port's inits from ``key``,
    split in six as the JAX ``tiny_bundle``
    splits it: the MMDiT, the VAE, T5, the CLIP text tower, SigLIP and
    Redux, in that order. The MMDiT is stored in ``flux_dtype`` (JAX's
    f32 leaves rounded); the towers and the VAE in f32, the dtypes they
    run in."""
    ks = prng.split(key.to(dev), 6)
    return FluxBundle(
        flux_params=flux_mod.init(ks[0], cfgs["flux_cfg"], dtype=flux_dtype),
        vae_params=vae_mod.init(ks[1], cfgs["vae_cfg"]),
        t5_params=t5_mod.init(ks[2], cfgs["t5_cfg"]),
        clip_text_params=clip_mod.init_text(ks[3], cfgs["clip_text_cfg"]),
        siglip_params=siglip_mod.init(ks[4], cfgs["siglip_cfg"]),
        redux_params=redux_mod.init(ks[5], cfgs["redux_cfg"]),
        compute_dtype=compute_dtype, device=dev, **cfgs, **extra)


def _bundle_key(key, name: str):
    return prng.PRNGKey(0) if key is None else prng.check_key(key, name)


def tiny_bundle(key=None, fill: bool = False, *, device=None
                ) -> FluxBundle:
    """Random tiny bundle (f32 compute) on ``device`` (the card unless
    ``device="cpu"``); a Flux-Fill one with ``fill``. The JAX
    ``tiny_bundle``'s trees from the same key (``None``: ``PRNGKey(0)``),
    the key moved to ``device`` and every leaf drawn there."""
    cfgs = tiny_configs(fill)
    return _random_bundle(cfgs, _bundle_key(key, "tiny_bundle"),
                          device_mod.resolve(device),
                          torch.float32, torch.float32,
                          **tiny_tokenizers(cfgs))


def full_bundle(key=None, fill: bool = False, *, device=None
                ) -> FluxBundle:
    """Random full-width FLUX.1-dev deployment drawn on the device: the
    12B MMDiT (3072 hidden, 24x128 heads, 19 + 38 blocks) in bf16, T5-XXL,
    CLIP-L text, SigLIP so400m, Redux 1152->12288->4096 and the FLUX VAE
    (encoder and decoder) in f32 — about 46 GB. ``fill`` gives the
    FLUX.1-Fill-dev MMDiT (384 input channels). ``key`` (``None``:
    ``PRNGKey(0)``) is split and drawn as in :func:`tiny_bundle`, through
    the same inits: the MMDiT's leaves are JAX's f32 draws rounded to
    bf16."""
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
    return _random_bundle(cfgs, _bundle_key(key, "full_bundle"),
                          device_mod.resolve(device), torch.bfloat16,
                          torch.bfloat16, **tokenizers)


# ---------------------------------------------------------------------------
# prompt + prior encoding
# ---------------------------------------------------------------------------

def encode_prompt(bundle: FluxBundle, prompts: Sequence[str], *,
                  timer: Optional[StepTimer] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T5 embeds (N, S, D_t5), CLIP pooled (N, D_clip)) per prompt, f32.

    Consults ``bundle.prompt_cache`` first: when every prompt is cached
    the text towers never run (and may have been released —
    :func:`release_text_encoders`). When they run, the tokenizers and
    both towers are a ``prior/text`` span of ``timer``."""
    cache = bundle.prompt_cache
    if cache is not None and all(p in cache for p in prompts):
        return (torch.cat([cache[p][0] for p in prompts]),
                torch.cat([cache[p][1] for p in prompts]))
    if bundle.t5_params is None:
        missing = [p for p in prompts
                   if cache is None or p not in cache]
        raise ValueError(
            f"text encoders released but prompts not in the cache: "
            f"{missing!r} — precompute_prompts() them first")
    with (timer or StepTimer()).span("prior/text"):
        t5_ids = text_util.batch_tokenize(bundle.t5_tokenizer, prompts,
                                          bundle.t5_max_len)
        clip_ids = text_util.batch_tokenize(bundle.clip_tokenizer, prompts,
                                            bundle.clip_max_len)
        dev = bundle.device
        t5_out = t5_mod.apply(bundle.t5_params,
                              torch.as_tensor(t5_ids, device=dev),
                              bundle.t5_cfg)
        _, pooled = clip_mod.apply_text(bundle.clip_text_params,
                                        torch.as_tensor(clip_ids, device=dev),
                                        bundle.clip_text_cfg)
    return t5_out, pooled


@torch.inference_mode()
def precompute_prompts(bundle: FluxBundle,
                       prompts: Sequence[str]) -> None:
    """Fill ``bundle.prompt_cache`` for ``prompts`` (each encoded once).
    After this, :func:`release_text_encoders` can drop the T5/CLIP-text
    params and every prior/denoise call that sticks to these prompts works
    unchanged."""
    if bundle.prompt_cache is None:
        bundle.prompt_cache = {}
    for p in prompts:
        if p not in bundle.prompt_cache:
            bundle.prompt_cache[p] = encode_prompt(bundle, [p])


def release_text_encoders(bundle: FluxBundle) -> None:
    """Drop the T5 + CLIP-text params (device memory frees once no other
    reference holds them). Prompt encoding afterwards requires a
    :func:`precompute_prompts` cache hit."""
    bundle.t5_params = None
    bundle.clip_text_params = None


def _image_tokens(bundle: FluxBundle, images: np.ndarray, *,
                  timer: Optional[StepTimer] = None) -> torch.Tensor:
    """SigLIP + Redux tokens of preprocessed images; the copy to the
    device and both towers are a ``prior/image`` span of ``timer``."""
    if bundle.siglip_params is None:
        raise ValueError("bundle lacks Redux weights")
    with (timer or StepTimer()).span("prior/image"):
        x = torch.as_tensor(np.asarray(images, np.float32),
                            device=bundle.device)
        sig = siglip_mod.apply(bundle.siglip_params, x, bundle.siglip_cfg)
        return redux_mod.apply(bundle.redux_params, sig)


def redux_prior(bundle: FluxBundle, images: np.ndarray,
                prompts: Sequence[str],
                prompt_embeds_scale: Sequence[float],
                pooled_prompt_embeds_scale: Sequence[float], *,
                timer: Optional[StepTimer] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (N, S, S, 3) siglip-preprocessed -> fused
    ((1, S_txt + S_img, D), (1, P)). ``timer`` (the port's own) gets the
    ``prior/text`` and ``prior/image`` spans."""
    txt, pooled = encode_prompt(bundle, prompts, timer=timer)
    return redux_mod.combine_prior(txt, pooled,
                                   _image_tokens(bundle, images, timer=timer),
                                   prompt_embeds_scale,
                                   pooled_prompt_embeds_scale)


def redux_prior_pairs(bundle: FluxBundle, images: np.ndarray, prompt: str,
                      prompt_embeds_scale: Sequence[float],
                      pooled_prompt_embeds_scale: Sequence[float], *,
                      timer: Optional[StepTimer] = None
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
        pooled_prompt_embeds_scale, timer=timer)


def redux_prior_pairs_indexed(bundle: FluxBundle,
                              unique_images: np.ndarray,
                              pair_idx: np.ndarray,
                              prompt: str,
                              prompt_embeds_scale: Sequence[float],
                              pooled_prompt_embeds_scale: Sequence[float],
                              *, timer: Optional[StepTimer] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dual-image priors with the SigLIP tower run once per UNIQUE image
    and the per-pair embeddings gathered by index. ``unique_images``
    (U, S, S, 3); ``pair_idx`` (N, K) indices into it. The text encoders
    run once for the shared prompt. Returns ((N, S_txt + S_img, D),
    (N, P)). ``timer`` (the port's own) gets a ``prior/text`` span where
    the text towers run and a ``prior/image`` span."""
    pair_idx = np.asarray(pair_idx)
    n, k = pair_idx.shape
    txt1, pooled1 = encode_prompt(bundle, [prompt], timer=timer)
    txt = txt1[:, None].expand((n, k) + tuple(txt1.shape[1:]))
    pooled = pooled1[:, None].expand((n, k) + tuple(pooled1.shape[1:]))
    img_unique = _image_tokens(bundle, unique_images,
                               timer=timer)                # (U, S_i, D)
    img_embeds = img_unique[torch.as_tensor(pair_idx, device=bundle.device)]
    return redux_mod.combine_prior_pairs(txt, pooled, img_embeds,
                                         prompt_embeds_scale,
                                         pooled_prompt_embeds_scale)


# ---------------------------------------------------------------------------
# generation (text/Redux -> image)
# ---------------------------------------------------------------------------

def _decode_tokens(vae_params, tokens, grid_h, grid_w, vae_cfg,
                   tiled: bool = False, tile: int = 96, overlap: int = 16):
    """Packed tokens -> (B, H, W, 3) image, the decode in f32. Untiled,
    one image at a time, in the same time: a batch's full-resolution
    activations would stand above the denoise's peak memory (5 images at
    1024 px take 21.5 GB above the weights on an H100, one image under
    3.3 GB)."""
    lat = flux_mod.unpack_latents(tokens.float(), grid_h, grid_w)
    if tiled:
        return vae_mod.decode_tiled(vae_params, lat, vae_cfg, tile=tile,
                                    overlap=overlap)
    return torch.cat([vae_mod.decode(vae_params, one, vae_cfg)
                      for one in lat.split(1)])


def _noise(bundle: FluxBundle, seeds: Sequence[int], seq: int, c: int
           ) -> torch.Tensor:
    """(B, seq, c) f32 standard normal on the bundle's device, the JAX
    package's draw per seed: ``normal(PRNGKey(s), (seq, c), f32)``."""
    return torch.stack([
        prng.normal(prng.PRNGKey(s, device=bundle.device), (seq, c),
                    torch.float32)
        for s in seeds])


def _model_inputs(bundle: FluxBundle, prompt_embeds, pooled,
                  grid_h: int, grid_w: int):
    """(embeds, pooled) in ``compute_dtype`` and the RoPE ids, on the
    bundle's device."""
    dev, dt = bundle.device, bundle.compute_dtype
    embeds = prompt_embeds.to(device=dev, dtype=dt)
    img_ids = torch.as_tensor(flux_mod.make_image_ids(grid_h, grid_w),
                              device=dev)
    txt_ids = torch.as_tensor(flux_mod.make_text_ids(embeds.shape[1]),
                              device=dev)
    return embeds, pooled.to(device=dev, dtype=dt), img_ids, txt_ids


def _guidance(bundle: FluxBundle, guidance: float, b: int) -> torch.Tensor:
    return torch.full((b,), float(guidance), dtype=torch.float32,
                      device=bundle.device)


def _model_fn(bundle: FluxBundle, prompt_embeds, pooled, guidance: float,
              grid_h: int, grid_w: int,
              cond: Optional[torch.Tensor] = None, *, pipe=None):
    """``model_fn(x, sigma)`` -> velocity: the MMDiT in ``compute_dtype``
    on the prompt's conditioning (the JAX ``_dense_model_fn``). ``cond``
    (the fill's conditioning tokens) joins the latents' channels at every
    call. ``pipe`` (:func:`_pipe`): the blocks pipelined over a mesh
    axis instead (the JAX ``_pp_model_fn``)."""
    embeds, pooled_c, img_ids, txt_ids = _model_inputs(
        bundle, prompt_embeds, pooled, grid_h, grid_w)

    def model_fn(x, sigma):
        b = x.shape[0]
        inp = x if cond is None else torch.cat([x, cond], dim=-1)
        if pipe is not None:
            from ...parallel import pipeline_parallel as pp
            stages, mesh, axis, microbatches = pipe
            return pp.pipelined_apply(
                bundle.flux_params, stages, inp, embeds, pooled_c,
                sigma.expand(b), img_ids, txt_ids, bundle.flux_cfg, mesh,
                axis, guidance=_guidance(bundle, guidance, b),
                microbatches=microbatches)
        return flux_mod.apply(
            bundle.flux_params, inp, embeds, pooled_c, sigma.expand(b),
            img_ids, txt_ids, bundle.flux_cfg,
            guidance=_guidance(bundle, guidance, b))

    return model_fn


def _euler_denoise(model_fn, latents, sigmas, *, timer: StepTimer):
    """The dense Euler loop, one ``step`` span per step."""
    x = latents
    for i in range(sigmas.shape[0] - 1):
        with timer.span("step"):
            x = sched_mod.euler_step(x, model_fn(x, sigmas[i]), sigmas[i],
                                     sigmas[i + 1])
    return x


def _vcache_denoise(model_fn, latents, sigmas, interval: int,
                    order: int = 1, anchors=None, *,
                    timer: Optional[StepTimer] = None):
    """Velocity-extrapolation cached Euler denoise (VDE family,
    ``PAPERS.md``): the network runs only at the anchor steps (every
    ``interval``-th, or the explicit ``anchors``, which must start at 0);
    the other steps of a group integrate a velocity extrapolated from the
    group's computed velocity and the previous group's (``order=1``:
    linear in sigma; ``order=0``: hold). The first group has no previous
    sample and holds (zero slope). Each Euler step is one ``step`` span of
    ``timer``; a group's model call falls in its first step's span."""
    timer = timer or StepTimer()
    n = int(sigmas.shape[0]) - 1
    if anchors is None:
        anchors = tuple(range(0, n, int(interval)))
    else:
        anchors = tuple(sorted({int(a) for a in anchors}))
        if not anchors or anchors[0] != 0 or anchors[-1] >= n:
            raise ValueError(
                f"velocity-cache anchors must start at step 0 and stay "
                f"below the last step index {n}: got {anchors}")
    bounds = anchors + (n,)
    x = latents
    v_prev = torch.zeros(latents.shape, dtype=torch.float32,
                         device=latents.device)
    s_prev = sigmas[0].float()
    for i0, i_end in zip(bounds, bounds[1:]):
        s0 = sigmas[i0]
        slope = None
        for i in range(i0, i_end):
            with timer.span("step"):
                if i == i0:
                    v0 = model_fn(x, s0).float()
                    if order >= 1:
                        # a multiply by the f32 reciprocal (not a division),
                        # and a zero slope where the anchors coincide
                        d = s0 - s_prev
                        recip = torch.where(d == 0.0, torch.zeros_like(d),
                                            1.0 / torch.where(
                                                d == 0.0,
                                                torch.ones_like(d), d))
                        slope = (v0 - v_prev) * recip
                s_i = sigmas[i]
                v = v0 if slope is None else v0 + (s_i - s0) * slope
                x = sched_mod.euler_step(x, v, s_i, sigmas[i + 1])
        v_prev, s_prev = v0, s0
    return x


def _pick_denoise(model_fn, latents, sigmas, vcache_interval,
                  vcache_order: int, *, timer: Optional[StepTimer] = None):
    """``vcache_interval``: 1 = dense Euler; int N > 1 = uniform velocity
    cache; tuple = explicit (possibly non-uniform) anchor schedule."""
    timer = timer or StepTimer()
    if isinstance(vcache_interval, tuple):
        return _vcache_denoise(model_fn, latents, sigmas, interval=0,
                               order=vcache_order, anchors=vcache_interval,
                               timer=timer)
    if vcache_interval <= 1:
        return _euler_denoise(model_fn, latents, sigmas, timer=timer)
    return _vcache_denoise(model_fn, latents, sigmas,
                           interval=vcache_interval, order=vcache_order,
                           timer=timer)


def _vc_active(vcache_interval) -> bool:
    """True when the velocity cache is on, for int / tuple / 'auto' /
    'sched:K' forms alike (before or after resolution)."""
    if isinstance(vcache_interval, tuple):
        return len(vcache_interval) > 0
    if isinstance(vcache_interval, str):
        return True                     # "auto" / "sched:K" may resolve >1
    return vcache_interval > 1


def _denoise_latents(bundle: FluxBundle, latents: torch.Tensor,
                     prompt_embeds, pooled, sigmas: torch.Tensor,
                     guidance: float, grid_h: int, grid_w: int,
                     cache_interval: int = 1, vcache_interval=1,
                     vcache_order: int = 1, *,
                     cond: Optional[torch.Tensor] = None,
                     timer: Optional[StepTimer] = None,
                     pipe=None) -> torch.Tensor:
    """The denoise without the VAE decode, one ``step`` span per Euler
    step: the dense or velocity-cached loop (:func:`_pick_denoise`), or,
    with ``cache_interval`` > 1, the block-residual cache — every block
    runs at the steps ``i % cache_interval == 0`` and replays its residual
    at the others (the JAX ``_generate_core_cached`` loop). Also the
    calibrations' probe. ``pipe``: the pipelined model (:func:`_pipe`)."""
    timer = timer or StepTimer()
    if cache_interval <= 1:
        model_fn = _model_fn(bundle, prompt_embeds, pooled, guidance,
                             grid_h, grid_w, cond, pipe=pipe)
        return _pick_denoise(model_fn, latents, sigmas, vcache_interval,
                             vcache_order, timer=timer)
    embeds, pooled_c, img_ids, txt_ids = _model_inputs(
        bundle, prompt_embeds, pooled, grid_h, grid_w)
    b = latents.shape[0]
    guid = _guidance(bundle, guidance, b)
    cache = flux_mod.init_block_cache(bundle.flux_cfg, b, latents.shape[1],
                                      embeds.shape[1], dtype=latents.dtype,
                                      device=bundle.device)
    x = latents
    for i in range(sigmas.shape[0] - 1):
        with timer.span("step"):
            v, cache = flux_mod.apply_with_cache(
                bundle.flux_params, x, embeds, pooled_c, sigmas[i].expand(b),
                img_ids, txt_ids, bundle.flux_cfg, cache,
                refresh=i % cache_interval == 0, guidance=guid)
            x = sched_mod.euler_step(x, v, sigmas[i], sigmas[i + 1])
    return x


def _generate_float(bundle: FluxBundle, prompt_embeds: torch.Tensor,
                    pooled: torch.Tensor, height: int, width: int,
                    num_steps: int, guidance: float, noise: torch.Tensor,
                    scheduler_overrides: Optional[dict] = None,
                    timer: Optional[StepTimer] = None, *,
                    cache_interval: int = 1, vcache_interval=1,
                    vcache_order: int = 1, pipe=None) -> torch.Tensor:
    """The denoise + decode core (the JAX ``_generate_core``,
    ``_generate_core_cached`` and, with ``pipe``, ``_generate_core_pp``)
    -> (B, H, W, 3) f32 in [-1, 1]. Each denoise step is a ``step`` span
    of ``timer``, the decode a ``decode`` span."""
    timer = timer or StepTimer()
    dev = bundle.device
    lf = bundle.latent_factor
    grid_h, grid_w = height // lf, width // lf
    schedule = sched_mod.make_schedule(
        num_steps, image_seq_len=grid_h * grid_w,
        **(scheduler_overrides or {}))
    sigmas = torch.as_tensor(schedule.sigmas, dtype=torch.float32, device=dev)
    x = _denoise_latents(
        bundle, noise.to(device=dev, dtype=bundle.compute_dtype),
        prompt_embeds, pooled, sigmas, guidance, grid_h, grid_w,
        cache_interval, vcache_interval, vcache_order, timer=timer,
        pipe=pipe)
    with timer.span("decode"):
        return _decode_tokens(bundle.vae_params, x, grid_h, grid_w,
                              bundle.vae_cfg)


def _device_memory_bytes(device: torch.device) -> Optional[int]:
    """The card's memory, the block cache's budget; None on the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory


def _check_block_cache_hbm(bundle: FluxBundle, batch: int, s_img: int,
                           s_txt: int, mesh, data_axis: str) -> None:
    """Block caching holds one residual per block per sample in the
    latents' dtype (57 x 5337 x 3072 bf16 = 1.87 GB per sample for the
    12B at 1024 px), times the serving batch. Warn when that and the
    MMDiT's weights exceed the card's memory, before the allocation
    fails. ``mesh`` and ``data_axis`` are the JAX parameters; one card
    serves the whole batch."""
    budget = _device_memory_bytes(bundle.device)
    if budget is None:
        return
    cfg = bundle.flux_cfg
    itemsize = torch.empty((), dtype=bundle.compute_dtype).element_size()
    cache_bytes = ((cfg.depth_double + cfg.depth_single) * batch
                   * (s_img + s_txt) * cfg.hidden * itemsize)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in leaves(bundle.flux_params)
                      if isinstance(t, torch.Tensor))
    if cache_bytes + param_bytes > budget:
        get_logger("domainrag_tpu_torch.flux").warning(
            "block_cache_interval>1: estimated device memory %.1f GB "
            "(residual cache %.1f GB for batch %d + weights %.1f GB) "
            "exceeds the card's %.1f GB — expect an out-of-memory error; "
            "reduce the rank batch or disable block caching",
            (cache_bytes + param_bytes) / 1e9, cache_bytes / 1e9, batch,
            param_bytes / 1e9, budget / 1e9)


# ---------------------------------------------------------------------------
# cache calibrations (one-time per model, resolution and steps; cached
# process-wide, keyed by :func:`_params_token`)
# ---------------------------------------------------------------------------

_BLOCK_CACHE_CALIBRATIONS: dict = {}
_VCACHE_SCHEDULES: dict = {}
_FILL_VCACHE_CALIBRATIONS: dict = {}


def _params_token(bundle: FluxBundle):
    """Identity token of ``bundle.flux_params``, new whenever any leaf
    tensor is swapped (a weakref per leaf: ``quantize_tree`` keeps some
    tensors, so one leaf is not enough). The calibration caches key on
    the token, which they hold, so a later model whose params reuse an
    ``id`` cannot inherit an old calibration."""
    import weakref
    tensors = leaves(bundle.flux_params)
    entry = getattr(bundle, "_calib_token", None)
    if entry is not None and len(entry[0]) == len(tensors) and \
            all(r() is t for r, t in zip(entry[0], tensors)):
        return entry[1]
    token = object()
    bundle._calib_token = ([weakref.ref(t) for t in tensors], token)
    return token


def _probe_inputs(bundle: FluxBundle, prompt_embeds, pooled, height: int,
                  width: int, num_steps: int, seed: int, probe_noise):
    """A calibration's single-sample probe: (latents (1, S, C) in
    ``compute_dtype``, embeds, pooled, sigmas, grid_h, grid_w). The latents
    are ``probe_noise`` when given, else the per-seed draw of :func:`_noise`
    (JAX's ``normal(PRNGKey(seed), (1, S, C), f32)``)."""
    dev, dt = bundle.device, bundle.compute_dtype
    lf = bundle.latent_factor
    grid_h, grid_w = height // lf, width // lf
    schedule = sched_mod.make_schedule(num_steps,
                                       image_seq_len=grid_h * grid_w)
    if probe_noise is None:
        probe_noise = _noise(bundle, [seed], grid_h * grid_w,
                             bundle.vae_cfg.latent_channels * 4)
    latents = probe_noise.to(device=dev, dtype=torch.float32).to(dt)
    e = prompt_embeds[:1].to(device=dev, dtype=dt)
    p = pooled[:1].to(device=dev, dtype=dt)
    sig = torch.as_tensor(schedule.sigmas, dtype=torch.float32, device=dev)
    return latents, e, p, sig, grid_h, grid_w


def _check_budget_space(budget_space: str) -> None:
    if budget_space not in ("image", "latent"):
        raise ValueError(f"budget_space must be 'image' or 'latent': "
                         f"{budget_space!r}")


def _host(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


@torch.inference_mode()
def calibrate_block_cache_interval(bundle: FluxBundle,
                                   prompt_embeds: torch.Tensor,
                                   pooled: torch.Tensor,
                                   height: int, width: int,
                                   num_steps: int, guidance: float,
                                   seed: int = 0,
                                   divergence_budget: float = 0.05,
                                   candidates=(4, 3, 2),
                                   mode: str = "residual",
                                   budget_space: str = "image", *,
                                   probe_noise: Optional[torch.Tensor] = None
                                   ) -> int:
    """The largest cache interval whose relative L2 divergence from the
    exact denoise stays within ``divergence_budget``, 1 when none does.
    ``mode``: "residual" calibrates the block-residual cache, "velocity"
    the velocity cache. ``budget_space``: "image" compares the
    VAE-decoded probe images, "latent" the final latents; the log records
    both curves. One exact and up to ``len(candidates)`` cached denoises
    of one sample at the call's own config. ``probe_noise`` (1, S, C):
    the probe's latents in place of the per-seed draw."""
    if mode not in ("residual", "velocity"):
        raise ValueError(f"mode must be 'residual' or 'velocity': {mode!r}")
    _check_budget_space(budget_space)
    latents, e, p, sig, grid_h, grid_w = _probe_inputs(
        bundle, prompt_embeds, pooled, height, width, num_steps, seed,
        probe_noise)

    def probe(interval: int):
        kw = ({"cache_interval": interval} if mode == "residual"
              else {"vcache_interval": interval})
        lat = _denoise_latents(bundle, latents, e, p, sig, guidance, grid_h,
                               grid_w, **kw)
        img = _decode_tokens(bundle.vae_params, lat, grid_h, grid_w,
                             bundle.vae_cfg)
        return _host(lat), _host(img)

    exact_lat, exact_img = probe(1)
    norms = {"latent": float(np.linalg.norm(exact_lat)) or 1.0,
             "image": float(np.linalg.norm(exact_img)) or 1.0}
    curve: dict = {}
    chosen = 1
    for interval in sorted(candidates, reverse=True):
        lat, img = probe(int(interval))
        rel = {"latent": float(np.linalg.norm(lat - exact_lat))
               / norms["latent"],
               "image": float(np.linalg.norm(img - exact_img))
               / norms["image"]}
        curve[int(interval)] = rel
        if rel[budget_space] <= divergence_budget and chosen == 1:
            chosen = int(interval)
    get_logger("domainrag_tpu_torch.flux").info(
        "%s-cache calibration @%dx%d/%d steps: divergence %s, budget "
        "%.3f on %s -> interval %d", mode, width, height, num_steps,
        {k: {s: round(v2, 4) for s, v2 in v.items()}
         for k, v in sorted(curve.items())},
        divergence_budget, budget_space, chosen)
    return chosen


def _record_velocities(bundle: FluxBundle, latents, prompt_embeds, pooled,
                       sigmas, guidance: float, grid_h: int, grid_w: int, *,
                       cond: Optional[torch.Tensor] = None):
    """Dense Euler denoise that returns (final latents, per-step
    velocities (n, *latents.shape) f32): the probe that
    :func:`plan_vcache_anchors` and the schedule selection read."""
    model_fn = _model_fn(bundle, prompt_embeds, pooled, guidance, grid_h,
                         grid_w, cond)
    x, vs = latents, []
    for i in range(sigmas.shape[0] - 1):
        v = model_fn(x, sigmas[i]).float()
        x = sched_mod.euler_step(x, v, sigmas[i], sigmas[i + 1])
        vs.append(v)
    return x, torch.stack(vs)


def plan_vcache_anchors(velocities: np.ndarray, sigmas: np.ndarray,
                        n_anchors: int, order: int = 1) -> tuple:
    """Optimal anchor placement for the velocity cache under the
    frozen-field surrogate, as an exact dynamic program (own copy of the
    JAX package's numpy planner).

    The recorded dense velocities ``v_i`` stand for the field along the
    trajectory; the cached integrator's final-state error is then
    sum_i ds_i (v_used_i - v_i), and the DP over consecutive anchor pairs
    minimizes the additive relaxation sum_i ds_i^2 ||v_used_i - v_i||^2
    exactly (the order-1 slope couples each group to the previous anchor).
    Every inner product reduces to the velocities' Gram matrix.

    Returns a strictly increasing tuple starting at 0 with ``n_anchors``
    entries (the model-call count)."""
    v = np.asarray(velocities, np.float64)
    n = v.shape[0]
    if not 1 <= n_anchors <= n:
        raise ValueError(f"n_anchors must be in [1, {n}]: {n_anchors}")
    v = v.reshape(n, -1)
    s = np.asarray(sigmas, np.float64)[:n]
    w = np.square(np.diff(np.asarray(sigmas, np.float64)[:n + 1]))
    gram = v @ v.T

    # the prefix sums over steps i >= a of w_i ||v_used_i - v_i||^2 with
    # anchor a and previous anchor p (p == a: the first group's hold)
    def _cum(p, a):
        idx = np.arange(a, n)
        if order >= 1 and p != a:
            t = (s[idx] - s[a]) / (s[a] - s[p])
        else:
            t = np.zeros(len(idx))
        al = 1.0 + t
        e2 = (al * al * gram[a, a] + t * t * gram[p, p]
              + gram[idx, idx] - 2.0 * al * t * gram[a, p]
              - 2.0 * al * gram[a, idx] + 2.0 * t * gram[p, idx])
        c = np.zeros(n + 1 - a)
        np.cumsum(np.maximum(e2, 0.0) * w[idx], out=c[1:])
        return c

    cums: dict = {}

    def cost(p, a, b):                      # group [a, b) under (p, a)
        c = cums.get((p, a))
        if c is None:
            c = cums[(p, a)] = _cum(p, a)
        return c[b - a]

    # f[(p, a)]: the best cost of the steps before a, with the last two
    # anchors (p, a)
    inf = float("inf")
    f = {(0, 0): 0.0}
    parent: dict = {}
    for g in range(1, n_anchors):
        nxt: dict = {}
        for (p, a), val in f.items():
            for b_ in range(a + 1, n - (n_anchors - g) + 1):
                cand = val + cost(p, a, b_)
                if cand < nxt.get((a, b_), inf):
                    nxt[(a, b_)] = cand
                    parent[(g, a, b_)] = p
        f = nxt
    best, best_pa = inf, None
    for (p, a), val in f.items():
        total = val + cost(p, a, n)
        if total < best:
            best, best_pa = total, (p, a)
    anchors = []
    p, a = best_pa
    for g in range(n_anchors - 1, 0, -1):
        anchors.append(a)
        p, a = parent[(g, p, a)], p
    anchors.append(0)
    return tuple(sorted(anchors))


def select_vcache_anchors(vs, sigmas, n_anchors: int, interval: int,
                          probe_fn, decode_fn, exact_final,
                          log_tag: str = "") -> tuple:
    """The ``sched:K`` schedule by image-space divergence: the latent-DP
    optimum (:func:`plan_vcache_anchors`) against the uniform-``interval``
    schedule at the same model-call count, each scored by one real cached
    probe (``probe_fn(anchors)`` -> final latent tokens) decoded by
    ``decode_fn`` against the dense probe's ``exact_final``; the smaller
    image relative L2 wins (uniform as its explicit tuple). No probe runs
    when the two schedules coincide."""
    n = len(np.asarray(sigmas)) - 1
    dp = plan_vcache_anchors(np.asarray(vs, np.float32),
                             np.asarray(sigmas), n_anchors)
    uniform = tuple(range(0, n, int(interval)))
    if dp == uniform:
        return dp
    exact_img = decode_fn(exact_final)
    norm = float(np.linalg.norm(exact_img)) or 1.0
    scores = {}
    for name, anchors in (("dp", dp), ("uniform", uniform)):
        img = decode_fn(probe_fn(anchors))
        scores[name] = float(np.linalg.norm(img - exact_img)) / norm
    winner = min(scores, key=scores.get)
    get_logger("domainrag_tpu_torch.flux").info(
        "%svelocity-cache schedule selection (%d anchors): image rel-L2 "
        "dp=%.4f uniform=%.4f -> %s %s", log_tag, n_anchors,
        scores["dp"], scores["uniform"], winner,
        dp if winner == "dp" else uniform)
    return dp if winner == "dp" else uniform


@torch.inference_mode()
def calibrate_vcache_schedule(bundle: FluxBundle,
                              prompt_embeds: torch.Tensor,
                              pooled: torch.Tensor, height: int, width: int,
                              num_steps: int, guidance: float,
                              n_anchors: int, interval: int,
                              seed: int = 0, *,
                              probe_noise: Optional[torch.Tensor] = None
                              ) -> tuple:
    """One recorded dense probe at the call's own config, then
    :func:`select_vcache_anchors` (latent-DP optimum against
    uniform-``interval``, each scored by one cached denoise decoded
    through the VAE): one exact and two cached denoises. ``probe_noise``
    as in :func:`calibrate_block_cache_interval`."""
    latents, e, p, sig, grid_h, grid_w = _probe_inputs(
        bundle, prompt_embeds, pooled, height, width, num_steps, seed,
        probe_noise)

    def decode(tokens):
        return _host(_decode_tokens(bundle.vae_params, tokens, grid_h,
                                    grid_w, bundle.vae_cfg))

    def probe(anchors):
        return _denoise_latents(bundle, latents, e, p, sig, guidance, grid_h,
                                grid_w, vcache_interval=anchors)

    exact, vs = _record_velocities(bundle, latents, e, p, sig, guidance,
                                   grid_h, grid_w)
    return select_vcache_anchors(
        _host(vs), sig.cpu().numpy(), n_anchors, interval, probe, decode,
        exact, log_tag=f"@{width}x{height}/{num_steps} steps ")


def _resolve_block_cache_interval(bundle: FluxBundle, block_cache_interval,
                                  prompt_embeds, pooled, height: int,
                                  width: int, num_steps: int,
                                  guidance: float, mode: str = "residual"):
    """An interval form -> int (or an anchor tuple, velocity only):
    ``"auto"`` and ``"sched:K"`` calibrate once per (model, resolution,
    steps, guidance) and are cached process-wide."""
    v = block_cache_interval
    if isinstance(v, (list, tuple)):
        if mode != "velocity":
            raise ValueError("anchor-schedule form is velocity-cache "
                             "only; block_cache_interval takes an int")
        return tuple(int(a) for a in v)
    if isinstance(v, str) and v.startswith("sched:"):
        if mode != "velocity":
            raise ValueError("'sched:K' is velocity-cache only")
        k = int(v.split(":", 1)[1])
        if k <= 1:
            return 1
        n_anchors = -(-num_steps // k)      # uniform-k model-call parity
        key = (_params_token(bundle), height, width, num_steps,
               float(guidance), "velocity-sched", n_anchors)
        if key not in _VCACHE_SCHEDULES:
            _VCACHE_SCHEDULES[key] = calibrate_vcache_schedule(
                bundle, prompt_embeds, pooled, height, width, num_steps,
                guidance, n_anchors, k)
        return _VCACHE_SCHEDULES[key]
    if v != "auto":
        return int(v)
    key = (_params_token(bundle), height, width, num_steps,
           float(guidance), mode)
    if key not in _BLOCK_CACHE_CALIBRATIONS:
        _BLOCK_CACHE_CALIBRATIONS[key] = calibrate_block_cache_interval(
            bundle, prompt_embeds, pooled, height, width, num_steps,
            guidance, mode=mode)
    return _BLOCK_CACHE_CALIBRATIONS[key]


# ---------------------------------------------------------------------------
# scale-out over a parallel.mesh.Mesh (one process per card, every rank
# running the same call on the same inputs; parallel/mesh.py)
# ---------------------------------------------------------------------------

def _tp_context(bundle: FluxBundle):
    """Inside: a tensor-parallel bundle's blocks run their rank's heads and
    sum their row-sharded layers over ``tp_axis``
    (``ops.attention.tp_attention``). The JAX package also turns its
    Pallas W8A8 GEMM off here, for want of a GSPMD rule; B4 keeps running
    on each rank's shard (``models.common.linear_row_sharded``)."""
    if bundle.tp_mesh is None:
        return contextlib.nullcontext()
    from ...ops import attention as attn_mod
    return attn_mod.tp_attention(bundle.tp_mesh, bundle.tp_axis)


def _dp(mesh, data_axis: str) -> bool:
    return mesh is not None and mesh.shape.get(data_axis, 1) > 1


def _dp_split(mesh, data_axis: str, *xs):
    """This rank's rows of each batch (the JAX ``_dp_wrap``'s ``P(data)``
    split): padded with row 0 to a multiple of the data axis first, as the
    JAX package pads (:1100-1117, :1600-1606)."""
    d, i = mesh.shape[data_axis], mesh.index(data_axis)
    n = xs[0].shape[0]
    per = -(-n // d)
    out = []
    for x in xs:
        if per * d != n:
            x = torch.cat([x] + [x[:1]] * (per * d - n), dim=0)
        out.append(x[i * per:(i + 1) * per])
    return out


def _dp_gather(mesh, data_axis: str, x: torch.Tensor,
               n_real: int) -> torch.Tensor:
    """Every rank's rows, in order, without the padding."""
    return mesh.all_gather(x, data_axis, dim=0)[:n_real]


def _pipeline_stages(bundle: FluxBundle, n_stages: int, mesh=None,
                     axis: str = "pipe"):
    """This rank's pipeline stages (``parallel.pipeline_parallel``),
    cached on the bundle and keyed by :func:`_params_token`: swapping
    ``bundle.flux_params`` (quantizing after a first serve) builds them
    anew from the new params."""
    from ...parallel import pipeline_parallel as pp
    token = _params_token(bundle)
    key = (n_stages, id(mesh), axis)
    entry = getattr(bundle, "_pp_stages", None)
    if entry is not None and entry[0] is token and entry[1] == key:
        return entry[2]
    stages = pp.prepare_stages(bundle.flux_params, n_stages, mesh=mesh,
                               axis=axis)
    bundle._pp_stages = (token, key, stages)
    return stages


def _pipe(bundle: FluxBundle, mesh, pipe_axis: str, microbatches: int):
    """The pipelined model's (stages, mesh, axis, microbatches), after the
    JAX package's checks (:1068-1080, :1562-1573)."""
    if mesh is None or mesh.shape.get(pipe_axis, 1) <= 1:
        raise ValueError("pipe_axis requires a mesh with that axis")
    if bundle.tp_mesh is not None:
        raise ValueError(
            "pipe_axis (pipeline parallelism) does not compose with a "
            "TP-sharded bundle: the PP path serves unsharded per-stage "
            "block params and would silently ignore tp_mesh. Serve "
            "with EITHER model_parallel (TP) or pipeline_parallel.")
    stages = _pipeline_stages(bundle, mesh.shape[pipe_axis], mesh=mesh,
                              axis=pipe_axis)
    return stages, mesh, pipe_axis, microbatches


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
    fixed seed). ``block_cache_interval`` > 1 turns on block-residual
    caching (the blocks run every N-th step and replay their residuals in
    between; outputs change). ``velocity_cache_interval`` turns on the
    velocity-extrapolation cache instead (the network runs every N-th
    step, the others integrate an extrapolated velocity, order
    ``velocity_cache_order``): an int N, an anchor tuple, ``"auto"`` (the
    largest interval within the divergence budget) or ``"sched:K"``
    (DP-planned anchors at uniform-K model-call parity). The two caches
    are mutually exclusive; ``"auto"`` and ``"sched:K"`` calibrate once
    (a ``calibrate`` span of ``timer``).

    ``noise``: (B, S_img, 4*latent_channels) initial latents in place of
    the per-seed draw, which is the JAX package's (:func:`_noise`).
    ``timer`` gets a ``step`` span per denoise step and a ``decode``
    span. Images with a non-finite value before quantisation
    are counted in ``generate.nonfinite_images``. The parameters are the
    JAX package's, in its order and with its defaults; ``noise`` and
    ``timer`` are the port's own and keyword-only.

    ``mesh`` (a ``parallel.mesh.Mesh``; every rank makes the same call):
    the batch is split over ``data_axis`` (padded with row 0) and every
    rank returns the whole batch. ``pipe_axis``: the name of a mesh axis
    to pipeline the transformer depth over (``parallel.pipeline_parallel``;
    ``microbatches`` defaults to the batch size); not with a block cache
    or a tensor-parallel bundle. A bundle from ``parallel.deploy.
    shard_bundle`` runs tensor-parallel over its ``tp_mesh``."""
    timer = timer or StepTimer()
    b = prompt_embeds.shape[0]
    lf = bundle.latent_factor
    grid_h, grid_w = height // lf, width // lf
    if noise is None:
        seeds = list(seed) if isinstance(seed, (list, tuple)) else [seed] * b
        if len(seeds) != b:
            raise ValueError(f"{len(seeds)} seeds for a batch of {b}")
        noise = _noise(bundle, seeds, grid_h * grid_w,
                       bundle.vae_cfg.latent_channels * 4)
    dev, dt = bundle.device, bundle.compute_dtype
    embeds = prompt_embeds.to(device=dev, dtype=dt)
    pooled_c = pooled.to(device=dev, dtype=dt)

    calibrating = isinstance(block_cache_interval, str) or isinstance(
        velocity_cache_interval, str)
    with _tp_context(bundle):
        with timer.span("calibrate") if calibrating else \
                contextlib.nullcontext():
            block_cache_interval = _resolve_block_cache_interval(
                bundle, block_cache_interval, embeds, pooled_c, height,
                width, num_steps, guidance)
            velocity_cache_interval = _resolve_block_cache_interval(
                bundle, velocity_cache_interval, embeds, pooled_c, height,
                width, num_steps, guidance, mode="velocity")
        if block_cache_interval > 1 and _vc_active(velocity_cache_interval):
            raise ValueError(
                "block_cache_interval and velocity_cache_interval are "
                "mutually exclusive accelerators — pick one")
        pipe = None
        if pipe_axis is not None:
            if mesh is None or mesh.shape.get(pipe_axis, 1) <= 1:
                raise ValueError("pipe_axis requires a mesh with that axis")
            if block_cache_interval > 1:
                raise ValueError("block_cache_interval is not implemented "
                                 "on the pipelined (pipe_axis) path")
            pipe = _pipe(bundle, mesh, pipe_axis, microbatches or b)
        dp = pipe is None and _dp(mesh, data_axis)
        if dp:
            embeds, pooled_c, noise = _dp_split(
                mesh, data_axis, embeds, pooled_c, noise.to(dev))
        if block_cache_interval > 1:
            _check_block_cache_hbm(bundle, embeds.shape[0], grid_h * grid_w,
                                   prompt_embeds.shape[-2], mesh, data_axis)
        img = _generate_float(
            bundle, embeds, pooled_c, height, width, num_steps, guidance,
            noise, scheduler_overrides, timer,
            cache_interval=block_cache_interval,
            vcache_interval=velocity_cache_interval,
            vcache_order=velocity_cache_order, pipe=pipe)
    if dp:
        img = _dp_gather(mesh, data_axis, img, b)
    img = img.float().cpu().numpy()
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
                timer: Optional[StepTimer] = None, *,
                vcache_interval=1, vcache_order: int = 1,
                pipe=None) -> torch.Tensor:
    """The fill core -> (B, H, W, 3) f32 in [-1, 1]. ``image`` (B, H, W, 3)
    in [-1, 1], ``mask`` (B, H, W) 0/1 (1 = repaint) and ``noise``
    (B, S_img, 4*latent_channels), all in ``compute_dtype`` on the
    bundle's device; ``sigmas`` the strength-trimmed schedule. ``hires``
    runs the VAE encode and decode tiled. ``vcache_interval`` /
    ``vcache_order``: the velocity cache, as :func:`_pick_denoise` takes
    it; ``pipe`` the pipelined model (:func:`_pipe`, the JAX
    ``_fill_core_pp``). Spans: ``encode`` per encode, ``step`` per denoise
    step, ``decode``."""
    timer = timer or StepTimer()
    lf = bundle.latent_factor
    grid_h, grid_w = image.shape[1] // lf, image.shape[2] // lf
    latents, cond = _fill_conditioning(
        bundle.vae_params, image, mask, noise, sigmas[0], bundle.vae_cfg,
        hires, vae_tile, vae_overlap, timer)
    x = _denoise_latents(bundle, latents, prompt_embeds, pooled, sigmas,
                         guidance, grid_h, grid_w,
                         vcache_interval=vcache_interval,
                         vcache_order=vcache_order, cond=cond, timer=timer,
                         pipe=pipe)
    with timer.span("decode"):
        return _decode_tokens(bundle.vae_params, x, grid_h, grid_w,
                              bundle.vae_cfg, hires, vae_tile, vae_overlap)


def _fill_probe_core(bundle: FluxBundle, image, mask, noise, prompt_embeds,
                     pooled, sigmas, guidance: float, grid_h: int,
                     grid_w: int, tiled_vae: bool = False,
                     vae_tile: int = 96, vae_overlap: int = 16,
                     vcache_interval=1, vcache_order: int = 1,
                     record: bool = False):
    """The calibration probe on the fill core: the conditioning and the
    strength-trimmed denoise of :func:`_fill_float`, returning the final
    latent tokens (no decode); ``record=True`` runs the dense loop and
    also returns the per-step velocities (:func:`_record_velocities`)."""
    latents, cond = _fill_conditioning(
        bundle.vae_params, image, mask, noise, sigmas[0], bundle.vae_cfg,
        tiled_vae, vae_tile, vae_overlap, StepTimer())
    if record:
        return _record_velocities(bundle, latents, prompt_embeds, pooled,
                                  sigmas, guidance, grid_h, grid_w,
                                  cond=cond)
    return _denoise_latents(bundle, latents, prompt_embeds, pooled, sigmas,
                            guidance, grid_h, grid_w,
                            vcache_interval=vcache_interval,
                            vcache_order=vcache_order, cond=cond)


@torch.inference_mode()
def calibrate_fill_vcache(bundle: FluxBundle, image, mask, noise,
                          prompt_embeds, pooled, sigmas, guidance: float,
                          grid_h: int, grid_w: int, *, form: str,
                          tiled_vae: bool = False, vae_tile: int = 96,
                          vae_overlap: int = 16,
                          divergence_budget: float = 0.05,
                          candidates=(4, 3, 2),
                          budget_space: str = "image"):
    """Velocity-cache calibration on the fill regime, probing one sample
    of the actual call (its image, mask, noise, prompt and
    strength-trimmed ``sigmas``, all on the bundle's device):

    - ``form="auto"``: one dense probe and up to ``len(candidates)``
      cached fill denoises; the largest uniform interval whose relative L2
      divergence (on the decoded images by default, ``budget_space``)
      stays within ``divergence_budget``, 1 when none does;
    - ``form="sched:K"``: one dense probe recording velocities, then
      :func:`select_vcache_anchors` over the trimmed step count; the
      winning anchor tuple."""
    _check_budget_space(budget_space)
    n_steps = int(sigmas.shape[0]) - 1
    kw = dict(tiled_vae=tiled_vae, vae_tile=vae_tile,
              vae_overlap=vae_overlap)
    args = (bundle, image, mask, noise, prompt_embeds, pooled, sigmas,
            guidance, grid_h, grid_w)

    def decode(tokens):
        return _host(_decode_tokens(bundle.vae_params, tokens, grid_h,
                                    grid_w, bundle.vae_cfg, tiled_vae,
                                    vae_tile, vae_overlap))

    exact, vs = _fill_probe_core(*args, record=True, **kw)
    if form.startswith("sched:"):
        k = int(form.split(":", 1)[1])
        if k <= 1:
            return 1
        n_anchors = -(-n_steps // k)
        if n_anchors >= n_steps:
            return 1
        return select_vcache_anchors(
            _host(vs), sigmas.cpu().numpy(), n_anchors, k,
            lambda anchors: _fill_probe_core(*args, vcache_interval=anchors,
                                             **kw),
            decode, exact,
            log_tag=f"fill @{grid_w}x{grid_h} grid/{n_steps} trimmed "
                    f"steps ")
    exact_img = decode(exact)
    exact_lat = _host(exact)
    norms = {"latent": float(np.linalg.norm(exact_lat)) or 1.0,
             "image": float(np.linalg.norm(exact_img)) or 1.0}
    curve: dict = {}
    chosen = 1
    for interval in sorted(candidates, reverse=True):
        if interval >= n_steps:
            continue
        cached = _fill_probe_core(*args, vcache_interval=int(interval), **kw)
        rel = {"latent": float(np.linalg.norm(_host(cached) - exact_lat))
               / norms["latent"],
               "image": float(np.linalg.norm(decode(cached) - exact_img))
               / norms["image"]}
        curve[int(interval)] = rel
        if rel[budget_space] <= divergence_budget and chosen == 1:
            chosen = int(interval)
    get_logger("domainrag_tpu_torch.flux").info(
        "fill velocity-cache calibration @%dx%d grid/%d trimmed steps: "
        "divergence %s, budget %.3f on %s -> interval %d", grid_w,
        grid_h, n_steps,
        {k_: {s: round(v2, 4) for s, v2 in v_.items()}
         for k_, v_ in sorted(curve.items())},
        divergence_budget, budget_space, chosen)
    return chosen


def _resolve_fill_vcache(bundle: FluxBundle, form: str, image, mask, noise,
                         prompt_embeds, pooled, sigmas, guidance, grid_h,
                         grid_w, tiled_vae, vae_tile, vae_overlap, height,
                         width, num_steps, strength,
                         divergence_budget: float):
    """``"auto"`` / ``"sched:K"`` for :func:`fill_batch`: one
    :func:`calibrate_fill_vcache` of the call's first sample, cached
    process-wide per (model, resolution, steps, strength, guidance, form,
    budget); strength is in the key because it trims the sigmas the
    anchors index."""
    if form != "auto" and not form.startswith("sched:"):
        raise ValueError(
            f"velocity_cache_interval string form must be 'auto' or "
            f"'sched:K': {form!r}")
    key = (_params_token(bundle), height, width, num_steps,
           round(float(strength), 6), round(float(guidance), 6),
           "fill-" + form, round(float(divergence_budget), 6))
    if key not in _FILL_VCACHE_CALIBRATIONS:
        _FILL_VCACHE_CALIBRATIONS[key] = calibrate_fill_vcache(
            bundle, image, mask, noise, prompt_embeds, pooled, sigmas,
            guidance, grid_h, grid_w, form=form, tiled_vae=tiled_vae,
            vae_tile=vae_tile, vae_overlap=vae_overlap,
            divergence_budget=divergence_budget)
    return _FILL_VCACHE_CALIBRATIONS[key]


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
    tiled (``vae_tile``/``vae_overlap`` latent cells).
    ``velocity_cache_interval`` turns on the velocity cache (order
    ``velocity_cache_order``): an int N, an anchor tuple or list over this
    call's strength-trimmed step indices, ``"auto"`` (the largest uniform
    interval within ``vcache_divergence_budget``) or ``"sched:K"``; the
    last two calibrate once on the fill core against the call's first
    sample (:func:`calibrate_fill_vcache`, a ``calibrate`` span of
    ``timer``). ``noise``: (B, S_img, 4*latent_channels) in place of the
    per-seed draw, as in :func:`generate`; ``timer`` gets a
    ``fill/inputs`` span (the images and masks to the compute dtype on the
    device, the noise drawn, the prior cast) and the spans of
    :func:`_fill_float`. Images with a non-finite value before
    quantisation are counted in ``fill_batch.nonfinite_images``. The
    parameters are the JAX package's, in its order and with its
    defaults; ``noise`` and ``timer`` are the port's own and
    keyword-only.

    ``mesh`` (a ``parallel.mesh.Mesh``; every rank makes the same call):
    the batch splits over ``data_axis`` (padded with row 0), or, in the
    hires regime, attention rings the joint sequence over it
    (``ops.attention.sp_attention``: sequence parallel) and the batch
    stays whole; every rank returns the whole batch. ``pipe_axis``: the
    transformer depth pipelined over that mesh axis, as in
    :func:`generate`. A ``shard_bundle`` bundle runs tensor-parallel."""
    vci = velocity_cache_interval
    vci = (tuple(int(a) for a in vci) if isinstance(vci, (list, tuple))
           else vci if isinstance(vci, str) else int(vci))
    timer = timer or StepTimer()
    dev, dt = bundle.device, bundle.compute_dtype
    b, h, w = images.shape[:3]
    lf = bundle.latent_factor
    grid_h, grid_w = h // lf, w // lf
    seq = grid_h * grid_w
    hires = hires_threshold_px > 0 and h * w >= hires_threshold_px
    with timer.span("fill/inputs"):
        schedule = sched_mod.make_schedule(num_steps, image_seq_len=seq,
                                           strength=strength)
        sigmas = torch.as_tensor(schedule.sigmas, dtype=torch.float32,
                                 device=dev)
        img = torch.as_tensor(from_uint8(np.asarray(images)),
                              device=dev).to(dt)
        m = torch.as_tensor((np.asarray(masks, np.float32) / 255.0) > 0.5,
                            device=dev).to(dt)
        if noise is None:
            noise = _noise(bundle, seeds, seq,
                           bundle.vae_cfg.latent_channels * 4)
        noise = noise.to(device=dev, dtype=dt)
        embeds = prompt_embeds.to(device=dev, dtype=dt)
        pooled_c = pooled.to(device=dev, dtype=dt)
    with _tp_context(bundle):
        if isinstance(vci, str):
            with timer.span("calibrate"):
                vci = _resolve_fill_vcache(
                    bundle, vci, img[:1], m[:1], noise[:1], embeds[:1],
                    pooled_c[:1], sigmas, guidance, grid_h, grid_w, hires,
                    vae_tile, vae_overlap, h, w, num_steps, strength,
                    vcache_divergence_budget)
        pipe = (None if pipe_axis is None else
                _pipe(bundle, mesh, pipe_axis, microbatches or b))
        sp = pipe is None and hires and _dp(mesh, data_axis)
        dp = pipe is None and not hires and _dp(mesh, data_axis)
        if dp:
            img, m, noise, embeds, pooled_c = _dp_split(
                mesh, data_axis, img, m, noise, embeds, pooled_c)
        sp_ctx = contextlib.nullcontext()
        if sp:
            from ...ops import attention as attn_mod
            sp_ctx = attn_mod.sp_attention(mesh, data_axis)
        with sp_ctx:
            out = _fill_float(
                bundle, img, m, noise, embeds, pooled_c, sigmas, guidance,
                hires, vae_tile, vae_overlap, timer, vcache_interval=vci,
                vcache_order=velocity_cache_order, pipe=pipe)
    if dp:
        out = _dp_gather(mesh, data_axis, out, b)
    out = out.float().cpu().numpy()
    fill_batch.nonfinite_images += int((~np.isfinite(out)).any(
        axis=(1, 2, 3)).sum())
    return to_uint8(out)


fill_batch.nonfinite_images = 0
