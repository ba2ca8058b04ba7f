"""The port's stage-4 fill (Flux-Fill) against the JAX package's.

Same numpy inputs and the JAX ``tiny_bundle(fill=True)`` weights carried
by domainrag_tpu_torch.bridge; the JAX noise
(``jax.random.normal(PRNGKey(seed))``) is handed to the port as a tensor.
Tolerances:

- VAE encode/decode, whole and tiled, in f32 at 5e-5 (summation order
  only, compounding over the conv stack, as the decode test of
  tests/test_torch_models.py);
- the small exact pieces (``pack_mask``, ``from_uint8``) bit for bit,
  ``scale_noise`` bit for bit in f32 after the bf16 round-trip;
- the fill end to end in f32 (4 Euler steps, strength-trimmed, tiled or
  whole VAE) at 1e-3 on the [-1, 1] image, and the uint8 image within 1
  level (a value on a rounding edge may land on either side); those two,
  over the whole and the tiled VAE routes, are in
  ``test_torch_fill_routes.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu.models.flux import pipeline as jfp
from domainrag_tpu.models.flux import scheduler as jsched
from domainrag_tpu.models.flux import vae as jvae
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.core import prng
from domainrag_tpu_torch.models import clip as tclip
from domainrag_tpu_torch.models import redux as tredux
from domainrag_tpu_torch.models import siglip as tsiglip
from domainrag_tpu_torch.models import t5 as tt5
from domainrag_tpu_torch.models.flux import model as tflux
from domainrag_tpu_torch.models.flux import pipeline as tfp
from domainrag_tpu_torch.models.flux import scheduler as tsched
from domainrag_tpu_torch.models.flux import vae as tvae

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

SIZE = 32
STEPS = 4
SEEDS = [0, 1]


def port_bundle(jb, fill=True, compute_dtype=torch.float32):
    """The JAX bundle's weights and configs as a port bundle on the CPU."""
    cfgs = tfp.tiny_configs(fill)
    trees = {name: bridge.params(jax.tree.map(np.asarray, getattr(jb, name)),
                                 device="cpu")
             for name in ("flux_params", "vae_params", "t5_params",
                          "clip_text_params", "siglip_params",
                          "redux_params")}
    port_cfgs = dict(
        flux_cfg=bridge.config(jb.flux_cfg, tflux.FluxConfig),
        vae_cfg=bridge.config(jb.vae_cfg, tvae.VaeConfig),
        t5_cfg=bridge.config(jb.t5_cfg, tt5.T5Config),
        clip_text_cfg=bridge.config(jb.clip_text_cfg, tclip.ClipTextConfig),
        siglip_cfg=bridge.config(jb.siglip_cfg, tsiglip.SiglipVisionConfig),
        redux_cfg=bridge.config(jb.redux_cfg, tredux.ReduxEncoderConfig))
    assert port_cfgs == cfgs          # the port's tiny configs are JAX's
    return tfp.FluxBundle(**trees, **port_cfgs, **tfp.tiny_tokenizers(cfgs),
                          compute_dtype=compute_dtype,
                          device=torch.device("cpu"))


@pytest.fixture(scope="module")
def bundles():
    jb = jfp.tiny_bundle(jax.random.PRNGKey(7), fill=True)
    return jb, port_bundle(jb)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _fill_inputs(jb, seed=0, n=2):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (n, SIZE, SIZE, 3), dtype=np.uint8)
    masks = np.full((n, SIZE, SIZE), 255, np.uint8)
    masks[:, 8:16, 8:20] = 0                  # keep region
    size = jb.siglip_cfg.image_size
    px = rng.standard_normal((n, 1, size, size, 3)).astype(np.float32)
    embeds, pooled = jfp.redux_prior_pairs(jb, px, "bg", [1.0], [1.0])
    return images, masks, embeds, pooled


def jax_noise(jb, seeds, h=SIZE, w=SIZE):
    seq = (h // jb.latent_factor) * (w // jb.latent_factor)
    c = jb.vae_cfg.latent_channels * 4
    return jnp.stack([jax.random.normal(jax.random.PRNGKey(s), (seq, c),
                                        jnp.float32) for s in seeds])


# ---------------------------------------------------------------------------
# VAE encoder and tiled paths
# ---------------------------------------------------------------------------

VAE_CFGS = [jvae.TINY_VAE,
            jvae.VaeConfig(latent_channels=4, block_out=(8, 16, 16),
                           layers_per_block=1, norm_groups=4)]


@pytest.mark.parametrize("cfg", VAE_CFGS, ids=["tiny", "three_levels"])
def test_vae_encode_matches_jax(cfg):
    params = jvae.init(jax.random.PRNGKey(3), cfg)
    img = np.random.default_rng(3).uniform(
        -1, 1, (2, 24, 20, 3)).astype(np.float32)
    tp = bridge.params(jax.tree.map(np.asarray, params), device="cpu")
    tcfg = bridge.config(cfg, tvae.VaeConfig)
    got_m = tvae.encode_moments(tp, torch.from_numpy(img), tcfg)
    want_m = jvae.encode_moments(params, jnp.asarray(img), cfg)
    assert tuple(got_m.shape) == want_m.shape
    _close(got_m, want_m, 5e-5)
    _close(tvae.encode(tp, torch.from_numpy(img), tcfg),
           jvae.encode(params, jnp.asarray(img), cfg), 5e-5)


def test_vae_init_trees_match_jax():
    """The port draws the encoder and decoder trees the JAX init builds,
    leaf for leaf in shape (convs in OIHW)."""
    cfg = jvae.TINY_VAE
    want = bridge.params(jax.tree.map(np.asarray,
                                      jvae.init(jax.random.PRNGKey(0), cfg)),
                         device="cpu")
    got = tvae.init(prng.PRNGKey(0), bridge.config(cfg, tvae.VaeConfig))
    shapes = lambda tree: jax.tree.map(  # noqa: E731
        lambda x: tuple(x.shape), tree)
    assert shapes(got) == shapes(want)


@pytest.mark.parametrize("tile,overlap", [(8, 4), (6, 2), (64, 16)],
                         ids=["ragged", "narrow", "one_tile"])
def test_encode_tiled_matches_jax(bundles, tile, overlap):
    jb, tb = bundles
    img = np.random.default_rng(4).uniform(
        -1, 1, (2, 36, 44, 3)).astype(np.float32)      # latents 18 x 22
    want = jvae.encode_tiled(jb.vae_params, jnp.asarray(img), jb.vae_cfg,
                             tile=tile, overlap=overlap)
    got = tvae.encode_tiled(tb.vae_params, torch.from_numpy(img), tb.vae_cfg,
                            tile=tile, overlap=overlap)
    assert tuple(got.shape) == want.shape
    _close(got, want, 5e-5)


@pytest.mark.parametrize("tile,overlap", [(8, 4), (6, 2), (64, 16)],
                         ids=["ragged", "narrow", "one_tile"])
def test_decode_tiled_matches_jax(bundles, tile, overlap):
    jb, tb = bundles
    lat = np.random.default_rng(5).standard_normal(
        (2, 18, 22, jb.vae_cfg.latent_channels)).astype(np.float32)
    want = jvae.decode_tiled(jb.vae_params, jnp.asarray(lat), jb.vae_cfg,
                             tile=tile, overlap=overlap)
    got = tvae.decode_tiled(tb.vae_params, torch.from_numpy(lat), tb.vae_cfg,
                            tile=tile, overlap=overlap)
    assert tuple(got.shape) == want.shape
    _close(got, want, 5e-5)


def test_blend_profile_matches_jax():
    for n, lo, hi in ((8, 0, 0), (8, 3, 0), (10, 2, 4), (6, 0, 5)):
        np.testing.assert_array_equal(tvae._blend_profile(n, lo, hi).numpy(),
                                      np.asarray(jvae._blend_profile(n, lo,
                                                                     hi)))


# ---------------------------------------------------------------------------
# small pieces
# ---------------------------------------------------------------------------

def test_pack_mask_matches_jax():
    mask = (np.random.default_rng(6).uniform(size=(2, 16, 24)) > 0.5
            ).astype(np.float32)
    np.testing.assert_array_equal(
        tfp.pack_mask(torch.from_numpy(mask), 2).numpy(),
        np.asarray(jfp.pack_mask(jnp.asarray(mask), 2)))
    np.testing.assert_array_equal(
        tfp.pack_mask(torch.from_numpy(mask), 4).numpy(),
        np.asarray(jfp.pack_mask(jnp.asarray(mask), 4)))


def test_scale_noise_matches_jax():
    """bf16 sample and noise with an f32 sigma: the sum is f32 in both."""
    rng = np.random.default_rng(7)
    sample, noise = (rng.standard_normal((2, 5, 16)).astype(np.float32)
                     for _ in range(2))
    sigma = np.float32(0.6137)
    want = jsched.scale_noise(jnp.asarray(sample, jnp.bfloat16),
                              jnp.asarray(noise, jnp.bfloat16),
                              jnp.asarray(sigma))
    got = tsched.scale_noise(torch.from_numpy(sample).to(torch.bfloat16),
                             torch.from_numpy(noise).to(torch.bfloat16),
                             torch.tensor(sigma))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_from_uint8_matches_jax():
    img = np.random.default_rng(8).integers(0, 256, (3, 4, 3), np.uint8)
    np.testing.assert_array_equal(tfp.from_uint8(img), jfp.from_uint8(img))


def test_redux_prior_pairs_matches_jax(bundles):
    jb, tb = bundles
    size = jb.siglip_cfg.image_size
    px = np.random.default_rng(9).standard_normal(
        (3, 2, size, size, 3)).astype(np.float32)
    want = jfp.redux_prior_pairs(jb, px, "bg", [0.7, 1.0], [1.0, 0.5])
    got = tfp.redux_prior_pairs(tb, px, "bg", [0.7, 1.0], [1.0, 0.5])
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, 1e-4)


# ---------------------------------------------------------------------------
# the fill
# ---------------------------------------------------------------------------

def test_fill_single_image_matches_fill_batch(bundles):
    _, tb = bundles
    images, masks, je, jp = _fill_inputs(bundles[0], seed=2, n=1)
    one = tfp.fill(tb, images[0], masks[0], _t(je), _t(jp), num_steps=2,
                   strength=0.5, seed=3)
    batch = tfp.fill_batch(tb, images, masks, _t(je), _t(jp), num_steps=2,
                           strength=0.5, seeds=[3])
    assert one.shape == (SIZE, SIZE, 3)
    np.testing.assert_array_equal(one, batch[0])


def test_fill_latents_enter_model_in_compute_dtype(monkeypatch):
    """A bf16 fill bundle: the image enters the VAE encoder in bf16 and the
    latents and conditioning enter the MMDiT in bf16 (scale_noise's f32
    must not leak into the denoise stream); the decode runs in f32."""
    jb = jfp.tiny_bundle(jax.random.PRNGKey(7), fill=True)
    tb = port_bundle(jb, compute_dtype=torch.bfloat16)
    seen = {"encode": [], "apply": [], "decode": []}
    encode, apply, decode = tvae.encode, tflux.apply, tvae.decode

    def spy_encode(params, images, cfg):
        seen["encode"].append(images.dtype)
        return encode(params, images, cfg)

    def spy_apply(params, img_tokens, txt_tokens, pooled, *args, **kw):
        seen["apply"].append((img_tokens.dtype, txt_tokens.dtype,
                              pooled.dtype))
        return apply(params, img_tokens, txt_tokens, pooled, *args, **kw)

    def spy_decode(params, latents, cfg):
        seen["decode"].append(latents.dtype)
        return decode(params, latents, cfg)

    monkeypatch.setattr(tvae, "encode", spy_encode)
    monkeypatch.setattr(tflux, "apply", spy_apply)
    monkeypatch.setattr(tvae, "decode", spy_decode)
    images, masks, je, jp = _fill_inputs(jb, n=1)
    out = tfp.fill_batch(tb, images, masks, _t(je), _t(jp), num_steps=2,
                         strength=1.0, seeds=[0])
    assert out.dtype == np.uint8
    bf16 = torch.bfloat16
    assert seen["encode"] == [bf16, bf16]
    assert seen["apply"] == [(bf16, bf16, bf16)] * 2
    assert seen["decode"] == [torch.float32]


@pytest.mark.parametrize("kwargs", [
    dict(mesh=object()), dict(pipe_axis="pipe"),
    dict(velocity_cache_interval=2), dict(velocity_cache_interval="auto"),
    dict(velocity_cache_interval=(0, 2))],
    ids=["mesh", "pipe_axis", "vcache_2", "vcache_auto", "vcache_anchors"])
def test_fill_rejects_unported_modes(bundles, kwargs):
    """A mesh argument that is not a mesh, and a pipe axis without a mesh,
    raise the JAX package's errors (type and text; the mesh path is
    ``tests/test_torch_scaleout_serve.py``'s); the velocity cache runs and
    gives JAX's images (uint8 within 1 level) from JAX's noise, "auto"
    calibrating on the same first sample."""
    jb, tb = bundles
    if "mesh" in kwargs or "pipe_axis" in kwargs:
        images, masks, je, jp = _fill_inputs(jb, n=1)
        with pytest.raises(Exception) as want:
            jfp.fill_batch(jb, images, masks, je, jp, num_steps=1, **kwargs)
        with pytest.raises(type(want.value)) as got:
            tfp.fill_batch(tb, images, masks, _t(je), _t(jp), num_steps=1,
                           **kwargs)
        assert str(got.value) == str(want.value)
        return
    images, masks, je, jp = _fill_inputs(jb)
    kw = dict(num_steps=STEPS, strength=0.75, seeds=SEEDS, **kwargs)
    want = jfp.fill_batch(jb, images, masks, je, jp, **kw)
    got = tfp.fill_batch(tb, images, masks, _t(je), _t(jp),
                         noise=_t(jax_noise(jb, SEEDS)), **kw)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_fill_counts_nonfinite_images(bundles):
    jb, tb = bundles
    images, masks, je, jp = _fill_inputs(jb)
    noise = torch.zeros((2, (SIZE // tb.latent_factor) ** 2,
                         tb.vae_cfg.latent_channels * 4))
    noise[1, 0, 0] = float("nan")
    before = tfp.fill_batch.nonfinite_images
    tfp.fill_batch(tb, images, masks, _t(je), _t(jp), num_steps=2,
                   strength=1.0, noise=noise)
    assert tfp.fill_batch.nonfinite_images == before + 1
