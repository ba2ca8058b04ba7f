"""The port's model modules against the JAX package's, on the same
weights (carried by domainrag_tpu_torch.bridge) and the same numpy
inputs, in f32 on the CPU.

Tolerances: both sides compute in full f32 (the JAX package asks for
``precision="highest"``), so only summation order differs — 1e-5 for
single ops, a few 1e-5 to 1e-4 for whole networks where rounding
compounds over layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu.models import clip as jclip
from domainrag_tpu.models import common as jcommon
from domainrag_tpu.models import redux as jredux
from domainrag_tpu.models import siglip as jsiglip
from domainrag_tpu.models import t5 as jt5
from domainrag_tpu.models.flux import model as jflux
from domainrag_tpu.models.flux import scheduler as jsched
from domainrag_tpu.models.flux import vae as jvae
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.models import clip as tclip
from domainrag_tpu_torch.models import common as tcommon
from domainrag_tpu_torch.models import redux as tredux
from domainrag_tpu_torch.models import siglip as tsiglip
from domainrag_tpu_torch.models import t5 as tt5
from domainrag_tpu_torch.models.flux import model as tflux
from domainrag_tpu_torch.models.flux import scheduler as tsched
from domainrag_tpu_torch.models.flux import vae as tvae

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return bridge.params(_np_tree(tree), device="cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# common ops
# ---------------------------------------------------------------------------

def _op_cases():
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(0)
    x3 = _randn(rng, 2, 5, 24)
    img = _randn(rng, 2, 9, 7, 16)
    lin = jcommon.linear_init(key, 24, 40)
    lin = {"w": lin["w"], "b": jnp.asarray(_randn(rng, 40))}
    ln = {"scale": jnp.asarray(_randn(rng, 24)),
          "bias": jnp.asarray(_randn(rng, 24))}
    gn = {"scale": jnp.asarray(_randn(rng, 16)),
          "bias": jnp.asarray(_randn(rng, 16))}
    conv3 = jcommon.conv_init(key, 3, 3, 16, 8)
    conv3 = {"w": conv3["w"], "b": jnp.asarray(_randn(rng, 8))}
    conv1 = jcommon.conv_init(jax.random.PRNGKey(1), 1, 1, 16, 4)
    mha = jcommon.mha_init(jax.random.PRNGKey(2), 24)
    q, k, v = (_randn(rng, 2, 3, 6, 8) for _ in range(3))
    mask = np.tril(np.ones((1, 1, 6, 6), bool))
    pad = ((0, 1), (0, 1))
    return {
        "linear": (jcommon.linear, tcommon.linear, (lin, x3)),
        "layernorm": (jcommon.layernorm, tcommon.layernorm, (ln, x3)),
        "rmsnorm": (jcommon.rmsnorm, tcommon.rmsnorm,
                    ({"scale": ln["scale"]}, x3)),
        "gelu_tanh": (jcommon.gelu_tanh, tcommon.gelu_tanh, (x3,)),
        "quick_gelu": (jcommon.quick_gelu, tcommon.quick_gelu, (x3,)),
        "conv3x3": (jcommon.conv2d, tcommon.conv2d, (conv3, img)),
        "conv1x1": (jcommon.conv2d, tcommon.conv2d, (conv1, img)),
        "conv_stride2_pad": (lambda p, x: jcommon.conv2d(p, x, 2, pad),
                             lambda p, x: tcommon.conv2d(p, x, 2, pad),
                             (conv3, img)),
        "groupnorm": (lambda p, x: jcommon.groupnorm(p, x, groups=4),
                      lambda p, x: tcommon.groupnorm(p, x, groups=4),
                      (gn, img)),
        "sdpa": (jcommon.sdpa, tcommon.sdpa, (q, k, v)),
        "sdpa_masked": (jcommon.sdpa, tcommon.sdpa, (q, k, v, mask)),
        "mha": (lambda p, x: jcommon.mha(p, x, 4),
                lambda p, x: tcommon.mha(p, x, 4), (mha, x3)),
        "split_merge_heads": (
            lambda x: jcommon.merge_heads(jcommon.split_heads(x, 4) * 2),
            lambda x: tcommon.merge_heads(tcommon.split_heads(x, 4) * 2),
            (x3,)),
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_common_op(name):
    jfn, tfn, args = _op_cases()[name]
    want = jfn(*[a if isinstance(a, dict) else jnp.asarray(a)
                 for a in args])
    got = tfn(*[_port(a) if isinstance(a, dict) else torch.from_numpy(
        np.asarray(a)) for a in args])
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# conditioning towers
# ---------------------------------------------------------------------------

def test_t5_relative_position_buckets():
    rel = np.arange(-300, 301)
    want = jt5.relative_position_bucket(jnp.asarray(rel))
    got = tt5.relative_position_bucket(torch.from_numpy(rel))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_t5_encoder():
    cfg = jt5.TINY_T5
    params = jt5.init(jax.random.PRNGKey(1), cfg)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24),
                                            dtype=np.int32)
    want = jt5.apply(params, jnp.asarray(ids), cfg)
    got = tt5.apply(_port(params), torch.from_numpy(ids),
                    bridge.config(cfg, tt5.T5Config))
    _close(got, want, 5e-5)


def test_clip_text_tower_and_eos_pooling():
    cfg = jclip.TINY_TEXT
    params = jclip.init_text(jax.random.PRNGKey(2), cfg)
    ids = np.zeros((2, cfg.max_len), np.int32)
    ids[0, :5] = [98, 3, 4, 5, cfg.eos_token_id]
    ids[1, :3] = [98, 7, cfg.eos_token_id]
    ids[1, 6] = cfg.eos_token_id                  # only the first EOS counts
    want_h, want_p = jclip.apply_text(params, jnp.asarray(ids), cfg)
    got_h, got_p = tclip.apply_text(_port(params), torch.from_numpy(ids),
                                    bridge.config(cfg, tclip.ClipTextConfig))
    _close(got_h, want_h, 2e-5)
    _close(got_p, want_p, 2e-5)


@pytest.mark.parametrize("size", [28, 31])      # 31 px: floor patchify
def test_siglip_tower(size):
    cfg = dataclasses.replace(jsiglip.TINY_SIGLIP, image_size=size)
    params = jsiglip.init(jax.random.PRNGKey(3), cfg)
    images = np.random.default_rng(3).uniform(
        -1, 1, (3, size, size, 3)).astype(np.float32)
    want = jsiglip.apply(params, jnp.asarray(images), cfg)
    got = tsiglip.apply(_port(params), torch.from_numpy(images),
                        bridge.config(cfg, tsiglip.SiglipVisionConfig))
    assert tuple(got.shape) == (3, 16, cfg.hidden)
    _close(got, want, 5e-5)


def test_redux_encoder_and_prior_fusion():
    cfg = jredux.TINY_REDUX
    params = jredux.init(jax.random.PRNGKey(4), cfg)
    rng = np.random.default_rng(4)
    sig = _randn(rng, 3, 16, cfg.siglip_hidden)
    want = jredux.apply(params, jnp.asarray(sig))
    got = tredux.apply(_port(params), torch.from_numpy(sig))
    _close(got, want, 1e-5)

    txt, pooled, img = (_randn(rng, 2, 5, 32), _randn(rng, 2, 6),
                        _randn(rng, 2, 4, 32))
    scales, pscales = [0.8, 1.0], [1.0, 0.5]
    want = jredux.combine_prior(jnp.asarray(txt), jnp.asarray(pooled),
                                jnp.asarray(img), scales, pscales)
    got = tredux.combine_prior(torch.from_numpy(txt),
                               torch.from_numpy(pooled),
                               torch.from_numpy(img), scales, pscales)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)

    txt4, pooled3, img4 = (_randn(rng, 3, 2, 5, 32), _randn(rng, 3, 2, 6),
                           _randn(rng, 3, 2, 4, 32))
    want = jredux.combine_prior_pairs(jnp.asarray(txt4),
                                      jnp.asarray(pooled3),
                                      jnp.asarray(img4), scales, pscales)
    got = tredux.combine_prior_pairs(torch.from_numpy(txt4),
                                     torch.from_numpy(pooled3),
                                     torch.from_numpy(img4), scales, pscales)
    assert tuple(got[0].shape) == (3, 9, 32)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


# ---------------------------------------------------------------------------
# VAE decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    jvae.TINY_VAE,
    jvae.VaeConfig(latent_channels=4, block_out=(8, 16, 16),
                   layers_per_block=1, norm_groups=4),
], ids=["tiny", "three_levels"])
def test_vae_decode(cfg):
    params = jvae.init(jax.random.PRNGKey(5), cfg)
    lat = np.random.default_rng(5).standard_normal(
        (2, 6, 5, cfg.latent_channels)).astype(np.float32)
    want = jvae.decode(params, jnp.asarray(lat), cfg)
    got = tvae.decode(_port(params), torch.from_numpy(lat),
                      bridge.config(cfg, tvae.VaeConfig))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, 5e-5)


# ---------------------------------------------------------------------------
# Flux MMDiT
# ---------------------------------------------------------------------------

HD128 = dataclasses.replace(jflux.TINY_FLUX, hidden=256, heads=2,
                            head_dim=128, depth_double=1, depth_single=1,
                            axes_dim=(16, 56, 56))


@pytest.mark.parametrize("cfg", [jflux.TINY_FLUX, HD128],
                         ids=["tiny", "head_dim128"])
def test_flux_apply(cfg):
    params = jflux.init(jax.random.PRNGKey(6), cfg)
    rng = np.random.default_rng(6)
    gh, gw, s_txt = 3, 4, 5
    img = _randn(rng, 2, gh * gw, cfg.in_channels)
    txt = _randn(rng, 2, s_txt, cfg.text_dim)
    pooled = _randn(rng, 2, cfg.pooled_dim)
    t = np.asarray([0.9, 0.3], np.float32)
    guid = np.asarray([2.5, 2.5], np.float32)
    img_ids = jflux.make_image_ids(gh, gw)
    txt_ids = jflux.make_text_ids(s_txt)
    want = jflux.apply(params, jnp.asarray(img), jnp.asarray(txt),
                       jnp.asarray(pooled), jnp.asarray(t),
                       jnp.asarray(img_ids), jnp.asarray(txt_ids), cfg,
                       guidance=jnp.asarray(guid))
    got = tflux.apply(_port(params), torch.from_numpy(img),
                      torch.from_numpy(txt), torch.from_numpy(pooled),
                      torch.from_numpy(t), torch.from_numpy(img_ids),
                      torch.from_numpy(txt_ids),
                      bridge.config(cfg, tflux.FluxConfig),
                      guidance=torch.from_numpy(guid))
    assert tuple(got.shape) == (2, gh * gw, cfg.out_channels)
    _close(got, want, 1e-4)


def test_flux_embeddings_and_ids():
    t = np.asarray([0.0, 0.25, 1.0], np.float32)
    _close(tflux.timestep_embedding(torch.from_numpy(t), 32),
           jflux.timestep_embedding(jnp.asarray(t), 32), 1e-5)
    ids = np.concatenate([jflux.make_text_ids(3),
                          jflux.make_image_ids(4, 5)])
    np.testing.assert_array_equal(tflux.make_image_ids(4, 5),
                                  jflux.make_image_ids(4, 5))
    for g, w in zip(tflux.rope_cos_sin(torch.from_numpy(ids),
                                       (16, 56, 56), 10000),
                    jflux.rope_cos_sin(jnp.asarray(ids), (16, 56, 56),
                                       10000)):
        _close(g, w, 1e-5)


def test_pack_unpack_latents():
    lat = np.random.default_rng(7).standard_normal(
        (2, 6, 8, 4)).astype(np.float32)
    packed = tflux.pack_latents(torch.from_numpy(lat))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jflux.pack_latents(jnp.asarray(lat))))
    np.testing.assert_array_equal(
        tflux.unpack_latents(packed, 3, 4).numpy(), lat)


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    dict(num_steps=50, image_seq_len=4096),
    dict(num_steps=4, image_seq_len=16, base_shift=0.4, max_shift=1.2),
    dict(num_steps=8, use_dynamic_shifting=False, strength=0.5),
])
def test_make_schedule(kwargs):
    np.testing.assert_array_equal(tsched.make_schedule(**kwargs).sigmas,
                                  jsched.make_schedule(**kwargs).sigmas)


def test_euler_step_updates_in_f32_and_casts_back():
    rng = np.random.default_rng(8)
    x, v = _randn(rng, 2, 7, 4), _randn(rng, 2, 7, 4)
    sig = np.asarray([0.73, 0.41], np.float32)
    want = jsched.euler_step(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(v, jnp.bfloat16),
                             jnp.asarray(sig[0]), jnp.asarray(sig[1]))
    got = tsched.euler_step(torch.from_numpy(x).to(torch.bfloat16),
                            torch.from_numpy(v).to(torch.bfloat16),
                            torch.from_numpy(sig[:1])[0],
                            torch.from_numpy(sig[1:])[0])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
