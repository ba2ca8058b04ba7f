"""Seeded parity: the port's run-time draws are the JAX package's.

Every draw of the port made from a seed or a key goes through
``core.prng`` (threefry2x32, as ``jax.random``), so with no ``noise=``,
``probe_noise=``, ``t=`` or ``eps=`` handed in, the port matches the JAX
package from the seed alone. On the JAX tiny configs' weights
(``bridge``), on the CPU:

- ``generate(seed=...)`` and ``fill_batch(seeds)``: uint8 within 1 level,
  the limit of ``test_torch_generate.py`` / ``test_torch_fill.py`` with
  injected noise;
- the ``"auto"`` and ``"sched:2"`` calibrations from the seed's probe:
  JAX's intervals and anchors, the divergence curve within 1e-4;
- ``flow_match_loss(key)`` on f32 and bf16 batches: the loss within 1e-5,
  each gradient leaf within 1e-4 in relative norm;
- ``fit(seed=0)`` over 2 steps: losses within 1e-5, params within 1e-4 in
  relative norm (their updates within 1e-3);
- ``latent_batches_from_images(key)``: JAX's images, batch after batch,
  with and without replacement;
- ``vae.encode(key=)``: within 1e-4 of JAX's sample.

A ``torch.Generator`` in any key slot raises ``TypeError``.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from domainrag_tpu.core import imaging as jimaging
from domainrag_tpu.models.flux import model as jflux
from domainrag_tpu.models.flux import pipeline as jfp
from domainrag_tpu.models.flux import vae as jvae
from domainrag_tpu.parallel import mesh as jmesh
from domainrag_tpu.train import flow_match as jflow
from domainrag_tpu.train import loop as jloop
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.core import imaging as timaging
from domainrag_tpu_torch.core import prng
from domainrag_tpu_torch.models.flux import model as tflux
from domainrag_tpu_torch.models.flux import pipeline as tfp
from domainrag_tpu_torch.models.flux import vae as tvae
from domainrag_tpu_torch.train import flow_match as tflow
from domainrag_tpu_torch.train import loop as tloop
from test_torch_fill import _fill_inputs, port_bundle
from test_torch_train import (CONFIG_IDS, CONFIGS, _batch, _np, _paths, _port,
                              _rel)
from test_torch_train_bf16 import LANES
from test_torch_vcache import _budgets, _curve, _t

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

SIZE, STEPS = 32, 4


def _uint8_close(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# stage 3 and stage 4 from seeds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gen():
    jb = jfp.tiny_bundle(jax.random.PRNGKey(21))
    return jb, port_bundle(jb, fill=False)


@pytest.fixture(scope="module")
def prior(gen):
    jb, _ = gen
    size = jb.siglip_cfg.image_size
    uniq = np.random.default_rng(23).uniform(
        -1, 1, (3, size, size, 3)).astype(np.float32)
    return jfp.redux_prior_pairs_indexed(
        jb, uniq, np.asarray([[0, 2], [1, 2]]), "", [0.8, 1.0], [1.0, 1.0])


@pytest.mark.parametrize("seed", [[0, 1], [2 ** 31 - 1, 123], 7],
                         ids=["0_1", "wide", "one_seed"])
def test_generate_from_seeds_matches_jax(gen, prior, seed):
    jb, tb = gen
    je, jp = prior
    kw = dict(height=SIZE, width=SIZE, num_steps=STEPS, seed=seed)
    _uint8_close(tfp.generate(tb, _t(je), _t(jp), **kw),
                 jfp.generate(jb, je, jp, **kw))


def test_a_seed_draws_the_same_image_in_any_batch(gen, prior, monkeypatch):
    """A sample's noise is its seed's draw and its conditioning vector is
    computed one sample at a time, so a batch's denoised latents and
    images are each row's alone, bit for bit (what a data-parallel rank's
    rows rely on)."""
    _, tb = gen
    te, tp = (_t(x) for x in prior)
    latents = []
    decode = tfp._decode_tokens

    def keep(vae_params, tokens, *args, **kwargs):
        latents.append(tokens.clone())
        return decode(vae_params, tokens, *args, **kwargs)

    monkeypatch.setattr(tfp, "_decode_tokens", keep)
    kw = dict(height=SIZE, width=SIZE, num_steps=STEPS)
    batch = tfp.generate(tb, te, tp, seed=[5, 6], **kw)
    rows = np.stack([tfp.generate(tb, te[i:i + 1], tp[i:i + 1], seed=s, **kw)
                     for i, s in enumerate([5, 6])])
    assert torch.equal(latents[0], torch.cat(latents[1:]))
    np.testing.assert_array_equal(batch, rows)


def test_noise_is_jax_noise(gen):
    """The per-seed noise itself: f32 normals within 4 ulp of JAX's."""
    jb, tb = gen
    seq, c = 16, jb.vae_cfg.latent_channels * 4
    got = tfp._noise(tb, [0, 9], seq, c).numpy()
    want = np.stack([np.asarray(jax.random.normal(jax.random.PRNGKey(s),
                                                  (seq, c), jnp.float32))
                     for s in (0, 9)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["velocity", "residual"])
def test_auto_calibration_from_the_seed_matches_jax(gen, prior, caplog,
                                                    mode):
    """No ``probe_noise``: the probe is the seed's draw in both packages,
    so the curve agrees within 1e-4 (the log's rounding) and every budget
    away from it picks JAX's interval."""
    jb, tb = gen
    je, jp = prior
    args = (SIZE, SIZE, STEPS, 2.5)
    caplog.set_level(logging.INFO)
    jfp.calibrate_block_cache_interval(jb, je, jp, *args, seed=3, mode=mode)
    want_curve = _curve(caplog, "domainrag_tpu.flux")
    tfp.calibrate_block_cache_interval(tb, _t(je), _t(jp), *args, seed=3,
                                       mode=mode)
    got_curve = _curve(caplog, "domainrag_tpu_torch.flux")
    assert got_curve.keys() == want_curve.keys() == {2, 3, 4}
    for k in want_curve:
        for s in ("latent", "image"):
            assert abs(got_curve[k][s] - want_curve[k][s]) <= 1e-4 + 1e-9
    for budget in _budgets(want_curve, "image")[1:-1]:
        kw = dict(seed=3, mode=mode, divergence_budget=budget)
        assert tfp.calibrate_block_cache_interval(
            tb, _t(je), _t(jp), *args, **kw) == \
            jfp.calibrate_block_cache_interval(jb, je, jp, *args, **kw), \
            budget


def test_sched_anchors_from_the_seed_match_jax(gen, prior):
    jb, tb = gen
    je, jp = prior
    args = (SIZE, SIZE, 6, 2.5)
    want = jfp._resolve_block_cache_interval(jb, "sched:2", je, jp, *args,
                                             mode="velocity")
    got = tfp._resolve_block_cache_interval(tb, "sched:2", _t(je), _t(jp),
                                            *args, mode="velocity")
    assert got == want and len(got) == 3


@pytest.fixture(scope="module")
def fills():
    jb = jfp.tiny_bundle(jax.random.PRNGKey(22), fill=True)
    return jb, port_bundle(jb)


@pytest.mark.parametrize("kwargs", [
    dict(seeds=[0, 1]), dict(seeds=[5, 2 ** 31 - 1]),
    dict(seeds=[0, 1], velocity_cache_interval="auto"),
    dict(seeds=[4, 4], velocity_cache_interval="sched:2", num_steps=6)],
    ids=["0_1", "wide", "vcache_auto", "vcache_sched2"])
def test_fill_from_seeds_matches_jax(fills, kwargs):
    jb, tb = fills
    images, masks, je, jp = _fill_inputs(jb, seed=2)
    kw = {"num_steps": STEPS, "strength": 0.75, **kwargs}
    _uint8_close(tfp.fill_batch(tb, images, masks, _t(je), _t(jp), **kw),
                 jfp.fill_batch(jb, images, masks, je, jp, **kw))


# ---------------------------------------------------------------------------
# the VAE's posterior sample
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 31])
def test_vae_encode_samples_jax_posterior(seed):
    jp = jvae.init(jax.random.PRNGKey(9), jvae.TINY_VAE)
    tp = bridge.params(jax.tree.map(np.asarray, jp), device="cpu")
    cfg = bridge.config(jvae.TINY_VAE, tvae.VaeConfig)
    x = np.random.default_rng(seed).uniform(
        -1, 1, (2, 16, 24, 3)).astype(np.float32)
    want = np.asarray(jvae.encode(jp, jnp.asarray(x), jvae.TINY_VAE,
                                  key=jax.random.PRNGKey(seed)))
    got = tvae.encode(tp, torch.from_numpy(x), cfg, key=prng.PRNGKey(seed))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    mode = np.asarray(jvae.encode(jp, jnp.asarray(x), jvae.TINY_VAE))
    assert np.abs(want - mode).max() > 1e-2          # a sample was drawn


# ---------------------------------------------------------------------------
# the trainer from keys
# ---------------------------------------------------------------------------

def _grads_close(params, got, want):
    want = jax.tree.leaves(jax.tree.map(np.asarray, want))
    # the port's leaf order is the tree's; JAX sorts dict keys
    flat = sorted(zip(_paths(_np(params)), got), key=lambda x: x[0])
    assert len(flat) == len(want)
    for (path, g), w in zip(flat, want):
        assert _rel(g.numpy(), w) < 1e-4, (path, _rel(g.numpy(), w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_flow_match_loss_from_a_key_matches_jax(cfg, dtype):
    """t and eps drawn from the key in both packages (eps in the batch's
    dtype, bf16 normals included)."""
    params = jflux.init(jax.random.PRNGKey(24), cfg)
    batch = _batch(cfg, seed=4)
    jdt = getattr(jnp, dtype)
    jbatch = {k: jnp.asarray(v, jdt) if k in LANES else jnp.asarray(v)
              for k, v in batch.items()}
    train_cfg = jflow.TrainConfig(remat=False)
    want_loss, want = jax.value_and_grad(jflow.flow_match_loss)(
        params, jbatch, jax.random.PRNGKey(25), cfg, train_cfg)
    tbatch = {k: torch.from_numpy(np.asarray(v, np.float32))
              for k, v in jbatch.items()}
    for k in LANES:
        tbatch[k] = tbatch[k].to(getattr(torch, dtype))   # exact
    tparams = _port(params)
    leaves = tflow.leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss = tflow.flow_match_loss(
        tparams, tbatch, prng.PRNGKey(25),
        bridge.config(cfg, tflux.FluxConfig),
        bridge.config(train_cfg, tflow.TrainConfig))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _grads_close(params, torch.autograd.grad(loss, leaves), want)


def test_sample_timesteps_is_jax_draw():
    cfg = jflow.TrainConfig(t_mean=0.5, t_std=2.0)
    want = np.asarray(jflow.sample_timesteps(jax.random.PRNGKey(3), 4096,
                                             cfg))
    got = tflow.sample_timesteps(prng.PRNGKey(3), 4096,
                                 bridge.config(cfg, tflow.TrainConfig))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_fit_from_a_seed_matches_jax():
    """Two steps of ``fit(seed=0)`` on the JAX tiny config: JAX's key
    chain (PRNGKey(0), split per step) draws t and eps in both."""
    cfg = jflux.TINY_FLUX
    params = jax.tree.map(np.asarray, jflux.init(jax.random.PRNGKey(26),
                                                 cfg))
    batches = [{k: np.asarray(v) for k, v in _batch(cfg, seed=30 + i).items()}
               for i in range(2)]
    train_cfg = jflow.TrainConfig(learning_rate=1e-3, remat=False)
    jfinal, jlosses = jloop.fit(
        params, cfg, iter(batches), 2, train_cfg,
        mesh=jmesh.create_mesh(devices=jax.devices()[:1]), seed=0,
        log_every=2)
    final, losses = tloop.fit(
        bridge.params(params, device="cpu"),
        bridge.config(cfg, tflux.FluxConfig),
        [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches],
        2, bridge.config(train_cfg, tflow.TrainConfig), seed=0, log_every=2)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    want = _port(jax.device_get(jfinal))
    start = tflow.leaves(_port(params))
    for got, w, p0 in zip(tflow.leaves(final), tflow.leaves(want), start):
        got = got.detach()
        assert _rel(got.numpy(), w.numpy()) < 1e-4
        # the two steps' updates themselves, as test_train_step_matches_jax
        assert _rel((got - p0).numpy(), (w - p0).numpy()) < 1e-3


@pytest.mark.parametrize("n_images,batch_size", [(5, 3), (3, 5)],
                         ids=["without_replacement", "with_replacement"])
def test_latent_batches_pick_jax_images(tmp_path, monkeypatch, n_images,
                                        batch_size):
    """Three batches in a row pick JAX's images from the same key (with
    replacement when the directory holds fewer than a batch), and their
    latents agree within 1e-4."""
    from test_torch_generate import _port_bundle
    jb = jfp.tiny_bundle(jax.random.PRNGKey(0))
    tb = _port_bundle(jb)
    rng = np.random.default_rng(27)
    for i in range(n_images):
        Image.fromarray(rng.integers(0, 255, (16, 16, 3), np.uint8)).save(
            tmp_path / f"{i}.png")
    picked = {"jax": [], "port": []}
    for mod, name in ((jimaging, "jax"), (timaging, "port")):
        def load(path, _real=mod.load_rgb, _out=picked[name]):
            _out.append(path)
            return _real(path)
        monkeypatch.setattr(mod, "load_rgb", load)
    want = jloop.latent_batches_from_images(
        [str(tmp_path)], jb.vae_params, jb.vae_cfg, jb, batch_size,
        jax.random.PRNGKey(28))
    got = tloop.latent_batches_from_images(
        [str(tmp_path)], tb.vae_params, tb.vae_cfg, tb, batch_size,
        prng.PRNGKey(28))
    for _ in range(3):
        w, g = next(want), next(got)
        np.testing.assert_allclose(g["x0"].numpy(), np.asarray(w["x0"]),
                                   rtol=1e-4, atol=1e-4)
    assert picked["port"] == picked["jax"]
    assert len(picked["jax"]) == 3 * batch_size
    if n_images < batch_size:
        assert len(set(picked["jax"][:batch_size])) < batch_size
    else:
        for i in range(3):
            one = picked["jax"][i * batch_size:(i + 1) * batch_size]
            assert len(set(one)) == batch_size


# ---------------------------------------------------------------------------
# a generator is not a key
# ---------------------------------------------------------------------------

def _key_slot_calls():
    cfg = bridge.config(jflux.TINY_FLUX, tflux.FluxConfig)
    vcfg = bridge.config(jvae.TINY_VAE, tvae.VaeConfig)
    vp = bridge.params(jax.tree.map(
        np.asarray, jvae.init(jax.random.PRNGKey(9), jvae.TINY_VAE)),
        device="cpu")
    params = _port(jflux.init(jax.random.PRNGKey(1), jflux.TINY_FLUX))
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in _batch(jflux.TINY_FLUX).items()}
    img = torch.zeros((1, 16, 16, 3))
    tc = tflow.TrainConfig()
    step, sp, opt = tflow.make_train_step(cfg, tc, params)
    optimizer = tflow.make_optimizer(tc)
    return {
        "encode": lambda g: tvae.encode(vp, img, vcfg, g),
        "encode_tiled": lambda g: tvae.encode_tiled(vp, img, vcfg, 1, 0, g),
        "sample_timesteps": lambda g: tflow.sample_timesteps(g, 2, tc),
        "flow_match_loss": lambda g: tflow.flow_match_loss(params, batch, g,
                                                           cfg, tc),
        "train_step": lambda g: tflow.train_step(
            params, optimizer.init(params), batch, g, cfg, tc, optimizer),
        "make_train_step": lambda g: step(sp, opt, batch, g),
        "latent_batches_from_images": lambda g: next(
            tloop.latent_batches_from_images([], vp, vcfg, None, 2, g)),
    }


SLOTS = ["encode", "encode_tiled", "sample_timesteps", "flow_match_loss",
         "train_step", "make_train_step", "latent_batches_from_images"]


@pytest.fixture(scope="module")
def key_slot_calls():
    return _key_slot_calls()


@pytest.mark.parametrize("slot", SLOTS)
def test_a_generator_in_a_key_slot_raises(key_slot_calls, slot):
    with pytest.raises(TypeError, match="prng.PRNGKey"):
        key_slot_calls[slot](torch.Generator().manual_seed(0))
