"""The port's stage-4 fill end to end against the JAX package's, over the
whole and the tiled (hires) VAE routes: the f32 fill core (4 Euler steps,
strength-trimmed) at 1e-3 on the [-1, 1] image, and ``fill_batch``'s
uint8 image within 1 level (a value on a rounding edge may land on either
side). Helpers and the bundles are ``test_torch_fill``'s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu.models.flux import pipeline as jfp
from domainrag_tpu.models.flux import scheduler as jsched
from domainrag_tpu_torch.core.log import StepTimer
from domainrag_tpu_torch.models.flux import pipeline as tfp
from test_torch_fill import (SEEDS, SIZE, STEPS, _fill_inputs, _t,  # noqa: F401
                             bundles, jax_noise)

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)


ROUTES = {"lowres": dict(hires_threshold_px=0, vae_tile=96, vae_overlap=16),
          "hires": dict(hires_threshold_px=1, vae_tile=6, vae_overlap=2)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_fill_float_matches_jax(bundles, route):
    jb, tb = bundles
    kw = ROUTES[route]
    images, masks, je, jp = _fill_inputs(jb)
    sigmas = jsched.make_schedule(
        STEPS, image_seq_len=(SIZE // jb.latent_factor) ** 2,
        strength=0.6).sigmas
    img = jfp.from_uint8(images)
    m = (masks.astype(np.float32) / 255.0 > 0.5).astype(np.float32)
    noise = jax_noise(jb, SEEDS)
    hires = kw["hires_threshold_px"] > 0
    want = jfp._fill_core(
        jb.flux_params, jb.vae_params, jnp.asarray(img), jnp.asarray(m),
        noise, je, jp, jnp.asarray(sigmas), jnp.float32(30.0),
        cfg=jb.flux_cfg, vae_cfg=jb.vae_cfg, grid_h=SIZE // jb.latent_factor,
        grid_w=SIZE // jb.latent_factor, tiled_vae=hires,
        vae_tile=kw["vae_tile"], vae_overlap=kw["vae_overlap"])
    timer = StepTimer()
    got = tfp._fill_float(tb, _t(img), _t(m), _t(noise), _t(je), _t(jp),
                          torch.tensor(sigmas), 30.0, hires, kw["vae_tile"],
                          kw["vae_overlap"], timer)
    assert tuple(got.shape) == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=0)
    # strength 0.6 of 4 steps keeps 2 denoise steps
    assert timer.counts == {"encode": 2, "step": 2, "decode": 1}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_fill_batch_uint8_matches_jax(bundles, route):
    jb, tb = bundles
    kw = dict(ROUTES[route], num_steps=STEPS, guidance=30.0, strength=0.6,
              seeds=SEEDS)
    images, masks, je, jp = _fill_inputs(jb, seed=1)
    want = jfp.fill_batch(jb, images, masks, je, jp, **kw)
    got = tfp.fill_batch(tb, images, masks, _t(je), _t(jp),
                         noise=_t(jax_noise(jb, SEEDS)), **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
