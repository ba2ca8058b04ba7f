"""The calibrated intervals of ``generate``'s caches (velocity and
residual, image and latent divergence) against the JAX package's on the
JAX tiny bundle's weights, with the JAX probe latents patched in: the same
interval and divergence curve (within 1e-4, the log's rounding); and the
cache arguments' ``ValueError`` texts are JAX's. Helpers and fixtures are
``test_torch_vcache``'s.
"""

import gc
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu.models.flux import pipeline as jfp
from domainrag_tpu_torch.core import prng
from domainrag_tpu_torch.models.flux import pipeline as tfp
from test_torch_vcache import (SEEDS, SIZE, STEPS, _budgets,  # noqa: F401
                               _curve, _t, gen, prior)

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["velocity", "residual"])
@pytest.mark.parametrize("space", ["image", "latent"])
def test_calibrated_interval_matches_jax(gen, prior, caplog, mode, space):
    jb, tb = gen
    je, jp = prior
    probe = jax.random.normal(jax.random.PRNGKey(0),
                              (1, (SIZE // jb.latent_factor) ** 2,
                               jb.vae_cfg.latent_channels * 4), jnp.float32)
    caplog.set_level(logging.INFO)
    args = (SIZE, SIZE, STEPS, 2.5)   # the generate tests' shapes
    jfp.calibrate_block_cache_interval(jb, je, jp, *args, mode=mode,
                                       budget_space=space)
    want_curve = _curve(caplog, "domainrag_tpu.flux")
    tfp.calibrate_block_cache_interval(tb, _t(je), _t(jp), *args, mode=mode,
                                       budget_space=space,
                                       probe_noise=_t(probe))
    got_curve = _curve(caplog, "domainrag_tpu_torch.flux")
    assert got_curve.keys() == want_curve.keys() == {2, 3, 4}
    for k in want_curve:
        for s in ("latent", "image"):
            assert abs(got_curve[k][s] - want_curve[k][s]) <= 1e-4 + 1e-9
    for budget in _budgets(want_curve, space):
        kw = dict(mode=mode, budget_space=space, divergence_budget=budget)
        assert tfp.calibrate_block_cache_interval(
            tb, _t(je), _t(jp), *args, probe_noise=_t(probe), **kw) == \
            jfp.calibrate_block_cache_interval(jb, je, jp, *args, **kw), \
            budget


def test_calibration_never_shared_across_bundles(prior):
    """Two bundles made one after the other get their own calibration
    entries even when the first was collected (the cache key holds a
    weakref-guarded token, not an ``id``); swapping a live bundle's
    params makes a new token."""
    te, tp = _t(prior[0]), _t(prior[1])

    def one(seed):
        b = tfp.tiny_bundle(prng.PRNGKey(seed), device="cpu")
        tfp.generate(b, te, tp, height=16, width=16, num_steps=4,
                     seed=[0, 1], velocity_cache_interval="sched:2")
        tok = tfp._params_token(b)
        del b
        gc.collect()
        return tok

    before = len(tfp._VCACHE_SCHEDULES)
    assert one(11) is not one(12)
    assert len(tfp._VCACHE_SCHEDULES) == before + 2
    b = tfp.tiny_bundle(prng.PRNGKey(13), device="cpu")
    t0 = tfp._params_token(b)
    assert tfp._params_token(b) is t0
    b.flux_params = {k: v for k, v in b.flux_params.items()}
    assert tfp._params_token(b) is t0          # the same tensors
    b.flux_params["img_in"] = {k: v + 0 for k, v in
                               b.flux_params["img_in"].items()}
    assert tfp._params_token(b) is not t0


def test_cache_value_errors_match_jax(gen, prior):
    jb, tb = gen
    je, jp = prior
    base = dict(height=16, width=16, num_steps=4, seed=SEEDS)
    for kw in (dict(block_cache_interval=2, velocity_cache_interval=2),
               dict(block_cache_interval=2, velocity_cache_interval=(0, 2)),
               dict(block_cache_interval=(0, 2)),
               dict(block_cache_interval="sched:2")):
        with pytest.raises(ValueError) as want:
            jfp.generate(jb, je, jp, **base, **kw)
        with pytest.raises(ValueError) as got:
            tfp.generate(tb, _t(je), _t(jp), **base, **kw)
        assert str(got.value) == str(want.value), kw
