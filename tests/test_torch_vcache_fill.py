"""``fill_batch``'s velocity cache against the JAX package's on the JAX
tiny Fill bundle's weights with the JAX noise: every interval form (hires
with the tiled VAE too) within 1 uint8 level, and the fill calibrations'
anchors, curves and intervals. Helpers are ``test_torch_vcache``'s.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu.models.flux import pipeline as jfp
from domainrag_tpu.models.flux import scheduler as jsched
from domainrag_tpu_torch.models.flux import pipeline as tfp
from test_torch_fill import port_bundle
from test_torch_vcache import SEEDS, SIZE, _budgets, _curve, _jax_noise, _t

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fills():
    jb = jfp.tiny_bundle(jax.random.PRNGKey(3), fill=True)
    return jb, port_bundle(jb)


# ---------------------------------------------------------------------------
# fill_batch
# ---------------------------------------------------------------------------

def _fill_inputs(jb, seed=0, n=2):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (n, SIZE, SIZE, 3), dtype=np.uint8)
    masks = np.full((n, SIZE, SIZE), 255, np.uint8)
    masks[:, :SIZE // 2, :SIZE // 2] = 0
    size = jb.siglip_cfg.image_size
    e, p = jfp.redux_prior_pairs(
        jb, rng.standard_normal((n, 1, size, size, 3)).astype(np.float32),
        "bg", [1.0], [1.0])
    return images, masks, e, p


FILL_FORMS = {"int2": dict(velocity_cache_interval=2),
              "tuple": dict(velocity_cache_interval=(0, 2, 3)),
              "auto": dict(velocity_cache_interval="auto"),
              "auto_loose": dict(velocity_cache_interval="auto",
                                 vcache_divergence_budget=1e9),
              "sched2": dict(velocity_cache_interval="sched:2"),
              "sched2_hires": dict(velocity_cache_interval="sched:2",
                                   hires_threshold_px=1, vae_tile=6,
                                   vae_overlap=2),
              "int2_hires_order0": dict(velocity_cache_interval=2,
                                        velocity_cache_order=0,
                                        hires_threshold_px=1, vae_tile=6,
                                        vae_overlap=2)}


@pytest.mark.parametrize("name", sorted(FILL_FORMS))
def test_fill_vcache_matches_jax(fills, name):
    jb, tb = fills
    images, masks, je, jp = _fill_inputs(jb)
    kw = dict(num_steps=6, guidance=30.0, strength=0.85, seeds=SEEDS,
              **FILL_FORMS[name])
    want = jfp.fill_batch(jb, images, masks, je, jp, **kw)
    got = tfp.fill_batch(tb, images, masks, _t(je), _t(jp),
                         noise=_t(_jax_noise(jb, SEEDS)), **kw)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_fill_calibrations_match_jax(fills, caplog):
    """The fill calibration's result on the same sample: ``sched:2``'s
    anchors, and ``auto``'s curve (within 1e-4) and interval at budgets
    away from the curve."""
    jb, tb = fills
    images, masks, je, jp = _fill_inputs(jb, seed=1)
    n, lf = 6, jb.latent_factor      # test_fill_vcache_matches_jax's
    sig = jsched.make_schedule(n, image_seq_len=(SIZE // lf) ** 2,
                               strength=0.85).sigmas
    noise = _jax_noise(jb, [5])
    img = jfp.from_uint8(images[:1])
    m = ((masks[:1].astype(np.float32) / 255.0) > 0.5).astype(np.float32)
    jargs = (jb, jnp.asarray(img), jnp.asarray(m), noise, je[:1], jp[:1],
             jnp.asarray(sig), 30.0, SIZE // lf, SIZE // lf)
    targs = (tb, _t(img), _t(m), _t(noise), _t(je[:1]), _t(jp[:1]),
             _t(sig), 30.0, SIZE // lf, SIZE // lf)
    assert tfp.calibrate_fill_vcache(*targs, form="sched:2") == \
        jfp.calibrate_fill_vcache(*jargs, form="sched:2")
    caplog.set_level(logging.INFO)
    jfp.calibrate_fill_vcache(*jargs, form="auto")
    want_curve = _curve(caplog, "domainrag_tpu.flux")
    tfp.calibrate_fill_vcache(*targs, form="auto")
    got_curve = _curve(caplog, "domainrag_tpu_torch.flux")
    assert got_curve.keys() == want_curve.keys() == {2, 3, 4}
    for k in want_curve:
        for s in ("latent", "image"):
            assert abs(got_curve[k][s] - want_curve[k][s]) <= 1e-4 + 1e-9
    for budget in _budgets(want_curve, "image"):
        assert tfp.calibrate_fill_vcache(
            *targs, form="auto", divergence_budget=budget) == \
            jfp.calibrate_fill_vcache(*jargs, form="auto",
                                      divergence_budget=budget), budget


def test_fill_calibration_cached_and_strength_keyed(fills, monkeypatch):
    jb, tb = fills
    images, masks, je, jp = _fill_inputs(jb, seed=2)
    calls = []
    real = tfp.calibrate_fill_vcache

    def counting(*a, **k):
        calls.append(k.get("form"))
        return real(*a, **k)

    monkeypatch.setattr(tfp, "calibrate_fill_vcache", counting)
    kw = dict(num_steps=5, guidance=30.0, seeds=SEEDS,
              velocity_cache_interval="sched:2")
    for strength in (0.9, 0.9, 0.7):
        tfp.fill_batch(tb, images, masks, _t(je), _t(jp), strength=strength,
                       **kw)
    assert calls == ["sched:2", "sched:2"]


def test_fill_unknown_string_matches_jax(fills):
    jb, tb = fills
    images, masks, je, jp = _fill_inputs(jb)
    with pytest.raises(ValueError) as want:
        jfp.fill_batch(jb, images, masks, je, jp, num_steps=4,
                       velocity_cache_interval="fast")
    with pytest.raises(ValueError) as got:
        tfp.fill_batch(tb, images, masks, _t(je), _t(jp), num_steps=4,
                       velocity_cache_interval="fast")
    assert str(got.value) == str(want.value)
    assert "'auto' or 'sched:K'" in str(got.value)
