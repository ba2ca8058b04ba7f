"""The port's velocity-extrapolation cache against the JAX package's.

- ``_vcache_denoise`` on synthetic velocity fields (constant, linear and
  curved in sigma), every (steps, interval) and order, within 1e-6 of the
  JAX loop on the same f32 inputs; uniform spelled as anchors is bit-equal
  to the int form; the anchors' ``ValueError`` texts are JAX's.
- ``plan_vcache_anchors`` and ``select_vcache_anchors`` (numpy): the same
  tuples as JAX's.
- ``generate`` and ``fill_batch`` on the JAX tiny bundles' weights
  (``bridge``) with the JAX noise, and the JAX probe latents patched into
  ``pipeline._noise``: the f32 image within 1e-3 and uint8 within 1 level
  (as ``test_generate_float_matches_jax``), for interval 2 at order 0 and
  1, an anchor tuple, ``"auto"`` and ``"sched:2"``, and a hires (tiled
  VAE) fill; the calibrations choose JAX's interval or anchors, with the
  budgets set away from the divergence curve, whose values agree within
  1e-4 (the log's rounding).

The calibrations of ``generate`` are in ``test_torch_vcache_calib.py``,
``fill_batch`` in ``test_torch_vcache_fill.py``; both take this file's
helpers.
"""

import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu.models.flux import pipeline as jfp
from domainrag_tpu.models.flux import scheduler as jsched
from domainrag_tpu_torch.models.flux import pipeline as tfp
from test_torch_fill import port_bundle

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

SIZE = 32
STEPS = 4
SEEDS = [0, 1]


@pytest.fixture(scope="module")
def gen():
    jb = jfp.tiny_bundle(jax.random.PRNGKey(0))
    return jb, port_bundle(jb, fill=False)


@pytest.fixture(scope="module")
def prior(gen):
    jb, _ = gen
    size = jb.siglip_cfg.image_size
    uniq = np.random.default_rng(3).uniform(
        -1, 1, (3, size, size, 3)).astype(np.float32)
    return jfp.redux_prior_pairs_indexed(
        jb, uniq, np.asarray([[0, 2], [1, 2]]), "", [0.8, 1.0], [1.0, 1.0])


def _t(x):
    return torch.tensor(np.asarray(x))


def _jax_noise(jb, seeds, h=SIZE, w=SIZE):
    seq = (h // jb.latent_factor) * (w // jb.latent_factor)
    c = jb.vae_cfg.latent_channels * 4
    return jnp.stack([jax.random.normal(jax.random.PRNGKey(s), (seq, c),
                                        jnp.float32) for s in seeds])


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's per-seed draw (``generate``'s noise and the
    calibrations' probe latents) replaced by ``jax.random.normal``."""
    def draw(bundle, seeds, seq, c):
        return torch.stack([_t(jax.random.normal(jax.random.PRNGKey(s),
                                                 (seq, c), jnp.float32))
                            for s in seeds]).to(bundle.device)
    monkeypatch.setattr(tfp, "_noise", draw)


def _curve(caplog, logger):
    """The divergence curve of the last calibration ``logger`` logged."""
    msgs = [r.getMessage() for r in caplog.records if r.name == logger
            and "divergence" in r.getMessage()]
    text = msgs[-1]
    return ast.literal_eval(text[text.index("divergence ") + 11:
                                 text.index(", budget")])


# ---------------------------------------------------------------------------
# the cached loop on synthetic fields
# ---------------------------------------------------------------------------

def _field(kind):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, 8, 4)).astype(np.float32)
    b = rng.standard_normal((2, 8, 4)).astype(np.float32)
    if kind == "constant":
        return (lambda x, s: jnp.asarray(a)), (lambda x, s: _t(a))
    if kind == "linear":
        return ((lambda x, s: jnp.asarray(a) + jnp.asarray(b) * s),
                (lambda x, s: _t(a) + _t(b) * s))
    # curved: bends sharply near sigma 0.2, and depends on the state
    return ((lambda x, s: jnp.tanh((0.2 - s) * 25.0) * jnp.asarray(a)
             + 0.1 * x),
            (lambda x, s: torch.tanh((0.2 - s) * 25.0) * _t(a) + 0.1 * x))


@pytest.mark.parametrize("steps,interval", [(4, 2), (5, 2), (7, 3), (4, 4),
                                            (12, 3)])
@pytest.mark.parametrize("kind", ["constant", "linear", "curved"])
def test_vcache_denoise_matches_jax(kind, steps, interval):
    jfn, tfn = _field(kind)
    sig = np.linspace(1.0, 0.0, steps + 1).astype(np.float32)
    x0 = np.random.default_rng(2).standard_normal((2, 8, 4)).astype(
        np.float32)
    for order in (0, 1):
        want = jfp._vcache_denoise(jfn, jnp.asarray(x0), jnp.asarray(sig),
                                   interval=interval, order=order)
        got = tfp._vcache_denoise(tfn, _t(x0), _t(sig), interval=interval,
                                  order=order)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_anchor_tuples_match_jax_and_uniform_is_bit_equal():
    jfn, tfn = _field("curved")
    sig = np.linspace(1.0, 0.0, 8).astype(np.float32)         # 7 steps
    x0 = np.random.default_rng(4).standard_normal((2, 8, 4)).astype(
        np.float32)
    uniform = tfp._vcache_denoise(tfn, _t(x0), _t(sig), interval=3)
    spelled = tfp._vcache_denoise(tfn, _t(x0), _t(sig), interval=0,
                                  anchors=(0, 3, 6))
    assert torch.equal(uniform, spelled)
    for anchors in ((0, 1, 5), (0, 4), (0, 2, 3, 6)):
        want = jfp._vcache_denoise(jfn, jnp.asarray(x0), jnp.asarray(sig),
                                   0, anchors=anchors)
        got = tfp._vcache_denoise(tfn, _t(x0), _t(sig), 0, anchors=anchors)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("anchors", [(1, 2), (0, 4)])
def test_anchor_validation_matches_jax(anchors):
    sig = np.linspace(1.0, 0.0, 5).astype(np.float32)         # 4 steps
    with pytest.raises(ValueError) as want:
        jfp._vcache_denoise(lambda x, s: x, jnp.zeros((1, 2)),
                            jnp.asarray(sig), 0, anchors=anchors)
    with pytest.raises(ValueError) as got:
        tfp._vcache_denoise(lambda x, s: x, torch.zeros((1, 2)), _t(sig),
                            0, anchors=anchors)
    assert str(got.value) == str(want.value)


def test_pick_denoise_and_step_spans():
    """One ``step`` span per Euler step, cached or not; the model runs at
    the anchors only; interval 1 is the dense loop."""
    from domainrag_tpu_torch.core.log import StepTimer
    calls = []

    def model_fn(x, s):
        calls.append(float(s))
        return torch.ones_like(x)

    sig = _t(np.linspace(1.0, 0.0, 6).astype(np.float32))    # 5 steps
    for form, n_calls in ((1, 5), (2, 3), ((0, 4), 2)):
        calls.clear()
        timer = StepTimer()
        tfp._pick_denoise(model_fn, torch.zeros(1, 3), sig, form, 1,
                          timer=timer)
        assert timer.counts == {"step": 5} and len(calls) == n_calls
    assert tfp._vc_active(2) and tfp._vc_active("auto")
    assert tfp._vc_active((0, 2)) and not tfp._vc_active(1)


# ---------------------------------------------------------------------------
# anchor planning and selection (numpy)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,order", [(6, 3, 1), (12, 4, 1), (12, 4, 0),
                                       (8, 1, 1), (8, 8, 1), (28, 10, 1)])
def test_plan_vcache_anchors_matches_jax(n, k, order):
    rng = np.random.default_rng(n * 10 + k)
    sig = np.asarray(jsched.make_schedule(n, image_seq_len=64).sigmas)
    vs = rng.standard_normal((n, 3, 4)).astype(np.float32) \
        + np.cumsum(rng.standard_normal((n, 1, 1)), 0).astype(np.float32)
    assert tfp.plan_vcache_anchors(vs, sig, k, order) == \
        jfp.plan_vcache_anchors(vs, sig, k, order)


def test_plan_vcache_anchors_curved_and_bounds():
    n = 12
    sig = np.linspace(1.0, 0.0, n + 1)
    vs = np.stack([np.array([np.tanh((0.2 - s) * 25.0), s])
                   for s in sig[:n]])[:, None, :]
    got = tfp.plan_vcache_anchors(vs, sig, 4)
    assert got == jfp.plan_vcache_anchors(vs, sig, 4) and got != (0, 3, 6, 9)
    with pytest.raises(ValueError, match="n_anchors"):
        tfp.plan_vcache_anchors(vs, sig, n + 1)


@pytest.mark.parametrize("winner", ["dp", "uniform"])
def test_select_vcache_anchors_matches_jax(winner):
    n = 6
    sig = np.linspace(1.0, 0.0, n + 1)
    vs = np.stack([np.full((1, 4), np.exp(-8 * (1 - s))) for s in sig[:n]])
    dp = tfp.plan_vcache_anchors(vs, sig, 3)
    pick = dp if winner == "dp" else (0, 2, 4)
    assert dp != (0, 2, 4)

    def probe(anchors):
        return np.full((2, 2), 0.1 if anchors == pick else 1.0)

    def decode(tokens):
        return np.asarray(tokens, np.float32)

    got = tfp.select_vcache_anchors(vs, sig, 3, 2, probe, decode,
                                    np.zeros((2, 2)))
    assert got == pick == jfp.select_vcache_anchors(
        vs, sig, 3, 2, probe, decode, np.zeros((2, 2)))

    def boom(*a):
        raise AssertionError("no probe when the schedules coincide")

    same = np.ones((2, 1, 3))
    assert tfp.select_vcache_anchors(same, np.linspace(1.0, 0.0, 3), 2, 1,
                                     boom, boom, None) == (0, 1)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", [2, 3, (0, 3), (0, 1, 2)],
                         ids=["int2", "int3", "anchors_0_3", "anchors_0_1_2"])
@pytest.mark.parametrize("order", [0, 1])
def test_generate_float_vcache_matches_jax(gen, prior, form, order):
    jb, tb = gen
    je, jp = prior
    lf = jb.latent_factor
    noise = _jax_noise(jb, SEEDS)
    sigmas = jsched.make_schedule(
        STEPS, image_seq_len=(SIZE // lf) ** 2).sigmas
    want = jfp._generate_core(
        jb.flux_params, jb.vae_params, noise, je, jp, jnp.asarray(sigmas),
        jnp.float32(2.5), cfg=jb.flux_cfg, vae_cfg=jb.vae_cfg,
        grid_h=SIZE // lf, grid_w=SIZE // lf, vcache_interval=form,
        vcache_order=order)
    got = tfp._generate_float(tb, _t(je), _t(jp), SIZE, SIZE, STEPS, 2.5,
                              _t(noise), vcache_interval=form,
                              vcache_order=order)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=0)


@pytest.mark.parametrize("form", [2, [0, 3], "auto", "sched:2"],
                         ids=["int", "list", "auto", "sched2"])
def test_generate_uint8_vcache_matches_jax(gen, prior, jax_draws, form):
    jb, tb = gen
    je, jp = prior
    kw = dict(height=SIZE, width=SIZE, num_steps=STEPS, seed=SEEDS,
              velocity_cache_interval=form)
    want = jfp.generate(jb, je, jp, **kw)
    got = tfp.generate(tb, _t(je), _t(jp), **kw)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_sched_resolves_to_jax_anchors(gen, prior, jax_draws):
    """``"sched:2"`` resolves (once, cached per bundle) to the anchors
    JAX resolves; at 6 steps, with 3 anchors, the DP and the uniform
    schedule are scored by image-space probes."""
    jb, tb = gen
    je, jp = prior
    args = (SIZE, SIZE, 6, 2.5)
    want = jfp._resolve_block_cache_interval(jb, "sched:2", je, jp, *args,
                                             mode="velocity")
    before = len(tfp._VCACHE_SCHEDULES)
    got = tfp._resolve_block_cache_interval(tb, "sched:2", _t(je), _t(jp),
                                            *args, mode="velocity")
    assert got == want and len(got) == 3 and got[0] == 0
    tfp._resolve_block_cache_interval(tb, "sched:2", _t(je), _t(jp), *args,
                                      mode="velocity")
    assert len(tfp._VCACHE_SCHEDULES) == before + 1
    assert tfp._resolve_block_cache_interval(
        tb, "sched:1", _t(je), _t(jp), *args, mode="velocity") == 1


def _budgets(curve, space):
    """Budgets between the curve's values (and beyond both ends), each at
    least a fifth of a gap away from every value."""
    vals = sorted(v[space] for v in curve.values())
    mids = [(a + b) / 2 for a, b in zip(vals, vals[1:])
            if b - a > 1e-3]
    return [0.0, vals[0] * 0.5] + mids + [vals[-1] * 2.0, 1e9]
