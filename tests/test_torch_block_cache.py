"""The port's block-residual cache against the JAX package's.

- ``apply_with_cache`` refreshing at every step is bit-equal to the
  port's ``apply`` (f32 and bf16), and a replay of the recorded residuals
  on the same inputs gives the refresh's output;
- a refresh step then a cached step (interval 2) against JAX's on the
  bridged tiny MMDiT: velocities and residuals within 1e-5 in f32;
- ``generate`` under ``block_cache_interval=2`` and ``"auto"`` on the JAX
  tiny bundle's weights with the JAX noise: the f32 image within 1e-3 and
  uint8 within 1 level (as ``test_generate_float_matches_jax``);
- ``_check_block_cache_hbm`` warns where the JAX package warns, the
  port's budget (the card's memory) patched to JAX's 15e9; no budget and
  no warning on the CPU.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu.models.flux import model as jflux
from domainrag_tpu.models.flux import pipeline as jfp
from domainrag_tpu.models.flux import scheduler as jsched
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.core.log import StepTimer
from domainrag_tpu_torch.models.flux import model as tflux
from domainrag_tpu_torch.models.flux import pipeline as tfp
from test_torch_fill import port_bundle

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

SIZE = 32
STEPS = 4
SEEDS = [0, 1]


def _t(x):
    return torch.tensor(np.asarray(x))


def _inputs(cfg, seed=0, b=2, s_img=16, s_txt=6):
    rng = np.random.default_rng(seed)
    return dict(
        img=rng.standard_normal((b, s_img, cfg.in_channels)).astype(
            np.float32),
        txt=rng.standard_normal((b, s_txt, cfg.text_dim)).astype(np.float32),
        pooled=rng.standard_normal((b, cfg.pooled_dim)).astype(np.float32),
        t=rng.uniform(0.1, 0.9, (b,)).astype(np.float32),
        g=np.full((b,), 4.0, np.float32),
        iid=jflux.make_image_ids(4, s_img // 4),
        tid=jflux.make_text_ids(s_txt))


@pytest.fixture(scope="module")
def tiny():
    cfg = jflux.TINY_FLUX
    params = jflux.init(jax.random.PRNGKey(0), cfg)
    return (cfg, params, bridge.config(cfg, tflux.FluxConfig),
            bridge.params(jax.tree.map(np.asarray, params), device="cpu"))


def _port_args(x, dtype=torch.float32):
    return (_t(x["img"]).to(dtype), _t(x["txt"]).to(dtype),
            _t(x["pooled"]).to(dtype), _t(x["t"]), _t(x["iid"]),
            _t(x["tid"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_refresh_every_step_is_apply(tiny, dtype):
    _, _, cfg, tp = tiny
    tp = _cast(tp, dtype)
    x = _inputs(cfg)
    args = _port_args(x, dtype)
    g = _t(x["g"])
    want = tflux.apply(tp, *args, cfg, guidance=g)
    cache = tflux.init_block_cache(cfg, 2, 16, 6, dtype=dtype)
    got, cache = tflux.apply_with_cache(tp, *args, cfg, cache, refresh=True,
                                        guidance=g)
    assert got.dtype == dtype and torch.equal(got, want)
    assert all(c.dtype == dtype for pair in cache["double"] for c in pair)
    assert [tuple(c.shape) for c in cache["single"]] == \
        [(2, 22, cfg.hidden)] * cfg.depth_single
    replay, same = tflux.apply_with_cache(tp, *args, cfg, cache,
                                          refresh=False, guidance=g)
    torch.testing.assert_close(replay, got, atol=1e-5 if dtype ==
                               torch.float32 else 0.1, rtol=1e-5 if dtype ==
                               torch.float32 else 0.05)
    assert all(a is b for a, b in zip(same["single"], cache["single"]))


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def test_cached_step_matches_jax(tiny):
    """Step 0 refreshes on one input, step 1 replays on another (new
    latents and sigma): the velocities and the cache against JAX's."""
    jcfg, jp, cfg, tp = tiny
    x0, x1 = _inputs(cfg, 0), _inputs(cfg, 1)
    x1["txt"], x1["pooled"] = x0["txt"], x0["pooled"]
    jcache = jflux.init_block_cache(jcfg, 2, 16, 6, dtype=jnp.float32)
    tcache = tflux.init_block_cache(cfg, 2, 16, 6, dtype=torch.float32)
    for x, refresh in ((x0, True), (x1, False)):
        jv, jcache = jflux.apply_with_cache(
            jp, *(jnp.asarray(x[k]) for k in ("img", "txt", "pooled", "t",
                                              "iid", "tid")),
            jcfg, jcache, refresh=jnp.bool_(refresh),
            guidance=jnp.asarray(x["g"]))
        tv, tcache = tflux.apply_with_cache(tp, *_port_args(x), cfg, tcache,
                                            refresh=refresh,
                                            guidance=_t(x["g"]))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                                   rtol=1e-5)
    for (ti, tt), (ji, jt) in zip(tcache["double"], jcache["double"]):
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    for tx, jx in zip(tcache["single"], jcache["single"]):
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)


def test_cached_steps_launch_no_block(tiny, monkeypatch):
    """A cached step runs no block: the attention wrappers are called
    only at refresh steps."""
    _, _, cfg, tp = tiny
    calls = []
    for name in ("mmdit_double_attention", "mmdit_single_attention"):
        real = getattr(tflux, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(tflux, name, spy)
    x = _inputs(cfg)
    cache = tflux.init_block_cache(cfg, 2, 16, 6, dtype=torch.float32)
    for refresh in (True, False, False):
        _, cache = tflux.apply_with_cache(tp, *_port_args(x), cfg, cache,
                                          refresh=refresh,
                                          guidance=_t(x["g"]))
    assert len(calls) == cfg.depth_double + cfg.depth_single


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gen():
    jb = jfp.tiny_bundle(jax.random.PRNGKey(0))
    tb = port_bundle(jb, fill=False)
    size = jb.siglip_cfg.image_size
    uniq = np.random.default_rng(3).uniform(
        -1, 1, (3, size, size, 3)).astype(np.float32)
    je, jp = jfp.redux_prior_pairs_indexed(
        jb, uniq, np.asarray([[0, 2], [1, 2]]), "", [0.8, 1.0], [1.0, 1.0])
    return jb, tb, je, jp


def _jax_noise(jb, seeds):
    seq = (SIZE // jb.latent_factor) ** 2
    c = jb.vae_cfg.latent_channels * 4
    return jnp.stack([jax.random.normal(jax.random.PRNGKey(s), (seq, c),
                                        jnp.float32) for s in seeds])


@pytest.mark.parametrize("interval", [2, 3])
def test_generate_float_block_cache_matches_jax(gen, interval):
    jb, tb, je, jp = gen
    lf = jb.latent_factor
    noise = _jax_noise(jb, SEEDS)
    sigmas = jsched.make_schedule(STEPS, image_seq_len=(SIZE // lf) ** 2
                                  ).sigmas
    want = jfp._generate_core_cached(
        jb.flux_params, jb.vae_params, noise, je, jp, jnp.asarray(sigmas),
        jnp.float32(2.5), cfg=jb.flux_cfg, vae_cfg=jb.vae_cfg,
        grid_h=SIZE // lf, grid_w=SIZE // lf, cache_interval=interval)
    timer = StepTimer()
    got = tfp._generate_float(tb, _t(je), _t(jp), SIZE, SIZE, STEPS, 2.5,
                              _t(noise), timer=timer,
                              cache_interval=interval)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=0)
    assert timer.counts == {"step": STEPS, "decode": 1}


@pytest.mark.parametrize("form", [2, "auto"])
def test_generate_uint8_block_cache_matches_jax(gen, form, monkeypatch):
    jb, tb, je, jp = gen

    def draw(bundle, seeds, seq, c):
        return torch.stack([_t(jax.random.normal(jax.random.PRNGKey(s),
                                                 (seq, c), jnp.float32))
                            for s in seeds])

    monkeypatch.setattr(tfp, "_noise", draw)
    kw = dict(height=SIZE, width=SIZE, num_steps=STEPS, seed=SEEDS,
              block_cache_interval=form)
    want = jfp.generate(jb, je, jp, **kw)
    timer = StepTimer()
    got = tfp.generate(tb, _t(je), _t(jp), timer=timer, **kw)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert ("calibrate" in timer.counts) == (form == "auto")


# ---------------------------------------------------------------------------
# the memory check
# ---------------------------------------------------------------------------

class _Fake:
    """Enough of a bundle for both memory checks: the 12B's config and
    ``n`` parameters (numpy for JAX, meta tensors for the port)."""

    def __init__(self, cfg, params, **kw):
        self.flux_cfg, self.flux_params, self.tp_mesh = cfg, params, None
        self.__dict__.update(kw)


@pytest.mark.parametrize("batch", [1, 4, 8, 16])
@pytest.mark.parametrize("n_params", [10 ** 6, 3 * 10 ** 9])
def test_hbm_check_warns_where_jax_warns(caplog, monkeypatch, batch,
                                        n_params):
    monkeypatch.setattr(tfp, "_device_memory_bytes", lambda dev: 15.0e9)
    jb = _Fake(jflux.FLUX_DEV, {"w": np.broadcast_to(np.float32(0),
                                                     (n_params,))})
    tb = _Fake(tflux.FLUX_DEV, {"w": torch.empty(n_params, device="meta")},
               compute_dtype=torch.bfloat16, device=torch.device("cuda"))
    caplog.set_level(logging.WARNING)
    jfp._check_block_cache_hbm(jb, batch, 4096, 1241, None, "data")
    tfp._check_block_cache_hbm(tb, batch, 4096, 1241, None, "data")
    warned = {r.name for r in caplog.records if r.levelno == logging.WARNING}
    assert ("domainrag_tpu.flux" in warned) == \
        ("domainrag_tpu_torch.flux" in warned)


def test_hbm_check_has_no_budget_on_the_cpu(caplog):
    tb = _Fake(tflux.FLUX_DEV, {"w": torch.empty(10 ** 11, device="meta")},
               compute_dtype=torch.bfloat16, device=torch.device("cpu"))
    caplog.set_level(logging.WARNING)
    tfp._check_block_cache_hbm(tb, 64, 4096, 1241, None, "data")
    assert tfp._device_memory_bytes(torch.device("cpu")) is None
    assert not [r for r in caplog.records
                if r.name == "domainrag_tpu_torch.flux"]
