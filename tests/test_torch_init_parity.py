"""The port's random inits against the JAX package's, from the same key.

Every ``init`` of the port takes a ``core.prng`` key where the JAX
package's takes its PRNG key, splits it as JAX's does and draws each leaf
with ``prng.normal`` in JAX's shape. So ``init(prng.PRNGKey(s), cfg)``
is JAX's ``init(jax.random.PRNGKey(s), cfg)``, leaf by leaf, with
nothing carried across:

- the same keys, list lengths and shapes (JAX's HWIO conv kernels read
  as the port's OIHW, as ``bridge.params`` turns them);
- the leaves no init draws (biases, norm scales, batchnorm statistics)
  ``torch.equal``;
- the f32 draws within 4 ulp of JAX's value (the bar of
  ``tests/test_torch_prng.py`` for ``prng.normal``), bf16 draws equal.

Then the entry points that draw through them: ``tiny_bundle`` (six
trees), ``build_tiny_runner`` (five) and ``generate(seed=)`` from each
package's own ``tiny_bundle(PRNGKey(k))``, uint8 within 1 level.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu.core import config as jconfig
from domainrag_tpu.models import clip as jclip
from domainrag_tpu.models import common as jcommon
from domainrag_tpu.models import lama as jlama
from domainrag_tpu.models import redux as jredux
from domainrag_tpu.models import resnet_stem as jstem
from domainrag_tpu.models import siglip as jsiglip
from domainrag_tpu.models import t5 as jt5
from domainrag_tpu.models.flux import model as jflux
from domainrag_tpu.models.flux import pipeline as jfp
from domainrag_tpu.models.flux import vae as jvae
from domainrag_tpu.pipeline import orchestrator as jorch
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.core import config as tconfig
from domainrag_tpu_torch.core import prng
from domainrag_tpu_torch.models import clip as tclip
from domainrag_tpu_torch.models import common as tcommon
from domainrag_tpu_torch.models import lama as tlama
from domainrag_tpu_torch.models import redux as tredux
from domainrag_tpu_torch.models import resnet_stem as tstem
from domainrag_tpu_torch.models import siglip as tsiglip
from domainrag_tpu_torch.models import t5 as tt5
from domainrag_tpu_torch.models.flux import model as tflux
from domainrag_tpu_torch.models.flux import pipeline as tfp
from domainrag_tpu_torch.models.flux import vae as tvae
from domainrag_tpu_torch.pipeline import orchestrator as torch_orch

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

F32_ULP = 4
# the leaves no init draws: zeros and ones
CONSTANT = {"b", "scale", "bias", "mean", "var", "patch_b"}
BUNDLE_TREES = ("flux_params", "vae_params", "t5_params",
                "clip_text_params", "siglip_params", "redux_params")


def _ordered(a):
    """f32 bit patterns as integers in the floats' order (ulp steps)."""
    i = a.astype(np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def _walk(got, want, path=()):
    """(path, port leaf, JAX leaf) pairs of two trees, asserting the same
    keys and list lengths on the way."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        return [x for k in want for x in _walk(got[k], want[k], path + (k,))]
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        return [x for i, (g, w) in enumerate(zip(got, want))
                for x in _walk(g, w, path + (i,))]
    return [(path, got, want)]


def _as_jax_dtypes(tree, jax_tree):
    if isinstance(tree, dict):
        return {k: _as_jax_dtypes(v, jax_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_jax_dtypes(v, j) for v, j in zip(tree, jax_tree)]
    return tree.bfloat16() if jax_tree.dtype == jnp.bfloat16 else tree


def assert_same_tree(got, jax_tree):
    """The port's tree is JAX's (``jax_tree`` a JAX pytree): keys,
    shapes and dtypes, constants equal, f32 draws within ``F32_ULP``,
    bf16 draws equal."""
    # numpy has no bf16 that torch reads: across in f32, then back exactly
    wide = jax.tree.map(lambda x: np.asarray(x, np.float32)
                        if x.dtype == jnp.bfloat16 else np.asarray(x),
                        jax_tree)
    want_tree = _as_jax_dtypes(bridge.params(wide, device="cpu"), jax_tree)
    for path, g, w in _walk(got, want_tree):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu", path
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (path, g.dtype, tuple(g.shape), w.dtype, tuple(w.shape))
        if path[-1] in CONSTANT or g.dtype != torch.float32:
            assert torch.equal(g, w), path
            continue
        assert not torch.equal(w, torch.zeros_like(w)), path
        ulp = int(np.abs(_ordered(g.numpy()) - _ordered(w.numpy())).max()) \
            if g.numel() else 0
        assert ulp <= F32_ULP, (path, ulp)


# ---------------------------------------------------------------------------
# models/common.py
# ---------------------------------------------------------------------------

COMMON = {
    "linear": lambda c, k: c.linear_init(k, 24, 40),
    "linear_no_bias_std": lambda c, k: c.linear_init(k, 16, 8, False, 0.5),
    "conv": lambda c, k: c.conv_init(k, 3, 3, 4, 6),
    "conv_1x1_no_bias": lambda c, k: c.conv_init(k, 1, 1, 8, 5, False),
    "conv_groups": lambda c, k: c.conv_init(k, 3, 3, 8, 6, groups=2),
    "conv_depthwise": lambda c, k: c.conv_init(k, 5, 5, 6, 6, groups=6),
    "mha": lambda c, k: c.mha_init(k, 32),
    "mha_no_bias": lambda c, k: c.mha_init(k, 16, bias=False),
}


@pytest.mark.parametrize("seed", [0, 9])
@pytest.mark.parametrize("name", sorted(COMMON))
def test_common_inits_match_jax(name, seed):
    fn = COMMON[name]
    assert_same_tree(fn(tcommon, prng.PRNGKey(seed)),
                     fn(jcommon, jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["normal_init", "lecun_init"])
def test_normal_and_lecun_init_draw_in_their_dtype(which, dtype):
    """Each draws in ``dtype`` and scales there, as JAX's: a bf16 draw is
    a bf16 ``prng.normal`` times the bf16 scale."""
    shape = (7, 300)
    extra = (0.05,) if which == "normal_init" else (96,)
    got = getattr(tcommon, which)(prng.PRNGKey(4), shape, *extra,
                                  getattr(torch, dtype))
    want = getattr(jcommon, which)(jax.random.PRNGKey(4), shape, *extra,
                                   getattr(jnp, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert_same_tree({"w": got}, {"w": want})
    if dtype == "float32":
        default = getattr(tcommon, which)(prng.PRNGKey(4), shape, *extra)
        assert torch.equal(default, got)


def test_normal_init_default_std():
    got = tcommon.normal_init(prng.PRNGKey(1), (64,))
    assert_same_tree({"w": got},
                     {"w": jcommon.normal_init(jax.random.PRNGKey(1), (64,))})


def test_linear_init_stores_jax_f32_leaf_rounded():
    """The port-only ``dtype=``: JAX's f32 weight, rounded (within one
    bf16 step of it: the f32 draws may straddle a rounding edge), and a
    bf16 zero bias."""
    got = tcommon.linear_init(prng.PRNGKey(3), 64, 96, dtype=torch.bfloat16)
    f32 = tcommon.linear_init(prng.PRNGKey(3), 64, 96)
    want = np.array(jcommon.linear_init(jax.random.PRNGKey(3), 64, 96)["w"])
    assert got["w"].dtype == got["b"].dtype == torch.bfloat16
    assert torch.equal(got["w"], f32["w"].to(torch.bfloat16))
    assert torch.equal(got["b"], torch.zeros(96, dtype=torch.bfloat16))
    rounded = torch.from_numpy(want).to(torch.bfloat16).float()
    step = rounded.abs() * 2.0 ** -7
    assert bool(((got["w"].float() - rounded).abs() <= step).all())


@pytest.mark.parametrize("fn", ["linear_init", "conv_init", "mha_init",
                                "normal_init"])
@pytest.mark.parametrize("bad", ["int", "generator"])
def test_an_init_refuses_what_is_not_a_key(fn, bad):
    key = 0 if bad == "int" else torch.Generator().manual_seed(0)
    args = {"linear_init": (4, 4), "conv_init": (1, 1, 2, 2),
            "mha_init": (8,), "normal_init": ((3,),)}[fn]
    with pytest.raises(TypeError, match="PRNG key"):
        getattr(tcommon, fn)(key, *args)


def test_the_norm_inits_draw_nothing():
    for name in ("layernorm_init", "rmsnorm_init", "groupnorm_init",
                 "batchnorm_init"):
        got = getattr(tcommon, name)(5, device="cpu")
        assert_same_tree(got, getattr(jcommon, name)(5))


# ---------------------------------------------------------------------------
# each model's init at its tiny config
# ---------------------------------------------------------------------------

FLUX_GUIDED = dataclasses.replace(jflux.TINY_FLUX, guidance_embed=True)
FLUX_FILL = dataclasses.replace(
    jflux.TINY_FLUX, in_channels=tfp.tiny_configs(True)["flux_cfg"]
    .in_channels)

MODELS = {
    "flux": (jflux.init, tflux.init, jflux.TINY_FLUX, tflux.FluxConfig),
    "flux_guidance": (jflux.init, tflux.init, FLUX_GUIDED,
                      tflux.FluxConfig),
    "flux_fill_width": (jflux.init, tflux.init, FLUX_FILL,
                        tflux.FluxConfig),
    "vae": (jvae.init, tvae.init, jvae.TINY_VAE, tvae.VaeConfig),
    "t5": (jt5.init, tt5.init, jt5.TINY_T5, tt5.T5Config),
    "clip_vision": (jclip.init_vision, tclip.init_vision, jclip.TINY_VISION,
                    tclip.ClipVisionConfig),
    "clip_text": (jclip.init_text, tclip.init_text, jclip.TINY_TEXT,
                  tclip.ClipTextConfig),
    "siglip": (jsiglip.init, tsiglip.init, jsiglip.TINY_SIGLIP,
               tsiglip.SiglipVisionConfig),
    "redux": (jredux.init, tredux.init, jredux.TINY_REDUX,
              tredux.ReduxEncoderConfig),
    "lama": (jlama.init, tlama.init, jlama.TINY_LAMA, tlama.LamaConfig),
    "resnet_stem": (jstem.init, tstem.init, jstem.ResNetStemConfig(),
                    tstem.ResNetStemConfig),
}


@pytest.mark.parametrize("seed", [0, 2 ** 31 - 1])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_init_matches_jax(name, seed):
    jinit, tinit, jcfg, tcls = MODELS[name]
    got = tinit(prng.PRNGKey(seed), bridge.config(jcfg, tcls))
    assert_same_tree(got, jinit(jax.random.PRNGKey(seed), jcfg))


def test_flux_init_dtype_rounds_jax_leaves():
    """The port-only storage dtype: every weight and bias of the MMDiT is
    the f32 tree's leaf rounded; the qk norms stay f32."""
    cfg = tflux.TINY_FLUX
    f32 = tflux.init(prng.PRNGKey(6), cfg)
    bf16 = tflux.init(prng.PRNGKey(6), cfg, dtype=torch.bfloat16)
    for path, g, w in _walk(bf16, f32):
        qknorm = any(str(k).endswith("qknorm") for k in path)
        want = w if qknorm else w.to(torch.bfloat16)
        assert g.dtype == want.dtype and torch.equal(g, want), path


def test_init_draws_on_the_key_device():
    """The meta device gives the tree's shapes, as ``convert_lama``'s
    template takes them, without drawing."""
    got = tlama.init(prng.PRNGKey(0, device="meta"), tlama.TINY_LAMA)
    want = tlama.init(prng.PRNGKey(0), tlama.TINY_LAMA)
    for path, g, w in _walk(got, want):
        assert g.device.type == "meta" and g.shape == w.shape, path


@pytest.mark.parametrize("name", ["flux", "vae", "lama", "t5"])
def test_model_init_refuses_an_int_or_a_generator(name):
    _, tinit, jcfg, tcls = MODELS[name]
    for bad in (0, torch.Generator().manual_seed(0)):
        with pytest.raises(TypeError, match="PRNG key"):
            tinit(bad, bridge.config(jcfg, tcls))


# ---------------------------------------------------------------------------
# tiny_bundle and build_tiny_runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key,fill", [(None, False), (5, True), (5, False)],
                         ids=["default", "key5_fill", "key5"])
def test_tiny_bundle_matches_jax(key, fill):
    got = tfp.tiny_bundle(None if key is None else prng.PRNGKey(key), fill,
                          device="cpu")
    want = jfp.tiny_bundle(None if key is None else jax.random.PRNGKey(key),
                           fill)
    for name in BUNDLE_TREES:
        assert_same_tree(getattr(got, name), getattr(want, name))
    assert got.flux_cfg == bridge.config(want.flux_cfg, tflux.FluxConfig)


def test_tiny_bundle_refuses_a_seed():
    with pytest.raises(TypeError, match="tiny_bundle takes a PRNG key"):
        tfp.tiny_bundle(0, device="cpu")


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    root = tmp_path_factory.mktemp("runner")
    kw = dict(datasets=("NEU-DET",), shots=(1,), datasets_dir=str(root),
              output_dir=str(root / "out"))
    got = torch_orch.build_tiny_runner(tconfig.PipelineConfig(**kw), seed=3,
                                       device="cpu")
    want = jorch.build_tiny_runner(jconfig.PipelineConfig(**kw), seed=3)
    return got, want


def _runner_trees(runner):
    return {"lama": runner.lama_runner.params,
            "clip_vision": runner.clip_encoder._params,
            "stem": runner.style_encoder._params}


@pytest.mark.parametrize("tree", ["lama", "clip_vision", "stem",
                                  "flux_bundle", "fill_bundle"])
def test_build_tiny_runner_matches_jax(runners, tree):
    got, want = runners
    if tree.endswith("bundle"):
        for name in BUNDLE_TREES:
            assert_same_tree(getattr(getattr(got, tree), name),
                             getattr(getattr(want, tree), name))
        return
    assert_same_tree(_runner_trees(got)[tree], _runner_trees(want)[tree])


# ---------------------------------------------------------------------------
# end to end, nothing carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", [0, 11])
def test_generate_from_each_package_tiny_bundle(key):
    """Each package draws its own bundle from ``PRNGKey(key)`` and
    generates from a seed: the images agree within 1 uint8 level."""
    jb = jfp.tiny_bundle(jax.random.PRNGKey(key))
    tb = tfp.tiny_bundle(prng.PRNGKey(key), device="cpu")
    size = jb.siglip_cfg.image_size
    uniq = np.random.default_rng(key).uniform(
        -1, 1, (3, size, size, 3)).astype(np.float32)
    pairs = np.asarray([[0, 2], [1, 2]])
    je, jp = jfp.redux_prior_pairs_indexed(jb, uniq, pairs, "", [0.8, 1.0],
                                           [1.0, 1.0])
    te, tp = tfp.redux_prior_pairs_indexed(tb, uniq, pairs, "", [0.8, 1.0],
                                           [1.0, 1.0])
    kw = dict(height=32, width=32, num_steps=4, seed=[key, key + 1])
    got = tfp.generate(tb, te, tp, **kw)
    want = jfp.generate(jb, je, jp, **kw)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# one draw path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4321,), (37, 129)])
def test_a_draw_in_chunks_is_the_one_pass_draw(monkeypatch, shape):
    """A draw larger than its device's chunk hashes the flat counters
    [a, b) chunk by chunk: the same bits as one pass."""
    key = prng.split(prng.PRNGKey(8))[1]
    whole = [prng.normal(key, shape), prng.normal(key, shape, torch.bfloat16),
             prng.uniform(key, shape), prng.bits(key, shape, 16)]
    monkeypatch.setitem(prng.CHUNK, "cpu", 1000)
    chunked = [prng.normal(key, shape),
               prng.normal(key, shape, torch.bfloat16),
               prng.uniform(key, shape), prng.bits(key, shape, 16)]
    for a, b in zip(whole, chunked):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_no_generator_on_an_init_path():
    """Every random init draws through ``core.prng``: the port's models,
    pipeline, stages, trainer and core hold no ``torch.Generator``,
    ``manual_seed`` or ``torch.randn``, and neither ``Init`` nor
    ``core.device.generator`` is left."""
    import os
    import domainrag_tpu_torch
    from domainrag_tpu_torch.core import device as device_mod
    root = os.path.dirname(domainrag_tpu_torch.__file__)
    found = []
    for sub in ("models", "pipeline", "stages", "train", "core"):
        for dirpath, _, files in os.walk(os.path.join(root, sub)):
            for f in files:
                if f.endswith(".py"):
                    with open(os.path.join(dirpath, f)) as fh:
                        text = fh.read()
                    found += [(f, w) for w in ("Generator", "manual_seed",
                                               "randn") if w in text]
    assert not found
    assert not hasattr(tcommon, "Init")
    assert not hasattr(device_mod, "generator")
