"""The port's public API against the JAX package's, module by module.

For every module of ``domainrag_tpu`` and its counterpart in
``domainrag_tpu_torch`` (one case each):

- every public top-level name of the JAX module (its ``def``s, classes
  and assigned constants, read from its source; in a package
  ``__init__``, what it imports) exists in the port, and a config
  constant (a dataclass instance) equals JAX's through ``bridge.config``;
- every public function and method that both define takes JAX's
  parameters in JAX's order, of JAX's kinds, with JAX's defaults (a dtype
  through :data:`AS_TORCH`, a config through ``bridge.config``); where
  JAX takes a PRNG key the port takes, in that slot (:data:`KEY_SLOTS`),
  a ``core.prng`` key named ``key``;
- the port's own parameters come after JAX's, keyword-only.

:data:`EXCLUDED` holds everything the check leaves out, each with its
reason; nothing else is left out. Then the behaviour of the names and
parameters this check asked for, each against the JAX function on the
same numpy inputs and bridged weights at tiny configs.
"""

import ast
import dataclasses
import importlib
import inspect
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import domainrag_tpu
from domainrag_tpu_torch import bridge

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

JAX_ROOT = os.path.dirname(domainrag_tpu.__file__)

AS_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
            jnp.float16: torch.float16, jnp.int8: torch.int8,
            jnp.int32: torch.int32}

# (module, function) -> the port's parameter in the slot of the JAX key
KEY_SLOTS = {
    ("models.common", "normal_init"): "key",
    ("models.common", "lecun_init"): "key",
    ("models.common", "linear_init"): "key",
    ("models.common", "conv_init"): "key",
    ("models.common", "mha_init"): "key",
    ("models.flux.model", "init"): "key",
    ("models.flux.vae", "init"): "key",
    ("models.flux.vae", "encode"): "key",
    ("models.flux.vae", "encode_tiled"): "key",
    ("models.flux.pipeline", "tiny_bundle"): "key",
    ("models.t5", "init"): "key",
    ("models.clip", "init_vision"): "key",
    ("models.clip", "init_text"): "key",
    ("models.siglip", "init"): "key",
    ("models.redux", "init"): "key",
    ("models.lama", "init"): "key",
    ("models.resnet_stem", "init"): "key",
    ("train.flow_match", "sample_timesteps"): "key",
    ("train.flow_match", "flow_match_loss"): "key",
    ("train.flow_match", "train_step"): "key",
    ("train.loop", "latent_batches_from_images"): "key",
}

EXCLUDED = {
    "names": {
        ("ops.mmdit_attention", "lanes_from_qkv3"):
            "a TPU lane layout of the Pallas kernels",
        ("ops.mmdit_attention", "qkv3_from_lanes"):
            "a TPU lane layout of the Pallas kernels",
        ("ops.topk", "bitonic_sort"):
            "an in-kernel helper of the Pallas top-k",
        ("ops.topk", "bitonic_sort_desc"):
            "an in-kernel helper of the Pallas top-k",
        ("ops.topk", "bitonic_merge_desc"):
            "an in-kernel helper of the Pallas top-k",
    },
    "parameters": {
        "interpret": "Pallas interpret mode",
        "block_q": "Pallas tiling",
        "block_kv": "Pallas tiling",
        "block_n": "Pallas tiling",
    },
    "defaults": {
        ("core.log", "get_logger", "name"):
            "the default logger is named after each package",
        ("utils", "get_logger", "name"):
            "the default logger is named after each package",
        ("eval.flops", "mfu", "peak_tflops"):
            "the peak of the card (989 dense bf16 TFLOP/s), not a TPU's",
    },
}


def _modules():
    out = []
    for root, _, files in os.walk(JAX_ROOT):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), JAX_ROOT)
                rel = rel[:-3].replace(os.sep, ".")
                out.append(rel.removesuffix("__init__").rstrip("."))
    return sorted(out)


MODULES = _modules()


def _source_path(rel):
    base = os.path.join(JAX_ROOT, *rel.split(".")) if rel else JAX_ROOT
    return (os.path.join(base, "__init__.py") if os.path.isdir(base)
            else base + ".py")


def _top_level(body):
    for node in body:
        if isinstance(node, ast.If):
            yield from _top_level(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top_level(node.body + node.orelse + node.finalbody)
        else:
            yield node


def _public_names(rel):
    """The public top-level names the JAX module defines (or, a package
    ``__init__``, imports)."""
    path = _source_path(rel)
    is_init = path.endswith("__init__.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = []
    for node in _top_level(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.append(node.target.id)
        elif is_init and isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return [n for n in dict.fromkeys(names) if not n.startswith("_")]


def _modules_pair(rel):
    suffix = "." + rel if rel else ""
    return (importlib.import_module("domainrag_tpu" + suffix),
            importlib.import_module("domainrag_tpu_torch" + suffix))


def _function(obj):
    """The plain function behind a jitted function, a classmethod or a
    staticmethod; None for anything without a signature to compare."""
    if isinstance(obj, (classmethod, staticmethod)):
        obj = obj.__func__
    if inspect.isclass(obj) or not callable(obj):
        return None
    try:
        inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return obj


def _methods(cls):
    """The public methods (and ``__init__``) defined in ``cls``'s body."""
    out = {}
    for name, value in vars(cls).items():
        if name.startswith("_") and name != "__init__":
            continue
        fn = _function(value)
        if fn is not None and (inspect.isfunction(fn)
                               or hasattr(fn, "__wrapped__")):
            out[name] = fn
    return out


def _pairs(rel):
    """(qualname, JAX function, port function or None) for every public
    function and method of the JAX module."""
    jm, tm = _modules_pair(rel)
    out = []
    for name in _public_names(rel):
        jv, tv = getattr(jm, name, None), getattr(tm, name, None)
        if inspect.isclass(jv):
            for mname, fn in _methods(jv).items():
                port = None if tv is None else inspect.getattr_static(
                    tv, mname, None)
                out.append((f"{name}.{mname}", fn,
                            None if port is None else _function(port)))
        elif inspect.ismodule(jv) or jv is None:
            continue
        elif _function(jv) is not None:
            out.append((name, _function(jv),
                        None if tv is None else _function(tv)))
    return out


def _same_default(jd, td):
    if jd is inspect.Parameter.empty or td is inspect.Parameter.empty:
        return jd is td
    if jd in AS_TORCH:
        return AS_TORCH[jd] == td
    if dataclasses.is_dataclass(jd) and not isinstance(jd, type):
        return dataclasses.is_dataclass(td) and \
            bridge.config(jd, type(td)) == td
    return type(jd) is type(td) and jd == td


def _signature_faults(rel, qualname, jax_fn, port_fn):
    func = qualname.split(".")[-1] if "." in qualname else qualname
    slot = KEY_SLOTS.get((rel, qualname))
    jax_params = [p for p in inspect.signature(jax_fn).parameters.values()
                  if p.name not in EXCLUDED["parameters"]]
    port = list(inspect.signature(port_fn).parameters.values())
    faults = []
    for i, jp in enumerate(jax_params):
        if i >= len(port):
            faults.append(f"{qualname}: missing {jp.name}")
            continue
        tp = port[i]
        want = slot if jp.name == "key" and slot else jp.name
        if tp.name != want:
            faults.append(f"{qualname}: slot {i} is {tp.name}, JAX's "
                          f"{jp.name} (want {want})")
            continue
        if tp.kind is not jp.kind:
            faults.append(f"{qualname}: {tp.name} is {tp.kind.name}, JAX's "
                          f"{jp.kind.name}")
        if (rel, func, jp.name) in EXCLUDED["defaults"]:
            continue
        if jp.name == "key" and slot and jp.default is None:
            if tp.default is not None:
                faults.append(f"{qualname}: {tp.name}={tp.default!r}, JAX's "
                              f"key=None")
        elif not _same_default(jp.default, tp.default):
            faults.append(f"{qualname}: {tp.name}={tp.default!r}, JAX's "
                          f"{jp.default!r}")
    for tp in port[len(jax_params):]:
        if tp.kind not in (tp.KEYWORD_ONLY, tp.VAR_KEYWORD):
            faults.append(f"{qualname}: port-only {tp.name} is "
                          f"{tp.kind.name}, not keyword-only")
    return faults


PACKAGES = [rel for rel in MODULES if _source_path(rel).endswith(
    "__init__.py")]

_FRESH = """
import json, sys
import torch
import domainrag_tpu_torch{suffix} as pkg
missing = [n for n in {names!r} if not hasattr(pkg, n)]
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "domainrag_tpu", "triton"))
from domainrag_tpu_torch.native import build as native_build
from domainrag_tpu_torch.ops import _build as ops_build
print(json.dumps({{
    "missing": missing, "leaked": leaked,
    "built": bool(ops_build._LOADED) or native_build._lib is not None,
    "cuda": torch.cuda.is_initialized()}}))
"""

_fresh_results = {}


def _fresh_import(rel):
    """What importing the port's package ``rel`` alone leaves behind, in a
    new interpreter: one per package, all started together on the first
    call and kept for the file."""
    import json
    import subprocess
    import sys
    if not _fresh_results:
        repo = os.path.dirname(JAX_ROOT)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [repo, os.environ.get("PYTHONPATH", "")]))
        procs = {pkg: subprocess.Popen(
            [sys.executable, "-c", _FRESH.format(
                suffix="." + pkg if pkg else "", names=_public_names(pkg))],
            cwd=repo, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for pkg in PACKAGES}
        for pkg, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-2000:]
            _fresh_results[pkg] = json.loads(out.strip().splitlines()[-1])
    return _fresh_results[rel]


@pytest.mark.parametrize("rel", MODULES)
def test_public_names_exist_in_the_port(rel):
    """A package's names are read from a fresh import of it alone: in
    this process its submodules may be attributes already."""
    jm, tm = _modules_pair(rel)
    if _source_path(rel).endswith("__init__.py"):
        missing = _fresh_import(rel)["missing"]
    else:
        missing = [n for n in _public_names(rel)
                   if (rel, n) not in EXCLUDED["names"]
                   and not hasattr(tm, n)]
    assert not missing, f"{rel or 'domainrag_tpu'}: {missing}"
    configs = [n for n in _public_names(rel)
               if dataclasses.is_dataclass(getattr(jm, n, None))
               and not isinstance(getattr(jm, n), type)]
    unequal = [n for n in configs
               if bridge.config(getattr(jm, n), type(getattr(tm, n)))
               != getattr(tm, n)]
    assert not unequal, f"{rel}: configs differ from JAX's: {unequal}"


@pytest.mark.parametrize("rel", MODULES)
def test_signatures_take_jax_parameters(rel):
    faults = []
    for qualname, jax_fn, port_fn in _pairs(rel):
        name = qualname.split(".")[0]
        if (rel, name) in EXCLUDED["names"]:
            continue
        if port_fn is None:
            faults.append(f"{qualname}: no function in the port")
            continue
        faults += _signature_faults(rel, qualname, jax_fn, port_fn)
    assert not faults, "\n".join(faults)


def test_key_slots_name_jax_keys():
    """Every entry of KEY_SLOTS is a JAX function whose parameter in that
    slot is its PRNG ``key``."""
    for (rel, qualname), _ in KEY_SLOTS.items():
        jm, _ = _modules_pair(rel)
        fn = _function(getattr(jm, qualname))
        assert "key" in inspect.signature(fn).parameters, (rel, qualname)


# ---------------------------------------------------------------------------
# the package re-exports, each package imported alone in a fresh process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rel", PACKAGES)
def test_package_reexports_in_a_fresh_process(rel):
    """Each package ``__init__`` re-exports what JAX's does, and importing
    it alone loads no JAX, nothing of ``domainrag_tpu`` and no triton,
    builds no library and starts no CUDA context."""
    got = _fresh_import(rel)
    assert got["missing"] == [], got
    assert got["leaked"] == [], got
    assert not got["built"] and not got["cuda"], got


# ---------------------------------------------------------------------------
# F5: the key's slot. The inits take JAX's order
# ---------------------------------------------------------------------------

def _shapes(tree, hwio_to_oihw=False, path=()):
    """{path: shape} of a param tree's leaves (JAX's HWIO kernels read as
    OIHW with ``hwio_to_oihw``)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _shapes(sub, hwio_to_oihw, path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _shapes(sub, hwio_to_oihw, path + (i,)).items()}
    s = tuple(tree.shape)
    if hwio_to_oihw and len(s) == 4:
        s = (s[3], s[2], s[0], s[1])
    return {path: s}


@pytest.mark.parametrize("name", ["vae", "t5", "siglip", "redux"])
def test_init_with_the_key_alone_takes_jax_default_config(name):
    """``init(key)`` binds as JAX's ``init(key)``: the default config, the
    full-width one, here drawn as shapes only (on the meta device; JAX's
    through ``jax.eval_shape``)."""
    from domainrag_tpu_torch.core import prng
    mods = {"vae": "models.flux.vae", "t5": "models.t5",
            "siglip": "models.siglip", "redux": "models.redux"}
    jm, tm = _modules_pair(mods[name])
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    got = tm.init(prng.PRNGKey(0, device="meta"))
    assert _shapes(got) == _shapes(want, name == "vae")


def test_jax_order_positional_calls_bind():
    from domainrag_tpu.models.flux import model as jflux
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.models import common
    from domainrag_tpu_torch.models.flux import model as tflux
    from domainrag_tpu_torch.models.flux import pipeline as tfp
    got = tflux.init(prng.PRNGKey(1), tflux.TINY_FLUX)
    want = jax.eval_shape(lambda k: jflux.init(k, jflux.TINY_FLUX),
                          jax.random.PRNGKey(1))
    assert _shapes(got) == _shapes(want)
    ln = common.layernorm_init(6)
    assert [(t.dtype, t.device.type) for t in ln.values()] == \
        [(torch.float32, torch.empty(0).device.type)] * 2
    assert torch.equal(ln["scale"], torch.ones(6))
    assert torch.equal(ln["bias"], torch.zeros(6))
    key = prng.PRNGKey(0)
    bound = inspect.signature(tfp.tiny_bundle).bind(key, True)
    assert bound.arguments == {"key": key, "fill": True}
    b = tfp.tiny_bundle(key, True, device="cpu")
    assert b.flux_cfg.in_channels == tfp.tiny_configs(True)[
        "flux_cfg"].in_channels


# ---------------------------------------------------------------------------
# F4: what the names and parameters compute, against JAX
# ---------------------------------------------------------------------------

def _rng(seed):
    return np.random.default_rng(seed)


def _relnorm(got, want):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def test_apply_rope_matches_jax():
    from domainrag_tpu.models.flux import model as jflux
    from domainrag_tpu_torch.models.flux import model as tflux
    from domainrag_tpu_torch.ops.mmdit_attention import rope_interleaved
    x = _rng(0).standard_normal((2, 3, 10, 16)).astype(np.float32)
    ids = np.concatenate([jflux.make_text_ids(4), jflux.make_image_ids(2, 3)])
    cos, sin = (np.array(a) for a in jflux.rope_cos_sin(
        jnp.asarray(ids), (4, 6, 6), 10000))
    want = np.asarray(jflux.apply_rope(jnp.asarray(x), jnp.asarray(cos),
                                       jnp.asarray(sin)))
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    got = tflux.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    xb = torch.from_numpy(x).bfloat16()
    assert torch.equal(tflux.apply_rope(xb, tc, ts),
                       rope_interleaved(xb, tc, ts))


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
@pytest.mark.parametrize("size,window,stride", [(8, 2, 2), (7, 3, 2),
                                                (9, 3, 3), (6, 3, 1)])
def test_avg_pool_matches_jax(padding, size, window, stride):
    from domainrag_tpu.models import common as jcommon
    from domainrag_tpu_torch.models import common as tcommon
    x = _rng(size).standard_normal((2, size, size + 1, 3)).astype(
        np.float32)
    want = np.asarray(jcommon.avg_pool(jnp.asarray(x), window, stride,
                                       padding))
    got = tcommon.avg_pool(torch.from_numpy(x), window, stride, padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_count_params_matches_jax():
    from domainrag_tpu.models import common as jcommon
    from domainrag_tpu.models.flux import model as jflux
    from domainrag_tpu_torch.models import common as tcommon
    from domainrag_tpu_torch.models.flux import model as tflux
    want = jcommon.count_params(jax.eval_shape(
        lambda k: jflux.init(k, jflux.TINY_FLUX), jax.random.PRNGKey(0)))
    from domainrag_tpu_torch.core import prng
    assert tcommon.count_params(tflux.init(prng.PRNGKey(0),
                                           tflux.TINY_FLUX)) == want


def test_grouped_conv_matches_jax():
    from domainrag_tpu.models import common as jcommon
    from domainrag_tpu_torch.models import common as tcommon
    jp = jcommon.conv_init(jax.random.PRNGKey(3), 3, 3, 4, 6, groups=2)
    tp = bridge.params(jax.tree.map(np.asarray, jp), device="cpu")
    assert tuple(tp["w"].shape) == (6, 2, 3, 3)
    from domainrag_tpu_torch.core import prng
    assert tuple(tcommon.conv_init(prng.PRNGKey(0), 3, 3, 4, 6, groups=2)[
        "w"].shape) == (6, 2, 3, 3)
    x = _rng(3).standard_normal((2, 9, 8, 4)).astype(np.float32)
    for stride, padding in ((1, "SAME"), (2, "SAME"), (2, ((0, 1), (0, 1)))):
        want = np.asarray(jcommon.conv2d(jp, jnp.asarray(x), stride, padding,
                                         groups=2))
        got = tcommon.conv2d(tp, torch.from_numpy(x), stride, padding,
                             groups=2)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_mha_attn_fn_matches_jax():
    """A non-default attention: causal, with q scaled by 2, whatever mask
    is passed."""
    from domainrag_tpu.models import common as jcommon
    from domainrag_tpu_torch.models import common as tcommon
    jp = jcommon.mha_init(jax.random.PRNGKey(4), 16)
    tp = bridge.params(jax.tree.map(np.asarray, jp), device="cpu")
    x = _rng(4).standard_normal((2, 5, 16)).astype(np.float32)
    calls = []

    def jattn(q, k, v, mask):
        calls.append(mask)
        return jcommon.sdpa(2.0 * q, k, v, jcommon.causal_mask(q.shape[2]))

    def tattn(q, k, v, mask):
        calls.append(mask)
        return tcommon.sdpa(2.0 * q, k, v, tcommon.causal_mask(q.shape[2]))

    want = np.asarray(jcommon.mha(jp, jnp.asarray(x), 4, None, jattn))
    got = tcommon.mha(tp, torch.from_numpy(x), 4, None, tattn)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    plain = tcommon.mha(tp, torch.from_numpy(x), 4)
    assert not torch.allclose(plain, got)
    assert calls == [None, None]


@pytest.fixture(scope="module")
def t5_trees():
    from domainrag_tpu.models import t5 as jt5
    jp = jt5.init(jax.random.PRNGKey(5), jt5.TINY_T5)
    return jp, bridge.params(jax.tree.map(np.asarray, jp), device="cpu")


def test_t5_attention_mask_matches_jax(t5_trees):
    from domainrag_tpu.models import t5 as jt5
    from domainrag_tpu_torch.models import t5 as tt5
    jp, tp = t5_trees
    ids = _rng(5).integers(0, jt5.TINY_T5.vocab_size, (2, 8)).astype(
        np.int32)
    mask = np.ones((2, 8), np.int32)
    mask[1, 5:] = 0
    want = np.asarray(jt5.apply(jp, jnp.asarray(ids), jt5.TINY_T5,
                                jnp.asarray(mask)))
    cfg = bridge.config(jt5.TINY_T5, tt5.T5Config)
    got = tt5.apply(tp, torch.from_numpy(ids), cfg, torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    unmasked = tt5.apply(tp, torch.from_numpy(ids), cfg)
    assert torch.equal(unmasked[0], got[0])
    assert not torch.allclose(unmasked[1], got[1])


def test_t5_and_clip_text_run_in_bf16_as_jax(t5_trees):
    """The embedding and the stream in bf16: within 2e-2 of JAX's bf16
    run in relative norm."""
    from domainrag_tpu.models import clip as jclip
    from domainrag_tpu.models import t5 as jt5
    from domainrag_tpu_torch.models import clip as tclip
    from domainrag_tpu_torch.models import t5 as tt5
    jp, tp = t5_trees
    ids = _rng(6).integers(0, jt5.TINY_T5.vocab_size, (2, 8)).astype(
        np.int32)
    # jitted: compiled once instead of run op by op
    want = jax.jit(jt5.apply, static_argnums=(2, 4))(
        jp, jnp.asarray(ids), jt5.TINY_T5, None, jnp.bfloat16)
    got = tt5.apply(tp, torch.from_numpy(ids),
                    bridge.config(jt5.TINY_T5, tt5.T5Config), None,
                    torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _relnorm(got.float().numpy(),
                    np.asarray(want.astype(jnp.float32))) < 2e-2
    cfg = jclip.TINY_TEXT
    jc = jclip.init_text(jax.random.PRNGKey(6), cfg)
    tc = bridge.params(jax.tree.map(np.asarray, jc), device="cpu")
    ids = _rng(7).integers(0, cfg.vocab_size - 1, (2, cfg.max_len)).astype(
        np.int32)
    ids[:, -3] = cfg.eos_token_id
    want = jax.jit(jclip.apply_text, static_argnums=(2, 3))(
        jc, jnp.asarray(ids), cfg, jnp.bfloat16)
    got = tclip.apply_text(tc, torch.from_numpy(ids),
                           bridge.config(cfg, tclip.ClipTextConfig),
                           torch.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _relnorm(g.float().numpy(),
                        np.asarray(w.astype(jnp.float32))) < 2e-2


def test_get_logger_writes_the_log_file(tmp_path):
    from domainrag_tpu_torch.core import log as tlog
    path = tmp_path / "sub" / "run.log"
    logger = tlog.get_logger("test_api_names.file", str(path),
                             logging.WARNING)
    try:
        assert logger.level == logging.WARNING
        logger.info("not written")
        logger.warning("the record")
        for h in logger.handlers:
            h.flush()
        text = path.read_text()
        assert "the record" in text and "not written" not in text
        assert "[WARNING] test_api_names.file: the record" in text
    finally:
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()


def test_native_resize_off_goes_to_pil(monkeypatch):
    from PIL import Image
    from domainrag_tpu_torch.core import imaging
    img = Image.fromarray(_rng(8).integers(0, 256, (37, 53, 3),
                                           dtype=np.uint8))
    monkeypatch.setattr(imaging, "USE_NATIVE_RESIZE", False)
    before = dict(imaging.resize_counts)
    for method in (Image.BICUBIC, Image.BILINEAR):
        got = imaging._resize_rgb(img, (24, 31), method)
        assert got.tobytes() == np.asarray(img.resize((24, 31), method)
                                           ).tobytes()
    assert imaging.resize_counts["pil"] == before["pil"] + 2
    assert imaging.resize_counts["native"] == before["native"]


def test_host_conversion_builds_on_the_cpu():
    from domainrag_tpu_torch.models import convert
    torch.set_default_device("meta")
    try:
        with convert.host_conversion():
            inside = [torch.zeros(2).device, torch.randn(2).device,
                      torch.tensor([1.0]).device]
        after = torch.zeros(2).device
    finally:
        torch.set_default_device(None)
    assert [d.type for d in inside] == ["cpu"] * 3
    assert after.type == "meta"


@pytest.fixture(scope="module")
def vae_trees():
    from domainrag_tpu.models.flux import vae as jvae
    jp = jvae.init(jax.random.PRNGKey(9), jvae.TINY_VAE)
    return jp, bridge.params(jax.tree.map(np.asarray, jp), device="cpu")


def test_vae_encode_samples_with_a_generator(vae_trees):
    """With a PRNG key in JAX's slot the port samples the posterior with
    JAX's draw: JAX's own ``encode(key)`` within 1e-4. A torch.Generator
    in that slot raises TypeError naming prng.PRNGKey; without a key the
    latents are the mode."""
    from domainrag_tpu.models.flux import vae as jvae
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.models.flux import vae as tvae
    jp, tp = vae_trees
    cfg = bridge.config(jvae.TINY_VAE, tvae.VaeConfig)
    x = _rng(9).uniform(-1, 1, (2, 16, 12, 3)).astype(np.float32)
    moments = np.asarray(jvae.encode_moments(jp, jnp.asarray(x),
                                             jvae.TINY_VAE))
    want = np.asarray(jvae.encode(jp, jnp.asarray(x), jvae.TINY_VAE,
                                  key=jax.random.PRNGKey(11)))
    got = tvae.encode(tp, torch.from_numpy(x), cfg, prng.PRNGKey(11))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(TypeError, match="prng.PRNGKey"):
        tvae.encode(tp, torch.from_numpy(x), cfg,
                    torch.Generator().manual_seed(11))
    mode = tvae.encode(tp, torch.from_numpy(x), cfg)
    want_mode = (moments[..., :cfg.latent_channels] - cfg.shift_factor) \
        * cfg.scaling_factor
    np.testing.assert_allclose(mode.numpy(), want_mode, rtol=1e-4, atol=1e-4)


def test_vae_encode_tiled_draws_the_same_noise_in_every_tile(vae_trees,
                                                             monkeypatch):
    """JAX hands every tile the same key, so every tile gets the same
    normal draw; the port's ``encode_tiled(key)`` is JAX's own within
    1e-4."""
    from domainrag_tpu.models.flux import vae as jvae
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.models.flux import vae as tvae
    jp, tp = vae_trees
    cfg = bridge.config(jvae.TINY_VAE, tvae.VaeConfig)
    tile, overlap = 6, 2
    x = _rng(10).uniform(-1, 1, (1, 28, 12, 3)).astype(np.float32)
    f = cfg.spatial_factor
    shape = (1, tile, tile, cfg.latent_channels)
    draws = []
    normal = jax.random.normal

    def same_draw(key, s, dtype=jnp.float32):
        draws.append((np.asarray(jax.random.key_data(key)
                                 if jnp.issubdtype(key.dtype,
                                                   jax.dtypes.prng_key)
                                 else key).tobytes(), tuple(s)))
        return normal(key, s, dtype)

    monkeypatch.setattr(jax.random, "normal", same_draw)
    want = np.asarray(jvae.encode_tiled(jp, jnp.asarray(x), jvae.TINY_VAE,
                                        tile, overlap,
                                        key=jax.random.PRNGKey(12)))
    monkeypatch.undo()
    n_tiles = len(range(0, max(28 // f - overlap, 1), tile - overlap)) * \
        len(range(0, max(12 // f - overlap, 1), tile - overlap))
    assert n_tiles > 1 and len(draws) == n_tiles
    assert len(set(draws)) == 1 and draws[0][1] == shape
    got = tvae.encode_tiled(tp, torch.from_numpy(x), cfg, tile, overlap,
                            prng.PRNGKey(12))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_train_step_matches_jax():
    """JAX's ``train_step`` and the port's on the same params and batch,
    the port fed the t and eps JAX draws from its key: the loss within
    1e-5 and each leaf's update within 1e-3 in relative norm."""
    from domainrag_tpu.models.flux import model as jflux
    from domainrag_tpu.train import flow_match as jflow
    from domainrag_tpu_torch.models.flux import model as tflux
    from domainrag_tpu_torch.train import flow_match as tflow
    from test_torch_train import _batch, _jax_t_eps, _np, _port
    cfg = jflux.TINY_FLUX
    params = jflux.init(jax.random.PRNGKey(13), cfg)
    batch = _batch(cfg, seed=3)
    train_cfg = jflow.TrainConfig(learning_rate=1e-3, remat=False)
    opt = jflow.make_optimizer(train_cfg)
    key = jax.random.PRNGKey(14)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # jitted: the same step, compiled once instead of run op by op
    jparams, _, jloss = jax.jit(jflow.train_step, static_argnums=(4, 5, 6))(
        params, opt.init(params), jbatch, key, cfg, train_cfg, opt)
    t, eps = _jax_t_eps(key, jbatch["x0"], train_cfg)
    tparams = _port(params)
    tcfg = bridge.config(train_cfg, tflow.TrainConfig)
    optimizer = tflow.make_optimizer(tcfg)
    out, opt_state, loss = tflow.train_step(
        tparams, optimizer.init(tparams),
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
        None, bridge.config(cfg, tflux.FluxConfig), tcfg, optimizer,
        t=torch.tensor(np.asarray(t)), eps=torch.tensor(np.asarray(eps)))
    assert out is tparams
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    start = tflow.leaves(_port(params))
    for got, want, p0 in zip(tflow.leaves(out),
                             tflow.leaves(_port(_np(jparams))), start):
        d_got, d_want = (got.detach() - p0).numpy(), (want - p0).numpy()
        assert _relnorm(d_got, d_want) < 1e-3
