"""The port's checkpoint conversion (``domainrag_tpu_torch.models.convert``,
``export_diffusers`` and the ``convert_hf_*`` of the model modules)
against the JAX package's, on the CPU.

Limits, each with its reason:
- the safetensors reader: bit-equal to what the ``safetensors`` package
  wrote (the bytes are read back, nothing is computed), keys in file
  order then sorted order within each file, as ``safe_open.keys()``;
- every converter, with f32 compute: its tree equal, bit for bit, to
  ``bridge.params`` of the JAX converter's tree on the same source (both
  widen or keep f32 values and transpose; no arithmetic). With bf16
  compute the MMDiT's linears are that tree rounded to bf16 and the
  qk-norm scales stay f32;
- ``block_transform=quantize_tree``: equal to the bridged JAX quantized
  tree (K-major ``w_q``; the same f32 arithmetic on both sides);
- the exporters: equal to the JAX exporters on the bridged tree, and
  export -> convert returns the tree (a permutation of tensors).
"""

import ast
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from domainrag_tpu.core.config import PipelineConfig as JPipelineConfig
from domainrag_tpu.models import clip as jclip
from domainrag_tpu.models import convert as jconvert
from domainrag_tpu.models import export_diffusers as jexport
from domainrag_tpu.models import lama as jlama
from domainrag_tpu.models import quant as jquant
from domainrag_tpu.models import redux as jredux
from domainrag_tpu.models import siglip as jsiglip
from domainrag_tpu.models import t5 as jt5
from domainrag_tpu.models.flux import model as jflux
from domainrag_tpu.models.flux import vae as jvae
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.core import prng
from domainrag_tpu_torch.core.config import PipelineConfig
from domainrag_tpu_torch.models import clip as tclip
from domainrag_tpu_torch.models import convert as tconvert
from domainrag_tpu_torch.models import export_diffusers as texport
from domainrag_tpu_torch.models import lama as tlama
from domainrag_tpu_torch.models import quant as tquant
from domainrag_tpu_torch.models import redux as tredux
from domainrag_tpu_torch.models import siglip as tsiglip
from domainrag_tpu_torch.models import t5 as tt5
from domainrag_tpu_torch.models.flux import model as tflux
from domainrag_tpu_torch.models.flux import vae as tvae

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(device="cpu")


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (i,)))
        return out
    return {path: tree}


def _bridged(jtree):
    return bridge.params(jax.tree.map(np.asarray, jtree), **CPU)


def assert_same_tree(got, want):
    """Same paths, dtypes, shapes and bits."""
    g, w = _flat(got), _flat(want)
    assert sorted(g, key=str) == sorted(w, key=str)
    for path, a in g.items():
        b = w[path]
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# the safetensors reader
# ---------------------------------------------------------------------------

def _write_files(tmp_path):
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as save_torch

    rng = np.random.default_rng(0)
    a = {"zeta": rng.standard_normal((3, 5)).astype(np.float32),
         "alpha": rng.standard_normal((4,)).astype(np.float16),
         "mid.count": rng.integers(-2**40, 2**40, (2, 3), dtype=np.int64),
         "empty": np.zeros((0, 4), np.float32)}
    b = {"b.weight": torch.randn(7, 3, generator=torch.Generator()
                                 .manual_seed(1)).to(torch.bfloat16),
         "a.scalar": torch.tensor(2.5, dtype=torch.bfloat16),
         "c.odd": torch.arange(5, dtype=torch.int8)}
    save_file(a, str(tmp_path / "model-00001.safetensors"))
    save_torch(b, str(tmp_path / "model-00002.safetensors"))
    want = {k: torch.from_numpy(v) for k, v in a.items()}
    want.update(b)
    return want


def test_reader_matches_safetensors(tmp_path):
    from safetensors import safe_open

    want = _write_files(tmp_path)
    sd = tconvert.load_safetensors_dir(str(tmp_path))
    order = []
    for name in sorted(os.listdir(tmp_path)):
        with safe_open(str(tmp_path / name), framework="pt") as f:
            order.extend(f.keys())
    assert list(sd.keys()) == list(sd) == order and len(sd) == 7
    for key, value in want.items():
        got = sd[key]
        assert got.dtype == value.dtype and got.shape == value.shape, key
        assert torch.equal(got, value), key
    eager = tconvert.load_safetensors_dir(str(tmp_path), lazy=False)
    assert list(eager) == order
    for key, value in eager.items():
        assert torch.equal(value, want[key]), key
    one = tconvert.load_safetensors_dir(str(tmp_path /
                                            "model-00002.safetensors"))
    assert sorted(one) == ["a.scalar", "b.weight", "c.odd"]


def test_reader_is_lazy(tmp_path, monkeypatch):
    """Nothing is mapped before ``__getitem__``; each read maps exactly
    the tensor asked for, and nothing is kept."""
    _write_files(tmp_path)
    mapped = []
    real = tconvert.mmap.mmap

    def counting(fileno, length, **kw):
        mapped.append(length)
        return real(fileno, length, **kw)

    monkeypatch.setattr(tconvert.mmap, "mmap", counting)
    sd = tconvert.load_safetensors_dir(str(tmp_path))
    assert "zeta" in sd and "nope" not in sd and mapped == []
    sd["zeta"]
    sd["zeta"]
    assert len(mapped) == 2                  # not cached
    sd["empty"]
    assert len(mapped) == 2                  # an empty tensor maps nothing


def test_converted_tensors_own_their_memory(tmp_path):
    """A converted CPU tensor is a copy: writing to it leaves the mapped
    file alone."""
    from safetensors.numpy import save_file
    save_file({"redux_up.weight": np.ones((6, 4), np.float32),
               "redux_up.bias": np.zeros(6, np.float32),
               "redux_down.weight": np.ones((4, 6), np.float32),
               "redux_down.bias": np.zeros(4, np.float32)},
              str(tmp_path / "r.safetensors"))
    p = tredux.convert_hf_redux(tconvert.load_safetensors_dir(str(tmp_path)),
                                **CPU)
    p["up"]["w"].add_(1.0)
    again = tconvert.load_safetensors_dir(str(tmp_path))["redux_up.weight"]
    assert torch.equal(again, torch.ones(6, 4))


def test_port_imports_no_safetensors():
    """The port reads the format itself; no module of it (nor the smoke
    script) imports the ``safetensors`` package."""
    files = sorted((ROOT / "domainrag_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert all(n.split(".")[0] != "safetensors" for n in names), \
                path


# ---------------------------------------------------------------------------
# Flux transformer and VAE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flux_sd():
    cfg = jflux.TINY_FLUX
    params = jflux.init(jax.random.PRNGKey(0), cfg)
    return cfg, params, jexport.export_flux_to_diffusers(params, cfg)


@pytest.fixture(scope="module")
def vae_sd():
    cfg = jvae.TINY_VAE
    params = jvae.init(jax.random.PRNGKey(1), cfg)
    return cfg, params, jexport.export_vae_to_diffusers(params)


def test_flux_transformer_matches_jax(flux_sd):
    jcfg, _, sd = flux_sd
    cfg = bridge.config(jcfg, tflux.FluxConfig)
    got = tconvert.convert_flux_transformer(sd, cfg, **CPU)
    assert_same_tree(got, _bridged(jconvert.convert_flux_transformer(
        sd, jcfg)))


def test_flux_transformer_bf16_keeps_scales_f32(flux_sd):
    jcfg, _, sd = flux_sd
    cfg = bridge.config(jcfg, tflux.FluxConfig)
    got = _flat(tconvert.convert_flux_transformer(sd, cfg, **CPU,
                                                  dtype=torch.bfloat16))
    want = _flat(_bridged(jconvert.convert_flux_transformer(sd, jcfg)))
    assert sorted(got, key=str) == sorted(want, key=str)
    for path, a in got.items():
        if "scale" in path:
            assert torch.equal(a, want[path]), path
        else:
            assert torch.equal(a, want[path].to(torch.bfloat16)), path


def test_flux_transformer_block_transform_matches_jax(flux_sd):
    """Quantized blocks: K-major ``w_q`` equal to the bridged JAX
    quantized tree (min_size 1024 so the tiny blocks quantize)."""
    jcfg, _, sd = flux_sd
    cfg = bridge.config(jcfg, tflux.FluxConfig)
    got = tconvert.convert_flux_transformer(
        sd, cfg, block_transform=lambda b: tquant.quantize_tree(b, 1024),
        **CPU)
    want = jconvert.convert_flux_transformer(
        sd, jcfg, block_transform=lambda b: jquant.quantize_tree(b, 1024))
    assert any("w_q" in p for p in _flat(got))
    assert_same_tree(got, _bridged(want))


def test_flux_vae_matches_jax(vae_sd):
    jcfg, _, sd = vae_sd
    got = tconvert.convert_flux_vae(sd, bridge.config(jcfg, tvae.VaeConfig),
                                    **CPU)
    assert_same_tree(got, _bridged(jconvert.convert_flux_vae(sd, jcfg)))


def _numpy_sd(sd):
    return {k: np.asarray(v) for k, v in sd.items()}


def test_exporters_match_jax(flux_sd, vae_sd):
    jcfg, jparams, jsd = flux_sd
    sd = texport.export_flux_to_diffusers(
        _bridged(jparams), bridge.config(jcfg, tflux.FluxConfig))
    assert list(sd) == list(jsd)
    for k, v in _numpy_sd(sd).items():
        np.testing.assert_array_equal(v, jsd[k], err_msg=k)
    _, jvparams, jvsd = vae_sd
    vsd = texport.export_vae_to_diffusers(_bridged(jvparams))
    assert list(vsd) == list(jvsd)
    for k, v in _numpy_sd(vsd).items():
        np.testing.assert_array_equal(v, jvsd[k], err_msg=k)


def test_export_then_convert_is_identity(flux_sd, vae_sd):
    jcfg, jparams, _ = flux_sd
    cfg = bridge.config(jcfg, tflux.FluxConfig)
    tree = _bridged(jparams)
    back = tconvert.convert_flux_transformer(
        texport.export_flux_to_diffusers(tree, cfg), cfg, **CPU)
    assert_same_tree(back, tree)
    vcfg, jvparams, _ = vae_sd
    vtree = _bridged(jvparams)
    vback = tconvert.convert_flux_vae(texport.export_vae_to_diffusers(vtree),
                                      bridge.config(vcfg, tvae.VaeConfig),
                                      **CPU)
    assert_same_tree(vback, vtree)


# ---------------------------------------------------------------------------
# the tiny checkpoint tree of tools/real_weights_harness.py
# ---------------------------------------------------------------------------

def _port_configs(jconfigs):
    """The harness's JAX configs as the port's, by field name."""
    classes = {"flux": tflux.FluxConfig, "flux_fill": tflux.FluxConfig,
               "vae": tvae.VaeConfig, "t5": tt5.T5Config,
               "clip_text": tclip.ClipTextConfig,
               "siglip": tsiglip.SiglipVisionConfig,
               "redux": tredux.ReduxEncoderConfig,
               "clip_vision": tclip.ClipVisionConfig,
               "lama": tlama.LamaConfig}
    return {k: bridge.config(v, classes[k]) if k in classes else v
            for k, v in jconfigs.items()}


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    pytest.importorskip("transformers")
    tools = str(ROOT / "tools")
    sys.path.insert(0, tools)
    try:
        import real_weights_harness as harness
    finally:
        sys.path.remove(tools)
    ckpt = tmp_path_factory.mktemp("ckpt")
    jconfigs = harness.synthesize_tiny_checkpoints(str(ckpt))
    return str(ckpt), jconfigs, _port_configs(jconfigs)


def _sub(ckpt, name):
    return os.path.join(ckpt, name)


@pytest.mark.parametrize("name", ["clip_vision", "clip_text", "t5",
                                  "siglip", "redux"])
def test_convert_hf_matches_jax(tiny_ckpt, name):
    ckpt, jc, tc = tiny_ckpt
    jl = jconvert.load_safetensors_dir
    tl = tconvert.load_safetensors_dir
    if name == "clip_vision":
        want = jclip.convert_hf_clip_vision(jl(_sub(ckpt, "clip-vision")),
                                            jc["clip_vision"])
        got = tclip.convert_hf_clip_vision(tl(_sub(ckpt, "clip-vision")),
                                           tc["clip_vision"], **CPU)
    elif name == "clip_text":
        want = jclip.convert_hf_clip_text(jl(_sub(ckpt, "clip-text")),
                                          jc["clip_text"])
        got = tclip.convert_hf_clip_text(tl(_sub(ckpt, "clip-text")),
                                         tc["clip_text"], **CPU)
    elif name == "t5":
        want = jt5.convert_hf_t5(jl(_sub(ckpt, "t5")), jc["t5"])
        got = tt5.convert_hf_t5(tl(_sub(ckpt, "t5")), tc["t5"], **CPU)
    elif name == "siglip":
        want = jsiglip.convert_hf_siglip(jl(_sub(ckpt, "siglip")),
                                         jc["siglip"])
        got = tsiglip.convert_hf_siglip(tl(_sub(ckpt, "siglip")),
                                        tc["siglip"], **CPU)
    else:
        want = jredux.convert_hf_redux(jl(_sub(ckpt, "redux")))
        got = tredux.convert_hf_redux(tl(_sub(ckpt, "redux")), **CPU)
    assert_same_tree(got, _bridged(want))


def test_clip_text_without_projection_is_identity(tiny_ckpt):
    ckpt, jc, tc = tiny_ckpt
    sd = {k: v for k, v in
          jconvert.load_safetensors_dir(_sub(ckpt, "clip-text")).items()
          if not k.startswith("text_projection")}
    got = tclip.convert_hf_clip_text(sd, tc["clip_text"], **CPU)
    assert_same_tree(got, _bridged(jclip.convert_hf_clip_text(
        sd, jc["clip_text"])))


BUNDLE_TREES = ("flux_params", "vae_params", "t5_params",
                "clip_text_params", "siglip_params", "redux_params")


def _fill_configs(configs):
    """The harness's way to load the Fill bundle (its configs carry the
    tiny Fill MMDiT under "flux_fill")."""
    out = dict(configs)
    out["flux"] = configs["flux_fill"]
    return out


@pytest.mark.parametrize("fill", [False, True])
def test_load_flux_bundle_matches_jax(tiny_ckpt, fill):
    ckpt, jc, tc = tiny_ckpt
    if fill:
        jc, tc = _fill_configs(jc), _fill_configs(tc)
    want = jconvert.load_flux_bundle(ckpt, fill=fill, configs=jc)
    got = tconvert.load_flux_bundle(ckpt, fill=fill, configs=tc,
                                    compute_dtype=torch.float32, **CPU)
    for name in BUNDLE_TREES:
        assert_same_tree(getattr(got, name), _bridged(getattr(want, name)))
    assert got.flux_cfg == tc["flux"] and got.t5_cfg == tc["t5"]
    assert (got.t5_max_len, got.clip_max_len) == (want.t5_max_len,
                                                  want.clip_max_len) \
        == (16, 16)
    assert got.compute_dtype == torch.float32
    # no tokenizer dirs in the tree: the JAX stub ids, from the same vocab
    for a, b in ((got.clip_tokenizer, want.clip_tokenizer),
                 (got.t5_tokenizer, want.t5_tokenizer)):
        np.testing.assert_array_equal(a("a small red fish", 12),
                                      b("a small red fish", 12))


def test_load_flux_bundle_bf16_default(tiny_ckpt):
    ckpt, _, tc = tiny_ckpt
    got = tconvert.load_flux_bundle(ckpt, configs=tc, **CPU)
    assert got.compute_dtype == torch.bfloat16
    assert got.flux_params["img_in"]["w"].dtype == torch.bfloat16
    assert got.t5_params["embed"].dtype == torch.float32


def test_runner_shares_the_towers(tiny_ckpt):
    """The runner's two bundles equal two separate loads (both the
    reference's way: the same ``configs`` for dev and Fill) and hold one
    copy of the shared trees; its retrieval and inpaint models equal the
    JAX converters'."""
    ckpt, jc, tc = tiny_ckpt
    runner = tconvert.build_runner_from_checkpoints(
        ckpt, PipelineConfig(), configs=tc, **CPU)
    for bundle, fill in ((runner.flux_bundle, False),
                         (runner.fill_bundle, True)):
        alone = tconvert.load_flux_bundle(ckpt, fill=fill, configs=tc, **CPU)
        for name in BUNDLE_TREES:
            assert_same_tree(getattr(bundle, name), getattr(alone, name))
        assert bundle.flux_cfg == tc["flux"]       # the reference's quirk
    for name in BUNDLE_TREES[1:]:
        a = _flat(getattr(runner.flux_bundle, name))
        b = _flat(getattr(runner.fill_bundle, name))
        assert all(a[p] is b[p] for p in a), name
    jrunner = jconvert.build_runner_from_checkpoints(
        ckpt, JPipelineConfig(), configs=jc)
    assert_same_tree(runner.clip_encoder._params,
                     _bridged(jrunner.clip_encoder._params))
    assert_same_tree(runner.style_encoder._params,
                     _bridged(jrunner.style_encoder._params))
    assert_same_tree(runner.lama_runner.params,
                     _bridged(jrunner.lama_runner.params))
    assert {k for k in runner.timer.counts} == {
        f"load/{d}" for d in ("clip-vision", "resnet-stem", "lama", "vae",
                              "t5", "clip-text", "siglip", "redux",
                              "flux-dev", "flux-fill")}


def test_load_takes_the_hf_tokenizers(tiny_ckpt, monkeypatch):
    """Tokenizer dirs present: the loaded tokenizers are used."""
    ckpt, _, tc = tiny_ckpt
    from domainrag_tpu_torch.core import text as ttext

    class Tok:
        def __call__(self, text, padding, max_length, truncation,
                     return_tensors):
            return {"input_ids": np.arange(max_length)[None]}

    monkeypatch.setattr(ttext, "load_hf_tokenizers",
                        lambda path: (ttext.HFTokenizer(Tok()),
                                      ttext.HFTokenizer(Tok())))
    got = tconvert.load_flux_bundle(ckpt, configs=tc, **CPU)
    ids = got.t5_tokenizer("anything", 6)
    assert ids.dtype == np.int32 and list(ids) == list(range(6))


# ---------------------------------------------------------------------------
# LaMa
# ---------------------------------------------------------------------------

def _lama_sd(params, order_fn):
    sd = {}
    for i, (path, leaf) in enumerate(order_fn(params)):
        arr = np.asarray(leaf)
        if arr.ndim == 4:                      # HWIO -> torch (O, I, kh, kw)
            arr = arr.transpose(3, 2, 0, 1)
        sd[f"model.{i}.param"] = arr
    sd["model.bn.num_batches_tracked"] = np.asarray(3)    # 0-d: skipped
    return sd


def test_lama_leaf_order_matches_jax():
    jparams = jlama.init(jax.random.PRNGKey(2), jlama.TINY_LAMA)
    tree = _bridged(jparams)
    assert [p for p, _ in tconvert.lama_leaf_order(tree)] == \
        [p for p, _ in jconvert.lama_leaf_order(jparams)]


def test_convert_lama_matches_jax():
    jparams = jlama.init(jax.random.PRNGKey(2), jlama.TINY_LAMA)
    sd = _lama_sd(jparams, jconvert.lama_leaf_order)
    got = tconvert.convert_lama(sd, bridge.config(jlama.TINY_LAMA,
                                                  tlama.LamaConfig), **CPU)
    assert_same_tree(got, _bridged(jconvert.convert_lama(sd,
                                                          jlama.TINY_LAMA)))


def _raised(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["count", "flat", "conv", "transposed"])
def test_convert_lama_refuses_as_jax(case):
    """The same ValueError text on a mismatch; a transposed conv stored the
    torch ``ConvTranspose2d`` way, (I, O, kh, kw), is refused by both
    (the reference quirk: both ask (O, I, kh, kw) of every 4-D leaf)."""
    cfg = jlama.TINY_LAMA
    jparams = jlama.init(jax.random.PRNGKey(2), cfg)
    order = jconvert.lama_leaf_order(jparams)
    sd = _lama_sd(jparams, jconvert.lama_leaf_order)
    keys = [k for k in sd if k != "model.bn.num_batches_tracked"]
    if case == "count":
        del sd[keys[-1]]
    elif case == "flat":
        sd = {f"p{i}": np.zeros((1, 2, 3)) for i in range(len(order))}
    elif case == "conv":
        sd[keys[0]] = sd[keys[0]][:, :, :1]
    else:
        up = [i for i, (p, _) in enumerate(order)
              if p[:1] == ("up",) and p[-1] == "w"]
        assert up
        k = keys[up[0]]
        sd[k] = np.ascontiguousarray(sd[k].transpose(1, 0, 2, 3))
    tcfg = bridge.config(cfg, tlama.LamaConfig)
    assert _raised(lambda: tconvert.convert_lama(sd, tcfg, **CPU)) == \
        _raised(lambda: jconvert.convert_lama(sd, cfg))


def test_convert_lama_from_files(tiny_ckpt):
    """The harness's ordered-leaf LaMa file through both loaders."""
    ckpt, jc, tc = tiny_ckpt
    got = tconvert.convert_lama(
        tconvert.load_safetensors_dir(_sub(ckpt, "lama")), tc["lama"], **CPU)
    want = jconvert.convert_lama(
        jconvert.load_safetensors_dir(_sub(ckpt, "lama")), jc["lama"])
    assert_same_tree(got, _bridged(want))


def test_big_lama_template_needs_no_memory():
    """``convert_lama`` takes its template from ``lama.init`` on the meta
    device, drawing nothing: at big-lama width the check costs no
    weights."""
    tree = tlama.init(prng.PRNGKey(0, device="meta"), tlama.BIG_LAMA)
    leaves = tconvert.lama_leaf_order(tree)
    assert all(t.is_meta for _, t in leaves)
    assert sum(t.numel() for _, t in leaves) > 20e6
