"""The stage-3 slice of the port end to end, and the port's structure.

Parity: on the JAX package's ``tiny_bundle`` weights (carried by
domainrag_tpu_torch.bridge), ``redux_prior_pairs_indexed`` followed by
``generate``, with the JAX noise (``jax.random.normal(PRNGKey(seed))``)
handed to the port as a tensor. Both run in f32 on the CPU, so the
conditioning agrees to 1e-4 and the f32 image to 1e-3 after 4 Euler
steps and the VAE decode; the uint8 image within 1 level (a value on a
rounding edge may land on either side).
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from domainrag_tpu.models.flux import pipeline as jfp
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.core.config import (FluxSamplingConfig,
                                             GenerateConfig, ReduxConfig)
from domainrag_tpu_torch.core.log import StepTimer
from domainrag_tpu_torch.models import clip as tclip
from domainrag_tpu_torch.models import redux as tredux
from domainrag_tpu_torch.models import siglip as tsiglip
from domainrag_tpu_torch.models import t5 as tt5
from domainrag_tpu_torch.models.flux import model as tflux
from domainrag_tpu_torch.models.flux import pipeline as tfp
from domainrag_tpu_torch.models.flux import vae as tvae
from domainrag_tpu_torch.ops import attention as tattn
from domainrag_tpu_torch.ops import mmdit_attention as tmma
from domainrag_tpu_torch.stages import generate as tgen

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "domainrag_tpu_torch"
HEIGHT = WIDTH = 32
STEPS = 4
SEEDS = [0, 1]


def _port_bundle(jb):
    """The JAX bundle's weights and configs as a port bundle on the CPU."""
    cfgs = tfp.tiny_configs()
    trees = {name: bridge.params(jax.tree.map(np.asarray, getattr(jb, name)),
                                 device="cpu")
             for name in ("flux_params", "vae_params", "t5_params",
                          "clip_text_params", "siglip_params",
                          "redux_params")}
    port_cfgs = dict(
        flux_cfg=bridge.config(jb.flux_cfg, tflux.FluxConfig),
        vae_cfg=bridge.config(jb.vae_cfg, tvae.VaeConfig),
        t5_cfg=bridge.config(jb.t5_cfg, tt5.T5Config),
        clip_text_cfg=bridge.config(jb.clip_text_cfg, tclip.ClipTextConfig),
        siglip_cfg=bridge.config(jb.siglip_cfg, tsiglip.SiglipVisionConfig),
        redux_cfg=bridge.config(jb.redux_cfg, tredux.ReduxEncoderConfig))
    assert port_cfgs == cfgs          # the port's tiny configs are JAX's
    return tfp.FluxBundle(**trees, **port_cfgs, **tfp.tiny_tokenizers(cfgs),
                          compute_dtype=torch.float32,
                          device=torch.device("cpu"))


@pytest.fixture(scope="module")
def bundles():
    jb = jfp.tiny_bundle(jax.random.PRNGKey(0))
    return jb, _port_bundle(jb)


@pytest.fixture(scope="module")
def priors(bundles):
    jb, tb = bundles
    size = jb.siglip_cfg.image_size
    uniq = np.random.default_rng(3).uniform(
        -1, 1, (3, size, size, 3)).astype(np.float32)
    pair_idx = np.asarray([[0, 2], [1, 2]])
    args = (uniq, pair_idx, "", [0.8, 1.0], [1.0, 1.0])
    return (jfp.redux_prior_pairs_indexed(jb, *args),
            tfp.redux_prior_pairs_indexed(tb, *args))


def _t(x):
    return torch.tensor(np.asarray(x))


def _jax_noise(jb):
    seq = (HEIGHT // jb.latent_factor) * (WIDTH // jb.latent_factor)
    c = jb.vae_cfg.latent_channels * 4
    return jnp.stack([jax.random.normal(jax.random.PRNGKey(s), (seq, c),
                                        jnp.float32) for s in SEEDS])


def test_prior_matches_jax(priors):
    (je, jp), (te, tp) = priors
    assert tuple(te.shape) == je.shape and tuple(tp.shape) == jp.shape
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4,
                               rtol=1e-4)


def test_single_pair_prior_matches_jax(bundles):
    jb, tb = bundles
    size = jb.siglip_cfg.image_size
    images = np.random.default_rng(5).uniform(
        -1, 1, (2, size, size, 3)).astype(np.float32)
    args = (images, ["", ""], [0.8, 1.0], [1.0, 0.5])
    want = jfp.redux_prior(jb, *args)
    got = tfp.redux_prior(tb, *args)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_generate_float_matches_jax(bundles, priors):
    jb, tb = bundles
    (je, jp), _ = priors
    lf = jb.latent_factor
    noise = _jax_noise(jb)
    sigmas = jfp.sched_mod.make_schedule(
        STEPS, image_seq_len=(HEIGHT // lf) * (WIDTH // lf)).sigmas
    want = jfp._generate_core(
        jb.flux_params, jb.vae_params, noise, je, jp, jnp.asarray(sigmas),
        jnp.float32(2.5), cfg=jb.flux_cfg, vae_cfg=jb.vae_cfg,
        grid_h=HEIGHT // lf, grid_w=WIDTH // lf)
    got = tfp._generate_float(tb, _t(je), _t(jp), HEIGHT, WIDTH, STEPS,
                              2.5, _t(noise))
    assert tuple(got.shape) == (2, HEIGHT, WIDTH, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=0)


def test_generate_uint8_matches_jax(bundles, priors):
    jb, tb = bundles
    (je, jp), _ = priors
    want = jfp.generate(jb, je, jp, height=HEIGHT, width=WIDTH,
                        num_steps=STEPS, seed=SEEDS)
    got = tfp.generate(tb, _t(je), _t(jp), height=HEIGHT, width=WIDTH,
                       num_steps=STEPS, seed=SEEDS,
                       noise=_t(_jax_noise(jb)))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("kwargs", [
    dict(mesh=object()), dict(pipe_axis="pipe"),
    dict(block_cache_interval=2), dict(velocity_cache_interval=2)],
    ids=["mesh", "pipe_axis", "block_cache", "velocity_cache"])
def test_generate_rejects_unported_modes(bundles, priors, kwargs):
    """A mesh argument that is not a mesh, and a pipe axis without a mesh,
    raise the JAX package's errors (type and text; the mesh path is
    ``tests/test_torch_scaleout_serve.py``'s); the caches run and give
    JAX's images (uint8 within 1 level) from JAX's noise."""
    jb, tb = bundles
    (je, jp), (te, tp) = priors
    if "mesh" in kwargs or "pipe_axis" in kwargs:
        with pytest.raises(Exception) as want:
            jfp.generate(jb, je, jp, height=HEIGHT, width=WIDTH, num_steps=1,
                         **kwargs)
        with pytest.raises(type(want.value)) as got:
            tfp.generate(tb, te, tp, height=HEIGHT, width=WIDTH,
                         num_steps=1, **kwargs)
        assert str(got.value) == str(want.value)
        return
    kw = dict(height=HEIGHT, width=WIDTH, num_steps=STEPS, seed=SEEDS,
              **kwargs)
    want = jfp.generate(jb, je, jp, **kw)
    got = tfp.generate(tb, _t(je), _t(jp), noise=_t(_jax_noise(jb)), **kw)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _sample_files(tmp_path, n_refs):
    rng = np.random.default_rng(9)
    target = tmp_path / "target.png"
    Image.fromarray(rng.integers(0, 255, (20, 24, 3), dtype=np.uint8)
                    ).save(target)
    refs = []
    for i in range(n_refs):
        p = tmp_path / f"ref{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (24, 20, 3), dtype=np.uint8)
                        ).save(p)
        refs.append({"image_path": str(p), "rank": i + 1,
                     "similarity": 0.9 - 0.1 * i})
    return str(target), refs


def test_generate_stage_writes_artifacts_and_chunks(bundles, tmp_path):
    """generate_sample writes the stage-3 file set, and max_rank_batch
    chunking gives the images of the one-batch denoise."""
    _, tb = bundles
    target, refs = _sample_files(tmp_path, 3)
    base = GenerateConfig(
        sampling=FluxSamplingConfig(num_steps=2, height=HEIGHT, width=WIDTH),
        redux=ReduxConfig(), top_ranks=3)
    one = tgen.GenerateStage(tb, base).generate_sample(
        "s", target, refs, str(tmp_path / "one"))
    two = tgen.GenerateStage(
        tb, dataclasses.replace(base, max_rank_batch=2)).generate_sample(
        "s", target, refs, str(tmp_path / "two"))
    assert [os.path.basename(p) for p in one] == [
        f"generated_image_rank{r}.png" for r in (1, 2, 3)]
    for a, b in zip(one, two):
        ia, ib = np.asarray(Image.open(a)), np.asarray(Image.open(b))
        assert ia.shape == (HEIGHT, WIDTH, 3) and ia.dtype == np.uint8
        assert np.abs(ia.astype(int) - ib.astype(int)).max() <= 1
    files = set(os.listdir(tmp_path / "one"))
    assert {"target_input.png", "params.txt", "ref_inputrank1.jpg",
            "ref_inforank1_sim0.9000.txt"} <= files
    assert "num_inference_steps: 2" in (tmp_path / "one" /
                                        "params.txt").read_text()


def test_generate_stage_times_each_step_and_decode(bundles, tmp_path):
    """The stage's timer gets a synced span per denoise step of every rank
    chunk and one decode span per chunk, and the prior's inputs, text
    towers and image towers inside the prior."""
    _, tb = bundles
    target, refs = _sample_files(tmp_path, 3)
    cfg = GenerateConfig(
        sampling=FluxSamplingConfig(num_steps=2, height=HEIGHT, width=WIDTH),
        redux=ReduxConfig(), top_ranks=3, max_rank_batch=2)
    syncs = []
    timer = StepTimer(sync=lambda: syncs.append(1))
    tgen.GenerateStage(tb, cfg).generate_sample(
        "s", target, refs, str(tmp_path / "s"), timer=timer)
    assert timer.counts == {"prior": 1, "prior/inputs": 1, "prior/text": 1,
                            "prior/image": 1, "denoise": 1, "step": 4,
                            "decode": 2, "save": 1}
    assert len(syncs) == 2 * sum(timer.counts.values())


def test_generate_counts_nonfinite_images(bundles, priors):
    """An image that is not finite before quantisation is counted."""
    _, tb = bundles
    _, (te, tp) = priors
    seq = (HEIGHT // tb.latent_factor) * (WIDTH // tb.latent_factor)
    noise = torch.zeros((2, seq, tb.vae_cfg.latent_channels * 4))
    noise[1, 0, 0] = float("nan")
    before = tfp.generate.nonfinite_images
    tfp.generate(tb, te, tp, height=HEIGHT, width=WIDTH, num_steps=1,
                 noise=noise)
    assert tfp.generate.nonfinite_images == before + 1


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "domainrag_tpu"), (
                f"{path.name} imports {name}")


def test_import_check_covers_the_trainer():
    """The import check above walks the trainer's modules and the generic
    flash attention too."""
    names = {str(p.relative_to(PORT)) for p in _port_files()
             if p.is_relative_to(PORT)}
    assert {"ops/attention.py", "train/flow_match.py", "train/loop.py",
            "train/checkpoint.py", "train/__init__.py"} <= names


def test_import_check_covers_scale_out():
    """The import check above walks ``parallel/`` and the ring too."""
    names = {str(p.relative_to(PORT)) for p in _port_files()
             if p.is_relative_to(PORT)}
    assert {"parallel/mesh.py", "parallel/multihost.py",
            "parallel/sharding.py", "parallel/collectives.py",
            "parallel/deploy.py", "parallel/pipeline_parallel.py",
            "ops/ring_attention.py"} <= names


def test_import_check_covers_the_int8_modes():
    """The import check above walks the int8 serving modules too."""
    names = {str(p.relative_to(PORT)) for p in _port_files()
             if p.is_relative_to(PORT)}
    assert {"models/quant.py", "ops/int8_gemm.py", "models/common.py",
            "ops/mmdit_attention.py"} <= names


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfp.tiny_bundle()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bridge.params({"w": np.zeros((2, 2), np.float32)})


def test_wrappers_launch_or_raise_off_cpu(monkeypatch):
    """A tensor off the CPU goes to the kernel launcher and nowhere else:
    when the launcher fails, the wrapper raises and counts no launch."""
    def no_kernel():
        raise RuntimeError("no kernel here")

    monkeypatch.setattr(tmma, "_lib", no_kernel)
    monkeypatch.setattr(tattn, "_lib", no_kernel)
    heads, hd = 2, 128
    meta = dict(device="meta", dtype=torch.bfloat16)
    norm = {"q": {"scale": torch.ones(hd)}, "k": {"scale": torch.ones(hd)}}
    txt = torch.empty(1, 8, 3 * heads * hd, **meta)
    img = torch.empty(1, 16, 3 * heads * hd, **meta)
    cos = sin = torch.zeros(24, hd // 2)
    before = (tmma.mmdit_double_attention.launches,
              tmma.mmdit_single_attention.launches)
    with pytest.raises(RuntimeError, match="no kernel here"):
        tmma.mmdit_double_attention(txt, img, norm, norm, cos, sin, heads, hd)
    with pytest.raises(RuntimeError, match="no kernel here"):
        tmma.mmdit_single_attention(torch.cat([txt, img], 1), norm, cos,
                                    sin, heads, hd)
    # another head width takes the unfused composition: the generic flash
    # kernel (B5), which raises here as well
    norm64 = {"q": {"scale": torch.ones(64, device="meta")},
              "k": {"scale": torch.ones(64, device="meta")}}
    tab64 = torch.zeros(24, 32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel here"):
        tmma.mmdit_single_attention(torch.cat([txt, img], 1), norm64, tab64,
                                    tab64, 3, 64)
    assert before == (tmma.mmdit_double_attention.launches,
                      tmma.mmdit_single_attention.launches)


def test_package_import_builds_nothing():
    """Importing every module neither builds nor loads a kernel."""
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    if not m.endswith('_build'):\n"
            "        importlib.import_module(m)\n"
            "assert 'domainrag_tpu_torch.ops._build' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
