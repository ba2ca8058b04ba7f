"""The port's serving scale-out (data, pipeline, sequence and tensor
parallelism in ``generate`` / ``fill_batch``, the stage's
``generate_samples_dp``) against one process and against the JAX
package's sharded serving on its 8-device CPU mesh.

The port side runs in one gloo group of four spawned processes
(``torch_scaleout_driver``, suite ``serve``), started once for this file,
on the JAX tiny bundles' weights. Bars, from the JAX package's own tests:
- DP (``tests/test_dp_generate.py``): ``array_equal`` to the sequential
  run, an odd batch padded;
- DP, PP and the SP hires fill from the JAX noise against the JAX
  package's DP ``generate`` / ``generate_samples_dp``, pipelined
  ``generate`` / ``fill_batch`` and hires ``fill_batch`` on its mesh (the
  velocity cache under DP and PP too): within 1 uint8 level on under 5%
  of the pixels, the bar of the TP test below;
- PP (``tests/test_pipeline_parallel.py``): ``generate`` and
  ``fill_batch`` within 1 uint8 level of one process, and ``array_equal``
  at one microbatch, also with the velocity cache
  (``tests/test_vcache.py:135-145``; a row count other than the
  one-process batch's may move a CPU GEMM's last bit, so the JAX
  package's default of one row per microbatch is held within 1 level);
- the hires fill under SP: within 1 uint8 level of one process;
- ``shard_bundle`` (``tests/test_deploy.py``): the prior within rtol 1e-4,
  atol 1e-5, and ``generate`` within 1 level on under 5% of the pixels of
  JAX's TP ``generate``; under W8A8, within 4 levels and 0.3 on average of
  JAX's TP W8A8 ``generate`` (``test_torch_int8_stage._uint8_close``: W8A8
  turns last-bit differences into whole quantisation steps);
- the errors JAX raises, with JAX's type and text.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from PIL import Image

import torch_scaleout_driver as drv
from domainrag_tpu.core import config as jconfig
from domainrag_tpu.models import common as jcommon
from domainrag_tpu.models import quant as jquant
from domainrag_tpu.models.flux import pipeline as jfp
from domainrag_tpu.parallel import deploy as jdeploy
from domainrag_tpu.parallel import mesh as jmesh
from domainrag_tpu.stages import generate as jgen
from test_torch_int8_stage import _uint8_close

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

TREES = ("flux_params", "vae_params", "t5_params", "clip_text_params",
         "siglip_params", "redux_params")


def _trees(jb):
    return {k: jax.tree.map(np.asarray, getattr(jb, k)) for k in TREES}


def _noise(jb, seeds, size=drv.SIZE):
    seq = (size // jb.latent_factor) ** 2
    c = jb.vae_cfg.latent_channels * 4
    return np.stack([np.asarray(jax.random.normal(jax.random.PRNGKey(s),
                                                  (seq, c), jnp.float32))
                     for s in seeds])


def _items(root, n_samples, ranks):
    rng = np.random.default_rng(0)
    items = []
    for i in range(n_samples):
        target = os.path.join(root, f"target_{i}.jpg")
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
                        ).save(target)
        refs = []
        for rank in range(1, ranks + 1):
            ref = os.path.join(root, f"ref_{i}_{rank}.jpg")
            Image.fromarray(rng.integers(0, 255, (36, 36, 3),
                                         dtype=np.uint8)).save(ref)
            refs.append({"rank": rank, "similarity": 0.9,
                         "image_path": ref})
        items.append({"sample_id": f"s{i}", "target_path": target,
                      "refs": refs,
                      "sample_dir": os.path.join(root, "dp", f"s{i}")})
    return items


@pytest.fixture(scope="module")
def bundles():
    gen = jfp.tiny_bundle(jax.random.PRNGKey(0))
    fill = jfp.tiny_bundle(jax.random.PRNGKey(0), fill=True)
    s = gen.siglip_cfg.image_size
    uniq = np.random.default_rng(3).uniform(-1, 1, (4, s, s, 3)).astype(
        np.float32)
    prior = jfp.redux_prior_pairs_indexed(
        gen, uniq, np.asarray([[0, 3], [1, 3], [2, 3]]), "", [0.8, 1.0],
        [1.0, 1.0])
    fprior = jfp.redux_prior_pairs(
        fill, np.random.default_rng(4).standard_normal(
            (2, 1, s, s, 3)).astype(np.float32), "bg", [1.0], [1.0])
    return gen, fill, prior, fprior


@pytest.fixture(scope="module")
def group(tmp_path_factory, bundles):
    """The ``serve`` suite run once in four gloo processes."""
    gen, fill, prior, fprior = bundles
    work = str(tmp_path_factory.mktemp("scaleout_serve"))
    drv.dump(work, "gen.pkl", _trees(gen))
    drv.dump(work, "fill.pkl", _trees(fill))
    q = _trees(gen)
    q["flux_params"] = jax.tree.map(np.asarray, jquant.quantize_tree(
        gen.flux_params, min_size=1024))
    drv.dump(work, "gen_q.pkl", q)
    drv.dump(work, "gen_prior.pkl", tuple(np.asarray(x) for x in prior))
    drv.dump(work, "fill_prior.pkl", tuple(np.asarray(x) for x in fprior))
    s = gen.siglip_cfg.image_size
    drv.dump(work, "tp_images.pkl", np.random.default_rng(0)
             .standard_normal((2, s, s, 3)).astype(np.float32))
    drv.dump(work, "tp_noise.pkl", _noise(gen, [0, 0]))
    drv.dump(work, "q_noise.pkl", _noise(gen, [0, 1, 2]))
    assert _noise(gen, [0]).shape == _noise(fill, [0]).shape
    drv.dump(work, "jax_noise.pkl", dict(enumerate(_noise(gen, range(3)))))
    for case, n, ranks in (("pairs", 3, 2), ("odd", 5, 1)):
        root = os.path.join(work, case)
        os.makedirs(root)
        drv.dump(work, f"items_{case}.pkl", _items(root, n, ranks))
    drv.launch(work, 4, "serve")
    return work


def _gap(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return np.abs(a.astype(int) - b.astype(int))


def _near_jax(port, want):
    """The TP test's bar: within 1 level, on under 5% of the pixels."""
    diff = _gap(np.asarray(port), np.asarray(want))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.05


def _pipe_mesh():
    return JMesh(np.array(jax.devices()[:4]), ("pipe",))


@pytest.mark.parametrize("cache", ["dense", "vcache"])
def test_dp_generate_matches_jax(group, bundles, cache):
    """From the JAX noise, the port's DP generate (3 rows over 4 ranks)
    gives the JAX package's DP generate on its 8-device data axis."""
    gen, _, (e, p), _ = bundles
    got = drv.result(group, "dp")
    kw = (dict(num_steps=2) if cache == "dense"
          else dict(num_steps=4, velocity_cache_interval=2))
    want = jfp.generate(gen, e, p, height=drv.SIZE, width=drv.SIZE,
                        seed=[0, 1, 2], mesh=jmesh.create_mesh(), **kw)
    _near_jax(got["dp_jax" if cache == "dense" else "vcache_jax"], want)


def test_dp_generate_matches_one_process(group):
    """An odd batch (3 rows over 4 ranks, padded with row 0) gives the
    one-process batch's images and each row's alone."""
    got = drv.result(group, "dp")
    assert got["dp"].shape == (3, drv.SIZE, drv.SIZE, 3)
    np.testing.assert_array_equal(got["dp"], got["one"])
    np.testing.assert_array_equal(got["dp"], got["rows"])


@pytest.mark.parametrize("case", ["pairs", "odd"])
def test_generate_samples_dp_matches_sequential(group, case):
    got = drv.result(group, "dp_stage")[case]
    n = 3 if case == "pairs" else 5
    assert sorted(got["dp"]) == [f"s{i}" for i in range(n)]
    for sid, imgs in got["dp"].items():
        assert len(imgs) == len(got["seq"][sid])
        for a, b in zip(imgs, got["seq"][sid]):
            assert a.shape == (drv.SIZE, drv.SIZE, 3)
            np.testing.assert_array_equal(a, b)
        assert all(os.path.exists(p) for p in got["paths"][sid])


@pytest.mark.parametrize("case", ["pairs", "odd"])
def test_generate_samples_dp_matches_jax(group, bundles, tmp_path, case):
    """The port's stage-level DP batch, with the JAX noise in place of its
    own draw, writes the JAX package's ``generate_samples_dp`` images."""
    got = drv.result(group, "dp_stage")[case]["dp_jax"]
    stage = jgen.GenerateStage(bundles[0], jconfig.GenerateConfig(
        sampling=jconfig.FluxSamplingConfig(num_steps=2, height=drv.SIZE,
                                            width=drv.SIZE, seed=0),
        top_ranks=2))
    items = [dict(it, sample_dir=str(tmp_path / it["sample_id"]))
             for it in drv.load(group, f"items_{case}.pkl")]
    paths = jgen.generate_samples_dp(stage, items, jmesh.create_mesh())
    assert sorted(paths) == sorted(got)
    for sid, files in paths.items():
        assert len(files) == len(got[sid])
        for path, port in zip(files, got[sid]):
            _near_jax(port, np.asarray(Image.open(path)))


@pytest.mark.parametrize("case", ["generate", "vcache", "fill"])
def test_pp_serve_matches_jax(group, bundles, case):
    """From the JAX noise, the port's depth over 4 pipe ranks gives the
    JAX package's pipelined ``generate`` (dense and velocity-cached) and
    ``fill_batch`` over its 4-device pipe axis, at each side's default
    microbatches."""
    gen, fill, (e, p), fprior = bundles
    got = drv.result(group, "pp_serve")
    pipe = dict(mesh=_pipe_mesh(), pipe_axis="pipe")
    kw = dict(height=drv.SIZE, width=drv.SIZE, seed=[0, 1, 2], **pipe)
    if case == "fill":
        want = jfp.fill_batch(fill, *drv.fill_inputs(2), *fprior,
                              num_steps=4, seeds=[0, 1], guidance=30.0,
                              strength=0.6, **pipe)
    elif case == "vcache":
        want = jfp.generate(gen, e, p, num_steps=4,
                            velocity_cache_interval=2, **kw)
    else:
        want = jfp.generate(gen, e, p, num_steps=2, **kw)
    _near_jax(got[{"generate": "gen_jax", "vcache": "vcache_jax",
                   "fill": "fill_jax"}[case]], want)


def test_pp_generate_and_fill_match_one_process(group):
    got = drv.result(group, "pp_serve")
    assert _gap(got["gen"], got["gen_one"]).max() <= 1
    np.testing.assert_array_equal(got["gen_micro"], got["gen_one"])
    assert _gap(got["fill"], got["fill_one"]).max() <= 1


def test_sp_hires_fill_matches_one_process(group):
    """The hires fill over the data axis rings its attention (the whole
    batch, the joint sequence split four ways) and gives the one-process
    images within one level."""
    got = drv.result(group, "sp")
    assert got["ring_calls"] > 0 and got["ring_shape"][0] == 2
    assert _gap(got["sp"], got["one"]).max() <= 1


def test_sp_hires_fill_matches_jax(group, bundles):
    """From the JAX noise, the port's ring over 4 ranks gives the JAX
    package's hires fill with its ring over the 8-device data axis (the
    VAE in one tile: ``torch_scaleout_driver.SP_JAX_KW``)."""
    _, fill, _, fprior = bundles
    got = drv.result(group, "sp")["sp_jax"]
    want = jfp.fill_batch(fill, *drv.fill_inputs(2), *fprior,
                          mesh=jmesh.create_mesh(), **drv.SP_JAX_KW)
    _near_jax(got, want)


def test_shard_bundle_generate_matches_jax(group, bundles):
    gen = bundles[0]
    got = drv.result(group, "tp")
    mesh = jmesh.create_mesh(model_parallel=2)
    sharded = jdeploy.shard_bundle(gen, mesh)
    s = gen.siglip_cfg.image_size
    imgs = np.random.default_rng(0).standard_normal(
        (2, s, s, 3)).astype(np.float32)
    e, p = jfp.redux_prior(sharded, imgs, ["", ""], [0.8, 1.0], [1.0, 1.0])
    for a, b in zip(got["prior"], (e, p)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    want = jfp.generate(sharded, e, p, height=drv.SIZE, width=drv.SIZE,
                        num_steps=2, guidance=2.5, seed=0)
    for port in (got["tp"], got["one"]):
        diff = _gap(port, want)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.05
    assert got["local_width"] == 3 * gen.flux_cfg.hidden // 2
    assert got["tp_mesh"]


def test_tp_w8a8_generate_matches_jax(group, bundles):
    """The JAX-quantized tree on a (2, 2) mesh under W8A8: the port's
    row-sharded layers quantize with the whole row's amax and sum f32
    partials; JAX's GSPMD does its own reductions."""
    gen, _, prior, _ = bundles
    got = drv.result(group, "tp")["w8a8"]
    mesh = jmesh.create_mesh(model_parallel=2)
    jq = jdeploy.shard_bundle(dataclasses.replace(
        gen, flux_params=jquant.quantize_tree(gen.flux_params,
                                              min_size=1024)), mesh)
    jcommon.set_int8_activations(True)
    try:
        want = jfp.generate(jq, *prior, height=drv.SIZE, width=drv.SIZE,
                            num_steps=3, seed=[0, 1, 2], mesh=mesh)
    finally:
        jcommon.set_int8_activations(False)
    _uint8_close(got, want)


@pytest.mark.parametrize("mode", ["dp", "tp", "pp"])
def test_velocity_cache_under_serving_modes(group, mode):
    """The velocity cache wraps the model call, so it runs under every
    serving mode. Where a rank's work is the one-process work, the images
    are the same: DP's ranks (one row each) give each row's run alone, and
    PP at one microbatch the one-process batch. Where the GEMMs run at
    another row count (DP against the 3-row batch, PP's one-row
    microbatches) or sum over ranks (TP's row-sharded layers), the CPU's
    summation order may move the last bit: within one level."""
    got = drv.result(group, {"dp": "dp", "tp": "tp", "pp": "pp_serve"}[mode])
    assert _gap(got["vcache"], got["vcache_one"]).max() <= 1
    if mode == "dp":
        np.testing.assert_array_equal(got["vcache"], got["vcache_rows"])
    if mode == "pp":
        np.testing.assert_array_equal(got["vcache"], got["vcache_one"])
        assert _gap(got["vcache_micro"], got["vcache_one"]).max() <= 1
    assert got["vcache"].shape[-3:] == (drv.SIZE, drv.SIZE, 3)


def _jax_error(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("case", ["pipe_without_axis", "pipe_with_tp",
                                  "block_cache_under_pp",
                                  "fill_pipe_without_axis"])
def test_scale_out_errors_match_jax(group, bundles, case):
    gen, fill, prior, fprior = bundles
    got = drv.result(group, "errors")[case]
    e, p = prior
    mesh = jmesh.create_mesh(model_parallel=2)
    pipe = JMesh(np.array(jax.devices()[:4]), ("pipe",))
    kw = dict(height=drv.SIZE, width=drv.SIZE, num_steps=2, seed=[0, 1, 2])
    calls = {
        "pipe_without_axis": lambda: jfp.generate(
            gen, e, p, mesh=mesh, pipe_axis="pipe", **kw),
        "pipe_with_tp": lambda: jfp.generate(
            jdeploy.shard_bundle(gen, mesh), e, p, mesh=pipe,
            pipe_axis="pipe", **kw),
        "block_cache_under_pp": lambda: jfp.generate(
            gen, e, p, mesh=pipe, pipe_axis="pipe", block_cache_interval=2,
            **kw),
        "fill_pipe_without_axis": lambda: jfp.fill_batch(
            fill, *drv.fill_inputs(2), *fprior, num_steps=2, seeds=[0, 1],
            mesh=mesh, pipe_axis="pipe"),
    }
    assert got == _jax_error(calls[case])


def test_pp_stages_rebuilt_after_quantize(group):
    """Quantizing the params after a pipelined serve builds the stages
    anew (from the int8 tree), so the pipelined fill matches the
    one-process fill of the quantized bundle."""
    got = drv.result(group, "errors")
    assert got["stages_rebuilt"]
    assert _gap(got["quantized_pp"], got["quantized_one"]).max() <= 1
