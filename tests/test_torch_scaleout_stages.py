"""The port's CLI, orchestrator and stage 3 over a mesh of two processes,
against the one-process run (which ``tests/test_torch_cli.py`` holds to
the JAX CLI's file list).

The port side runs in one gloo group of two spawned processes
(``torch_scaleout_driver``, suite ``stages``), started once for this
file. ``pipeline --tiny-models`` runs with ``--model_parallel 2``, with
``--pipeline_parallel 2`` and with neither (a data axis of 2: the sharded
bank, DP generate and compose); each writes the one-process run's file
tree, once (rank 0 writes; the tree has no second copy of anything). The
retrieval results are the one-process run's (indices exact, scores within
1e-6), and stage 3's images are byte-equal where a rank's work is the
one-process work (``--model_parallel 2`` without a tensor-parallel
bundle) and within one level elsewhere (another GEMM row count moves a
CPU GEMM's last bit). Stage 3's ``process_dataset`` over the mesh writes
the one-process sweep's tree. The scale-out flags without a group follow
the JAX CLI.
"""

import json
import os
import types

import numpy as np
import pytest
import torch
from PIL import Image

import torch_scaleout_driver as drv
from domainrag_tpu.pipeline import orchestrator as jorch
from domainrag_tpu_torch.cli import main as cli
from domainrag_tpu_torch.core.config import (FluxSamplingConfig,
                                             GenerateConfig)
from domainrag_tpu_torch.models.flux import pipeline as tfp
from domainrag_tpu_torch.pipeline import orchestrator as torch_orch
from domainrag_tpu_torch.stages import generate as gen_stage
from test_torch_cli import _STAMP, DS, _files, _toy_env

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The one-process CLI run here, then the ``stages`` suite in two gloo
    processes."""
    root = tmp_path_factory.mktemp("scaleout_stages")
    datasets, corpus = _toy_env(root)
    argv = ["pipeline", "--tiny-models", "--datasets", DS, "--shots", "1",
            "--datasets_dir", datasets, "--corpus", f"coco={corpus}",
            "--steps", "2", "--size", "32", "--custom_upscale", f"{DS}:32",
            "--max_dimension", "64", "--process_id", "t", "--device", "cpu"]
    work = str(root)
    assert cli.main(argv + ["--output_dir", os.path.join(work, "one")]) == 0
    stage = gen_stage.GenerateStage(
        tfp.tiny_bundle(device="cpu"),
        GenerateConfig(sampling=FluxSamplingConfig(num_steps=2, height=32,
                                                   width=32, seed=0)))
    with open(os.path.join(work, "one", "retrieval_results",
                           "all_shots_retrieval_results.json")) as f:
        results = json.load(f)
    gen_stage.process_dataset(stage, DS, 1, results,
                              os.path.join(work, "one", "lamainpaint"),
                              os.path.join(work, "stage3_one"),
                              run_name="run")
    drv.dump(work, "argv.pkl", argv)
    drv.launch(work, 2, "stages")
    return work


def _images(root, pattern):
    """The PNGs under ``root`` whose names hold ``pattern``, keyed as
    ``_files`` keys them (run time stamps masked)."""
    return {_STAMP.sub("_<ts>", os.path.relpath(os.path.join(d, f), root)):
            np.asarray(Image.open(os.path.join(d, f)))
            for d, _, fs in os.walk(root) for f in fs if pattern in f}


def _close(got, want, roots):
    """The same JSON, its floats within rtol 1e-6 and its paths under the
    run's own output dir (``roots``: got's, want's)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], roots)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, roots)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    elif isinstance(want, str):
        assert got.replace(*roots) == want
    else:
        assert got == want


def _retrieval(root):
    with open(os.path.join(root, "retrieval_results",
                           "all_shots_retrieval_results.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["mp2", "pp2", "dp2"])
def test_cli_over_a_mesh_writes_the_one_process_tree(group, name):
    drv.result(group, "cli")
    one, got = os.path.join(group, "one"), os.path.join(group, name)
    assert _files(got) == _files(one)
    _close(_retrieval(got), _retrieval(one), (got, one))
    want_i = _images(one, "generated_image_rank")
    got_i = _images(got, "generated_image_rank")
    assert sorted(got_i) == sorted(want_i) and len(got_i) == 10
    for k, v in got_i.items():
        if name == "mp2":
            np.testing.assert_array_equal(v, want_i[k])
        else:
            assert np.abs(v.astype(int) - want_i[k].astype(int)).max() <= 1


def test_process_dataset_over_a_mesh_writes_the_tree_once(group):
    counters = drv.result(group, "stage3")
    assert counters["processed"] == 2 and counters["failed"] == 0
    one = os.path.join(group, "stage3_one")
    got = os.path.join(group, "stage3")
    assert _files(got) == _files(one)
    want_i, got_i = (_images(r, "generated_image_rank") for r in (one, got))
    assert sorted(got_i) == sorted(want_i) and len(got_i) == 10
    for k, v in got_i.items():
        assert np.abs(v.astype(int) - want_i[k].astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# the scale-out flags in one process
# ---------------------------------------------------------------------------

def _runner(pp, workers=1):
    mesh = types.SimpleNamespace(pipeline_parallel_size=pp,
                                 model_parallel_size=1, pipe_axis="pipe")
    return types.SimpleNamespace(cfg=types.SimpleNamespace(
        mesh=mesh, num_workers=workers))


def test_pipe_mesh_needs_a_device_per_stage_as_jax():
    """More pipeline stages than devices: JAX's error, with the port's
    device count (one process, one card)."""
    import jax
    n = len(jax.devices())
    with pytest.raises(ValueError) as want:
        jorch.PipelineRunner._pipe_mesh(_runner(2 * n))
    with pytest.raises(ValueError) as got:
        torch_orch.PipelineRunner._pipe_mesh(
            types.SimpleNamespace(**_runner(2 * n).__dict__,
                                  _group=lambda: False, _span=lambda: 1))
    assert str(got.value) == str(want.value).replace(f"found {n}",
                                                     "found 1")
