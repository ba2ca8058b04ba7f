"""``--distributed`` workers of several processes each: the port's CLI on
four processes as two workers (hosts) of two (``LOCAL_WORLD_SIZE=2``),
through stages 2 and 3 on the toy dataset of
``tests/test_torch_scaleout_stages.py`` (two samples: one per worker).

The port side runs in one gloo group of four spawned processes
(``torch_scaleout_driver``, suite ``workers``); stage 1 and the
one-process runs of each worker's slice alone (``--worker_id W
--num_workers 2``) run here. Each worker's mesh is a data axis of 2, then
a model axis of 2 (``--model_parallel 2``, whose TP bundle sums its
partial products in another order). Held:
- each worker's files equal those of its slice run alone: its retrieval
  partial byte-equal (the output dir's name aside), its manifest's
  samples, statuses and outputs, and its rank PNGs within one uint8
  level (a GEMM over fewer rows, or a TP share, may move a CPU GEMM's
  last bit);
- the merged artefacts (worker 0's merge of the retrieval partials and
  of the manifests) equal the JAX package's ``multihost`` merges of the
  same partials;
- every process learns its worker as ``rank // 2`` of ``world // 2``.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import torch_scaleout_driver as drv
from domainrag_tpu.parallel import multihost as jmh
from domainrag_tpu_torch.cli import main as cli
from test_torch_cli import _STAMP, DS, _toy_env

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

RUNS = ("workers", "workers_mp2")


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Stage 1 and each worker's slice alone here, then the ``workers``
    suite in four gloo processes."""
    root = tmp_path_factory.mktemp("scaleout_workers")
    datasets, corpus = _toy_env(root)
    work = str(root)
    argv = ["pipeline", "--tiny-models", "--datasets", DS, "--shots", "1",
            "--datasets_dir", datasets, "--corpus", f"coco={corpus}",
            "--steps", "2", "--size", "32", "--custom_upscale", f"{DS}:32",
            "--max_dimension", "64", "--process_id", "t", "--device", "cpu"]
    base = os.path.join(work, "stage1")
    assert cli.main(argv + ["--stages", "inpaint", "--output_dir",
                            base]) == 0
    # each worker's slice alone: both retrieval partials first (worker 0
    # merges them), then each worker's stage 3 on a copy of that tree
    alone = os.path.join(work, "alone")
    shutil.copytree(base, alone)
    slice_of = lambda w: ["--worker_id", str(w), "--num_workers", "2"]
    for w in (1, 0):
        assert cli.main(argv + slice_of(w) + [
            "--stages", "retrieve", "--output_dir", alone]) == 0
    for w in (0, 1):
        out = os.path.join(work, f"alone{w}")
        shutil.copytree(alone, out)
        assert cli.main(argv + slice_of(w) + [
            "--stages", "generate", "--output_dir", out]) == 0
    for name in RUNS:
        shutil.copytree(base, os.path.join(work, name))
    drv.dump(work, "argv.pkl", argv)
    drv.launch(work, 4, "workers")
    return work


def _retrieval_dir(root):
    return os.path.join(root, "retrieval_results")


def _run_dir(root):
    (run,) = glob.glob(os.path.join(root, "result", f"{DS}_1shot_retrieval",
                                    "results_*"))
    return run


def _text(path, root):
    with open(path, encoding="utf-8") as f:
        return f.read().replace(root, "<out>")


def _samples(manifest_path, root):
    """A manifest's samples: status and outputs (the clock's fields and
    the output dir's name aside)."""
    with open(manifest_path, encoding="utf-8") as f:
        samples = json.load(f)["samples"]
    return {k: (v["status"], _STAMP.sub("_<ts>", json.dumps(
        v.get("outputs"), sort_keys=True).replace(root, "<out>")))
        for k, v in samples.items()}


def _pngs(run):
    return {os.path.relpath(p, run): np.asarray(Image.open(p)).astype(int)
            for p in glob.glob(os.path.join(run, "*", "*.png"))}


def test_workers_learn_their_host(group):
    drv.result(group, "workers")
    seen = [drv.load(group, f"workers.r{r}.pkl") for r in range(4)]
    assert seen == [(r // 2, 2, 2) for r in range(4)]


@pytest.mark.parametrize("name", RUNS)
@pytest.mark.parametrize("w", [0, 1])
def test_worker_files_equal_its_slice_alone(group, name, w):
    drv.result(group, "workers")
    got, want = os.path.join(group, name), os.path.join(group, f"alone{w}")
    part = f"all_shots_retrieval_results.worker{w}.json"
    alone = os.path.join(group, "alone")         # where stage 2 ran alone
    assert _text(os.path.join(_retrieval_dir(got), part), got) == _text(
        os.path.join(_retrieval_dir(alone), part), alone)
    got_run, want_run = _run_dir(got), _run_dir(want)
    man = f"manifest.worker{w}.json"
    mine = _samples(os.path.join(want_run, man), want)
    assert len(mine) == 1 and all(s == "done" for s, _ in mine.values())
    assert _samples(os.path.join(got_run, man), got) == mine
    want_png = {k: v for k, v in _pngs(want_run).items()
                if k.split(os.sep)[0] in mine}
    got_png = {k: v for k, v in _pngs(got_run).items()
               if k.split(os.sep)[0] in mine}
    assert sorted(got_png) == sorted(want_png) and len(want_png) >= 5
    for k, v in want_png.items():
        assert np.abs(got_png[k] - v).max() <= 1, k


@pytest.mark.parametrize("name", RUNS)
def test_merged_artefacts_equal_jax_merges(group, name, tmp_path):
    drv.result(group, "workers")
    got = os.path.join(group, name)
    parts = tmp_path / "retrieval"
    parts.mkdir()
    for p in glob.glob(os.path.join(_retrieval_dir(got),
                                    "*.worker*.json")):
        shutil.copy(p, parts)
    jmh.merge_worker_retrieval_results(str(parts))
    merged = "all_shots_retrieval_results.json"
    assert _text(os.path.join(_retrieval_dir(got), merged), got) == _text(
        str(parts / merged), got)
    run = _run_dir(got)
    partials = sorted(glob.glob(os.path.join(run, "manifest.worker*.json")))
    assert len(partials) == 2
    jmh.merge_worker_manifests(partials, str(tmp_path / "manifest.json"))
    with open(os.path.join(run, "manifest.json")) as f, \
            open(tmp_path / "manifest.json") as g:
        assert json.load(f) == json.load(g)
    assert len(_samples(os.path.join(run, "manifest.json"), got)) == 2
