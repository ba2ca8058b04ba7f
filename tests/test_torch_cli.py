"""The port's CLI (``domainrag_tpu_torch.cli.main``) against the JAX
package's, on the CPU.

Limits, each with its reason:
- argument handling: the cases of ``tests/test_cli.py``, as there, and
  ``_build_cfg`` equal to JAX's for the same argv (``asdict``), with the
  same ``SystemExit`` text, in the same order;
- ``export`` and ``compose --collect_only``: the same printed JSON on the
  same tree (no model runs: the same host code);
- ``pipeline --tiny-models --device cpu``: the same file list as the JAX
  CLI's ``--tiny-models`` run on the same toy dataset (the run
  directory's time stamp and the similarity in the ref-info file names
  aside); the weights are each package's own
  random draw, so the images are not compared here
  (``tests/test_torch_orchestrator.py`` compares them on bridged
  weights);
- scale-out flags in one process reach the runner's config as the JAX
  CLI's do (``--distributed`` without a group: worker 0 of 1); the cache
  values reach ``generate`` and the sample is processed.
"""

import argparse
import json
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from domainrag_tpu.cli import main as jcli
from domainrag_tpu.core.coco import write_coco
from domainrag_tpu.core.config import asdict as jasdict
from domainrag_tpu_torch.cli import main as cli
from domainrag_tpu_torch.core.config import asdict

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

DS = "NEU-DET"


def parse(argv, mod=cli):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("inpaint", "retrieve", "generate", "compose", "pipeline",
                 "export"):
        p = sub.add_parser(name)
        mod._add_common(p)
        if name == "pipeline":
            p.add_argument("--stages",
                           default="inpaint,retrieve,generate,compose")
    return parser.parse_args(argv)


# ---------------------------------------------------------------------------
# tests/test_cli.py's cases
# ---------------------------------------------------------------------------

def test_dataset_and_shot_aliases():
    args = parse(["compose", "--dataset", "UODD", "--shot", "5"])
    assert args.datasets == ["UODD"] and args.shots == [5]
    args = parse(["inpaint", "--datasets", "A", "B", "--shots", "1", "10"])
    assert args.datasets == ["A", "B"] and args.shots == [1, 10]


def test_custom_upscale_and_compose_cfg():
    args = parse(["compose", "--dataset", "NEU-DET",
                  "--custom_upscale", "NEU-DET:512", "--max_dimension",
                  "1400", "--shots", "1"])
    cfg = cli._build_cfg(args)
    params = {k.lower(): v for k, v in
              cfg.compose.dataset_params.items()}
    assert params["neu-det"].upscale_dimension == 512
    assert cfg.compose.resolution.max_dimension == 1400
    # untouched dataset keeps its table value
    assert params["uodd"].upscale_dimension == 2048


def test_corpus_and_pretrained_specs(tmp_path):
    (tmp_path / "a.jpg").write_bytes(b"x")
    sources = cli._corpus_sources([f"coco={tmp_path}"])
    assert list(sources) == ["coco"] and len(sources["coco"]) == 1

    class A:
        corpus_features = ["coco=f.npy:p.json"]
    specs = cli._pretrained_specs(A())
    assert specs == {"coco": ("f.npy", "p.json")}


def test_worker_flags_reach_config():
    args = parse(["generate", "--worker_id", "2", "--num_workers", "4",
                  "--shots", "1"])
    cfg = cli._build_cfg(args)
    assert cfg.worker_id == 2 and cfg.num_workers == 4


def test_w8a8_implies_int8_and_serving_mode(tmp_path):
    """--w8a8 quantizes the Flux weights AND flips the process-wide
    int8-activation serving mode (common.set_int8_activations)."""
    from domainrag_tpu_torch.models import common

    args = parse(["generate", "--tiny-models", "--shots", "1",
                  "--device", "cpu",
                  "--datasets_dir", str(tmp_path / "d"),
                  "--output_dir", str(tmp_path / "o")])
    args.w8a8 = True
    args.int8 = False
    args.force_recompute = False
    args.corpus_features = []
    quantized = []
    orig = cli._quantize_runner
    cli._quantize_runner = lambda r: quantized.append(r)
    try:
        runner = cli._build_runner(args)
        assert common._INT8_ACTIVATIONS is True
        assert quantized == [runner]
    finally:
        cli._quantize_runner = orig
        common.set_int8_activations(False)


# ---------------------------------------------------------------------------
# the configuration against JAX's
# ---------------------------------------------------------------------------

ARGVS = [
    ["pipeline"],
    ["generate", "--datasets", "UODD", "DIOR", "--shots", "1", "5",
     "--steps", "20", "--size", "512", "--seed", "3", "--max_rank_batch",
     "1", "--process_id", "7", "--worker_id", "1", "--num_workers", "2"],
    ["compose", "--dataset", "FISH", "--custom_upscale", "FISH:1536",
     "NEU-DET:512", "--max_dimension", "2048", "--model_parallel", "2"],
    ["pipeline", "--velocity_cache_interval", "sched:4",
     "--velocity_cache_order", "0", "--pipeline_parallel", "2"],
    ["generate", "--velocity_cache_interval", "0,2,5", "--datasets",
     "Camouflage", "--auto_shots"],
    ["generate", "--block_cache_interval", "auto"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a)[:40])
def test_build_cfg_matches_jax(argv):
    want = jcli._build_cfg(parse(argv, jcli))
    got = cli._build_cfg(parse(argv + ["--device", "cpu"]))
    assert asdict(got) == jasdict(want)


EXITS = [
    ["--pipeline_parallel", "2", "--block_cache_interval", "2"],
    ["--pipeline_parallel", "2", "--block_cache_interval", "auto"],
    ["--block_cache_interval", "2", "--velocity_cache_interval", "3"],
    ["--block_cache_interval", "auto", "--velocity_cache_interval", "auto"],
    ["--block_cache_interval", "2", "--velocity_cache_interval", "1,4"],
    ["--pipeline_parallel", "2", "--model_parallel", "2"],
    # the first check wins where two apply, as in JAX
    ["--pipeline_parallel", "2", "--model_parallel", "2",
     "--block_cache_interval", "2"],
]


@pytest.mark.parametrize("flags", EXITS, ids=lambda a: " ".join(a))
def test_build_cfg_exits_as_jax(flags):
    argv = ["pipeline"] + flags
    with pytest.raises(SystemExit) as want:
        jcli._build_cfg(parse(argv, jcli))
    with pytest.raises(SystemExit) as got:
        cli._build_cfg(parse(argv))
    assert str(got.value) == str(want.value)


def test_no_weights_exits_as_jax(tmp_path):
    argv = ["generate", "--output_dir", str(tmp_path)]
    with pytest.raises(SystemExit) as want:
        jcli._build_runner(parse(argv, jcli))
    with pytest.raises(SystemExit) as got:
        cli._build_runner(parse(argv))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the caches, A6 and the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--distributed"],
                                   ["--model_parallel", "2"],
                                   ["--pipeline_parallel", "4"]])
def test_scale_out_flags_raise(tmp_path, flags, monkeypatch):
    """In one process the scale-out flags build the runner with the JAX
    CLI's config: ``--distributed`` without a group is worker 0 of 1 (the
    JAX ``initialize_distributed`` falls back to one process), and the
    parallel degrees reach ``cfg.mesh`` (the mesh itself is built per
    stage, over the processes launched together)."""
    built = []

    class Built(Exception):
        pass

    def stub(cfg, *a, **k):
        built.append(cfg)
        raise Built

    monkeypatch.setattr("domainrag_tpu_torch.pipeline.orchestrator."
                        "build_tiny_runner", stub)
    argv = ["pipeline", "--tiny-models", "--output_dir", str(tmp_path)] + \
        flags
    with pytest.raises(Built):
        cli.main(argv + ["--device", "cpu"])
    args = parse(argv, jcli)
    if args.distributed:
        args.worker_id, args.num_workers = 0, 1
    assert asdict(built[0]) == jasdict(jcli._build_cfg(args))


def test_device_defaults_to_the_card(tmp_path, monkeypatch):
    assert parse(["pipeline"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["inpaint", "--tiny-models", "--output_dir",
                  str(tmp_path)])


@pytest.mark.parametrize("flags", [["--velocity_cache_interval", "2"],
                                   ["--block_cache_interval", "3"],
                                   ["--velocity_cache_order", "0"]])
def test_cache_values_reach_the_denoise(tmp_path, flags, capsys,
                                        monkeypatch):
    """The cache flags reach ``generate`` with the flag's value (a spy on
    the stage's call), and the sample is processed."""
    from domainrag_tpu_torch.models.flux import pipeline as tfp
    from domainrag_tpu_torch.stages import generate as tgen
    seen = []
    real = tfp.generate

    def spy(*a, **kw):
        seen.append({k: kw[k] for k in ("block_cache_interval",
                                        "velocity_cache_interval",
                                        "velocity_cache_order")})
        return real(*a, **kw)

    # generate counts non-finite images on the module's ``generate``
    spy.nonfinite_images = 0
    monkeypatch.setattr(tgen.flux_pipeline, "generate", spy)
    shot = tmp_path / "o" / "lamainpaint" / DS / "1_shot"
    shot.mkdir(parents=True)
    Image.fromarray(np.zeros((24, 24, 3), np.uint8)).save(
        shot / "crazing_1.jpg")
    corpus = tmp_path / "c"
    corpus.mkdir()
    Image.fromarray(np.full((20, 20, 3), 9, np.uint8)).save(corpus / "a.jpg")
    assert cli.main(["generate", "--tiny-models", "--device", "cpu",
                     "--datasets", DS, "--shots", "1", "--output_dir",
                     str(tmp_path / "o"), "--corpus", f"coco={corpus}",
                     "--size", "32", "--steps", "2"] + flags) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary == {f"{DS}/1": {"processed": 1, "failed": 0,
                                   "skipped": 0, "fallback": 1}}
    want = {"block_cache_interval": 1, "velocity_cache_interval": 1,
            "velocity_cache_order": 1}
    want[flags[0].lstrip("-")] = int(flags[1])
    assert seen and all(call == want for call in seen)
    assert not [f for _, _, fs in os.walk(tmp_path / "o") for f in fs
                if f == "generation_failed.txt"]


# ---------------------------------------------------------------------------
# subcommands against JAX's CLI
# ---------------------------------------------------------------------------

def _toy_env(root):
    rng = np.random.default_rng(5)
    ds = root / "datasets" / DS
    (ds / "train").mkdir(parents=True)
    write_coco(str(ds / "annotations" / "1_shot.json"),
               images=[{"id": 1, "file_name": "crazing_1.jpg",
                        "width": 40, "height": 36},
                       {"id": 2, "file_name": "patches_2.jpg",
                        "width": 48, "height": 40}],
               annotations=[
                   {"id": 1, "image_id": 1, "category_id": 1,
                    "bbox": [4, 4, 12, 10]},
                   {"id": 2, "image_id": 2, "category_id": 2,
                    "bbox": [8, 8, 16, 12]},
                   {"id": 3, "image_id": 2, "category_id": 2,
                    "bbox": [30, 20, 10, 10]}],
               categories=[{"id": 1, "name": "crazing"},
                           {"id": 2, "name": "patches"}])
    for name, (w, h) in [("crazing_1", (40, 36)), ("patches_2", (48, 40))]:
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(ds / "train" / f"{name}.jpg")
    corpus = root / "coco"
    corpus.mkdir()
    for i in range(8):
        Image.fromarray(rng.integers(0, 255, (36, 44, 3), dtype=np.uint8)
                        ).save(corpus / f"{i:06d}.jpg")
    return str(root / "datasets"), str(corpus)


_STAMP = re.compile(r"_\d{8}_\d{6}")
_SIM = re.compile(r"_sim\d\.\d+")


def _files(root):
    """The files under ``root``: run time stamps and the similarities in
    the ref-info names (each package's own random weights) masked."""
    return sorted(_SIM.sub("_sim<s>", _STAMP.sub(
        "_<ts>", os.path.relpath(os.path.join(d, f), root)))
        for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The same ``pipeline --tiny-models`` argv through both CLIs."""
    root = tmp_path_factory.mktemp("cli")
    datasets, corpus = _toy_env(root)
    argv = ["pipeline", "--tiny-models", "--datasets", DS, "--shots", "1",
            "--datasets_dir", datasets, "--corpus", f"coco={corpus}",
            "--steps", "2", "--size", "32", "--custom_upscale",
            f"{DS}:32", "--max_dimension", "64", "--process_id", "t"]
    outs = {}
    for name, mod, extra in (("jax", jcli, []),
                             ("port", cli, ["--device", "cpu"])):
        out = str(root / name)
        assert mod.main(argv + ["--output_dir", out] + extra) == 0
        outs[name] = out
    return datasets, outs


def test_pipeline_tiny_models_writes_the_jax_files(cli_runs):
    _, outs = cli_runs
    files = _files(outs["port"])
    assert files == _files(outs["jax"])
    assert sum(f.endswith("_final_result_rank5.png") for f in files) == 4
    assert sum("generated_image_rank" in f for f in files) == 10


def test_export_and_collect_print_as_jax(cli_runs, capsys):
    datasets, outs = cli_runs
    for argv in (["export", "--datasets", DS, "--shots", "1"],
                 ["compose", "--collect_only", "--shots", "1"]):
        printed = []
        for mod in (jcli, cli):
            assert mod.main(argv + ["--datasets_dir", datasets,
                                    "--output_dir", outs["port"],
                                    "--process_id", "t"]) == 0
            printed.append(capsys.readouterr().out)
        assert printed[0] == printed[1]
        assert json.loads(printed[1])
    got = json.loads(printed[1])
    assert list(got) == ["1_shot"]
