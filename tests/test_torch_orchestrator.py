"""The port's orchestrator (``domainrag_tpu_torch.pipeline``), its
multi-worker merges and the prompt cache against the JAX package's, on
the CPU.

Limits, each with its reason:
- the runner's DAG handling (stage subsets, unknown stages, forwarded
  flags): the cases of ``tests/test_orchestrator_extra.py``, as there;
- all four stages through ``PipelineRunner.run``, the port's runner on the
  bridged weights of the JAX ``build_tiny_runner`` and the JAX noise:
  the same file tree (the run directory's time stamp aside), manifests,
  masks and copies equal, texts equal but for decimals within 1e-5; the retrieval JSONs equal in keys,
  order, paths and ranks, similarities and cached features within 1e-5
  (the stage-2 bar of
  ``tests/test_torch_retrieve.py``: the same f32 sums in another order);
  every generated, inpainted and composited image within 1 uint8 level
  (a value on a rounding edge may land on either side). Each stage runs
  on the JAX stage's own outputs, so that a 1-level difference in one
  stage's image is not fed into the next stage's comparison;
- the worker merges: equal files (the same host code);
- the prompt cache: the port's own uncached embeddings bit for bit, and
  JAX's within 1e-5 absolute (the f32 text towers sum in another order:
  measured up to 1.5e-6 on outputs near 2; ``tests/test_torch_models.py``
  holds the T5 tower itself to 5e-5), and the same ``ValueError`` once
  the towers are released.
"""

import dataclasses
import json
import os
import random
import re
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from domainrag_tpu.core import config as jconfig
from domainrag_tpu.core.coco import write_coco as jwrite_coco
from domainrag_tpu.models.flux import pipeline as jfp
from domainrag_tpu.parallel import multihost as jmh
from domainrag_tpu.pipeline import orchestrator as jorch
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.core import config as tconfig
from domainrag_tpu_torch.models import clip as tclip
from domainrag_tpu_torch.models import lama as tlama
from domainrag_tpu_torch.models.flux import pipeline as tfp
from domainrag_tpu_torch.parallel import multihost as tmh
from domainrag_tpu_torch.pipeline import orchestrator as torch_orch
from domainrag_tpu_torch.pipeline import build_tiny_runner
from domainrag_tpu_torch.stages import encoders as tenc
from domainrag_tpu_torch.stages import inpaint as tinpaint
from test_torch_fill import port_bundle

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

DS = "NEU-DET"


def _cfg(tmp_path):
    return tconfig.PipelineConfig(datasets=("X",), shots=(1,),
                                  datasets_dir=str(tmp_path),
                                  output_dir=str(tmp_path / "out"))


# ---------------------------------------------------------------------------
# tests/test_orchestrator_extra.py's cases
# ---------------------------------------------------------------------------

def test_unknown_stage_rejected(tmp_path):
    runner = build_tiny_runner(_cfg(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="unknown stage"):
        runner.run(stages=("inpaint", "nope"))


def test_stage_subset_runs_only_requested(tmp_path):
    cfg = tconfig.PipelineConfig(datasets=("MISSING",), shots=(1,),
                                 datasets_dir=str(tmp_path),
                                 output_dir=str(tmp_path / "out"))
    out = build_tiny_runner(cfg, device="cpu").run(stages=("inpaint",))
    assert set(out) == {"inpaint", "timings"}
    # missing dataset dirs are skipped, not fatal (reference behavior)
    assert out["inpaint"] == {}


def test_run_forwards_failed_only_to_compose(tmp_path):
    runner = build_tiny_runner(_cfg(tmp_path), device="cpu")
    seen = {}

    def fake_compose(resume=False, failed_only=False):
        seen.update(resume=resume, failed_only=failed_only)
        return {"ok": True}

    runner.run_compose = fake_compose
    out = runner.run(stages=("compose",), resume=True, failed_only=True)
    assert seen == {"resume": True, "failed_only": True}
    assert out["compose"] == {"ok": True}


def test_run_forwards_reference_artifacts_to_generate(tmp_path):
    runner = build_tiny_runner(_cfg(tmp_path), device="cpu")
    seen = {}

    def fake_generate(resume=False, reference_artifacts=False):
        seen.update(resume=resume, reference_artifacts=reference_artifacts)
        return {"ok": True}

    runner.run_generate = fake_generate
    out = runner.run(stages=("generate",), reference_artifacts=True)
    assert seen == {"resume": False, "reference_artifacts": True}
    assert out["generate"] == {"ok": True}


# ---------------------------------------------------------------------------
# the port's own: one card per process
# ---------------------------------------------------------------------------

def test_tiny_runner_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_tiny_runner(_cfg(tmp_path))


@pytest.mark.parametrize("mesh", [dict(model_parallel_size=2),
                                  dict(pipeline_parallel_size=2)])
def test_parallel_degrees_raise(tmp_path, mesh):
    """One process is one device. A model-parallel degree shapes the mesh
    of the processes launched together, so alone the stages run as JAX's
    do on its devices (the same results, or the same error); a
    pipeline-parallel degree above the device count raises JAX's
    ``_pipe_mesh`` error (JAX's own devices number 8 here)."""
    cfg = tconfig.PipelineConfig(
        datasets=("X",), shots=(1,), datasets_dir=str(tmp_path),
        output_dir=str(tmp_path / "out"), mesh=tconfig.MeshConfig(**mesh))
    jcfg = jconfig.PipelineConfig(
        datasets=("X",), shots=(1,), datasets_dir=str(tmp_path),
        output_dir=str(tmp_path / "jout"), mesh=jconfig.MeshConfig(**mesh))
    runner = build_tiny_runner(cfg, device="cpu")
    jrunner = jorch.build_tiny_runner(jcfg)
    for stage in ("generate", "compose"):
        if "pipeline_parallel_size" in mesh:
            with pytest.raises(ValueError) as got:
                runner.run(stages=(stage,))
            assert str(got.value) == ("pipeline_parallel_size=2 needs 2 "
                                      "devices, found 1")
            continue
        outcome = []
        for r in (jrunner, runner):
            try:
                res = r.run(stages=(stage,))
                outcome.append(res[stage])
            except Exception as e:     # the same error on both sides
                outcome.append((type(e).__name__, str(e).replace(
                    str(tmp_path / "jout"), str(tmp_path / "out"))))
        assert outcome[1] == outcome[0]


def test_process_group_raises(monkeypatch):
    """Without a group: one process (index 0 of 1, nothing to fence, the
    local clock). Under a group of three: its rank and size, a barrier
    through it and rank 0's time stamp (broadcast)."""
    assert (tmh.is_distributed(), tmh.process_index(),
            tmh.process_count()) == (False, 0, 1)
    tmh.barrier("nothing to fence")
    assert re.fullmatch(r"\d{8}_\d{6}", tmh.shared_timestamp())
    calls = []
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 3)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    monkeypatch.setattr(torch.distributed, "barrier",
                        lambda: calls.append("barrier"))

    def broadcast(objs, src):
        calls.append(("broadcast", src))
        objs[0] = 0                        # rank 0's clock: the epoch

    monkeypatch.setattr(torch.distributed, "broadcast_object_list",
                        broadcast)
    assert (tmh.is_distributed(), tmh.process_index(),
            tmh.process_count()) == (True, 1, 3)
    tmh.barrier("stage")
    import time
    assert tmh.shared_timestamp() == time.strftime("%Y%m%d_%H%M%S",
                                                   time.localtime(0))
    assert calls == ["barrier", ("broadcast", 0)]


# ---------------------------------------------------------------------------
# the worker merges
# ---------------------------------------------------------------------------

def _partials(root):
    parts = {
        0: {DS: {"1_shot": {"crazing": [
            {"sample_id": "crazing_3", "rank": 1},
            {"sample_id": "crazing_1", "rank": 1}]}}},
        1: {DS: {"1_shot": {"crazing": [
            {"sample_id": "crazing_2", "rank": 2},
            {"sample_id": "crazing_1", "rank": 9}],
            "patches": [{"sample_id": "patches_4"}]}},
            "DIOR": {"5_shot": {"ship": [{"sample_id": "s"}]}}},
        10: {DS: {"5_shot": {"crazing": [{"sample_id": "c"}]}}},
    }
    root.mkdir(parents=True)
    for w, part in parts.items():
        with open(root / f"all_shots_retrieval_results.worker{w}.json",
                  "w") as f:
            json.dump(part, f)
    return str(root)


def test_merge_retrieval_results_match_jax(tmp_path):
    jdir = _partials(tmp_path / "jax")
    tdir = _partials(tmp_path / "port")
    want = jmh.merge_worker_retrieval_results(jdir)
    got = tmh.merge_worker_retrieval_results(tdir)
    assert got == want
    assert [e["rank"] for e in got[DS]["1_shot"]["crazing"]] == [1, 2, 1]
    name = "all_shots_retrieval_results.json"
    with open(os.path.join(tdir, name)) as f, \
            open(os.path.join(jdir, name)) as g:
        assert f.read() == g.read()
    assert tmh.merge_worker_retrieval_results(str(tmp_path)) is None \
        is jmh.merge_worker_retrieval_results(str(tmp_path))


def test_merge_manifests_match_jax(tmp_path):
    paths = []
    for w, samples in enumerate([{"a": {"status": "done"}},
                                 {"b": {"status": "failed"},
                                  "a": {"status": "failed"}}]):
        p = tmp_path / f"manifest.worker{w}.json"
        p.write_text(json.dumps({"process_id": str(w), "samples": samples}))
        paths.append(str(p))
    paths.append(str(tmp_path / "missing.json"))
    want = jmh.merge_worker_manifests(paths, str(tmp_path / "j" / "m.json"))
    got = tmh.merge_worker_manifests(paths, str(tmp_path / "t" / "m.json"))
    assert got == want == {"a": {"status": "failed"},
                           "b": {"status": "failed"}}
    assert (tmp_path / "t" / "m.json").read_text() == \
        (tmp_path / "j" / "m.json").read_text()


# ---------------------------------------------------------------------------
# the prompt cache
# ---------------------------------------------------------------------------

def test_prompt_cache_matches_jax():
    jb = jfp.tiny_bundle(jax.random.PRNGKey(3))
    tb = port_bundle(jb, fill=False)
    prompts = ["a calm sea", "", "steel surface with scratches"]
    jfp.precompute_prompts(jb, prompts)
    tfp.precompute_prompts(tb, prompts)
    assert list(tb.prompt_cache) == prompts
    for p in prompts:
        direct = tfp.encode_prompt(dataclasses.replace(tb, prompt_cache=None),
                                   [p])
        for got, same, want in zip(tb.prompt_cache[p], direct,
                                   jb.prompt_cache[p]):
            assert torch.equal(got, same)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5)
    tfp.release_text_encoders(tb)
    jfp.release_text_encoders(jb)
    assert tb.t5_params is None and tb.clip_text_params is None
    got = tfp.encode_prompt(tb, prompts[::-1])         # cache hits only
    want = jfp.encode_prompt(jb, prompts[::-1])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    with pytest.raises(ValueError) as te:
        tfp.encode_prompt(tb, ["a calm sea", "unseen"])
    with pytest.raises(ValueError) as je:
        jfp.encode_prompt(jb, ["a calm sea", "unseen"])
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# all four stages against the JAX runner
# ---------------------------------------------------------------------------

def _toy_env(root):
    """datasets/NEU-DET (two 1-shot samples) and an 8-image corpus, as
    ``tests/test_pipeline_e2e.py`` builds them."""
    rng = np.random.default_rng(5)
    ds = root / "datasets" / DS
    (ds / "train").mkdir(parents=True)
    jwrite_coco(str(ds / "annotations" / "1_shot.json"),
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
    paths = []
    for i in range(8):
        p = corpus / f"{i:06d}.jpg"
        Image.fromarray(rng.integers(0, 255, (36, 44, 3), dtype=np.uint8)
                        ).save(p)
        paths.append(str(p))
    return str(root / "datasets"), paths


def _pipeline_cfg(mod, datasets_dir, output_dir):
    return mod.PipelineConfig(
        datasets=(DS,), shots=(1,), datasets_dir=datasets_dir,
        output_dir=output_dir, process_id="t",
        generate=mod.GenerateConfig(
            sampling=mod.FluxSamplingConfig(num_steps=2, height=32,
                                            width=32, seed=0),
            redux=mod.ReduxConfig(), top_ranks=2),
        compose=mod.ComposeConfig(
            resolution=mod.ResolutionPolicy(min_dimension=32,
                                            max_dimension=64),
            num_steps=2, dataset_params={DS: mod.DatasetParams(
                strength=0.5, guidance_scale=4.0, upscale_dimension=32)}))


def _np_tree(tree):
    return bridge.params(jax.tree.map(np.asarray, tree), device="cpu")


def _port_runner(jr, cfg, corpus):
    """The JAX tiny runner's weights, bridged, in a port runner."""
    clip_cfg = bridge.config(jr.clip_encoder.cfg, tclip.ClipVisionConfig)
    lama_cfg = bridge.config(jr.lama_runner.cfg, tlama.LamaConfig)
    return torch_orch.PipelineRunner(
        cfg=cfg,
        lama_runner=tinpaint.LamaRunner(_np_tree(jr.lama_runner.params),
                                        lama_cfg, device="cpu"),
        clip_encoder=tenc.ClipImageEncoder(
            _np_tree(jr.clip_encoder._params), clip_cfg, batch_size=8,
            device="cpu"),
        style_encoder=tenc.StyleEncoder(_np_tree(jr.style_encoder._params),
                                        batch_size=8, resize=64,
                                        device="cpu"),
        flux_bundle=port_bundle(jr.flux_bundle, fill=False),
        fill_bundle=port_bundle(jr.fill_bundle, fill=True),
        corpus_sources={"coco": corpus})


def _jax_noise(bundle, seeds, seq, c):
    return torch.stack([
        torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(int(s)), (seq, c), np.float32)))
        for s in seeds])


_STAMP = re.compile(r"_\d{8}_\d{6}")


def _files(root):
    return sorted(_STAMP.sub("_<ts>", os.path.relpath(os.path.join(d, f),
                                                      root))
                  for d, _, fs in os.walk(root) for f in fs)


def _real(root, name):
    """The path under ``root`` of a normalized name."""
    for d, _, fs in os.walk(root):
        for f in fs:
            path = os.path.join(d, f)
            if _STAMP.sub("_<ts>", os.path.relpath(path, root)) == name:
                return path
    raise FileNotFoundError(name)


def _same_json(got, want, groot, wroot):
    """Same keys, order and strings (output roots and time stamps aside);
    floats within 1e-5."""
    if isinstance(want, dict):
        skip = ("timestamp", "updated_at", "elapsed_s", "completed")
        assert [k for k in got if k not in skip] == \
            [k for k in want if k not in skip]
        for key in want:
            if key not in skip:
                _same_json(got[key], want[key], groot, wroot)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_json(g, w, groot, wroot)
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= 1e-5, (got, want)
    elif isinstance(want, str):
        assert _STAMP.sub("", got.replace(groot, "<out>")) == \
            _STAMP.sub("", want.replace(wroot, "<out>"))
    else:
        assert got == want


def _same_stage(got_dir, want_dir, subdir, groot, wroot):
    """The files one stage wrote under ``subdir`` agree; ``groot`` /
    ``wroot`` are the output roots the files name."""
    names = [n for n in _files(want_dir) if n.startswith(subdir)]
    assert names and names == [n for n in _files(got_dir)
                               if n.startswith(subdir)]
    n_images = 0
    for name in names:
        a, b = _real(got_dir, name), _real(want_dir, name)
        if name.endswith(".json"):
            with open(a) as f, open(b) as g:
                _same_json(json.load(f), json.load(g), groot, wroot)
        elif name.endswith(".txt"):
            with open(a) as f, open(b) as g:
                _same_text(f.read(), g.read(), groot, wroot)
        elif name.endswith(".npy"):
            np.testing.assert_allclose(np.load(a), np.load(b), atol=1e-5,
                                       err_msg=name)
        elif name.endswith((".png", ".jpg")) and not any(
                part in name for part in ("_mask_", "_original",
                                          "bbox_crops", "ref_input")):
            x = np.asarray(Image.open(a)).astype(int)
            y = np.asarray(Image.open(b)).astype(int)
            assert x.shape == y.shape, name
            assert np.abs(x - y).max() <= 1, name
            n_images += 1
        else:
            with open(a, "rb") as f, open(b, "rb") as g:
                assert f.read() == g.read(), name
    return n_images


_FLOAT = re.compile(r"(-?\d+\.\d+(?:e-?\d+)?)")


def _same_text(got, want, groot, wroot):
    """A text artifact equal but for its output root, time stamps and
    completion line, with decimal numbers within 1e-5."""
    def lines(text, root):
        return [_FLOAT.split(_STAMP.sub("", line.replace(root, "<out>")))
                for line in text.splitlines()
                if not line.startswith("completed:")]

    g, w = lines(got, groot), lines(want, wroot)
    assert len(g) == len(w)
    for gl, wl in zip(g, w):
        assert gl[::2] == wl[::2]                 # the text between numbers
        assert all(abs(float(x) - float(y)) <= 1e-5
                   for x, y in zip(gl[1::2], wl[1::2])), (gl, wl)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX runner through the DAG; the port's runner through it stage
    by stage, each stage started from the JAX stage's outputs: the port's
    own stage-1 and stage-3 outputs are moved to ``own`` and the JAX ones
    put in their place."""
    root = tmp_path_factory.mktemp("dag")
    datasets_dir, corpus = _toy_env(root)
    jout, tout, own = str(root / "jax"), str(root / "port"), root / "own"
    jr = jorch.build_tiny_runner(_pipeline_cfg(jconfig, datasets_dir, jout),
                                 {"coco": corpus})
    random.seed(11)                 # compose draws its seeds from random
    want = jr.run()
    tr = _port_runner(jr, _pipeline_cfg(tconfig, datasets_dir, tout), corpus)
    own.mkdir()
    patch = pytest.MonkeyPatch()
    patch.setattr(tfp, "_noise", _jax_noise)
    got = {}
    try:
        for stage, subdir in (("inpaint", "lamainpaint"),
                              ("retrieve", None), ("generate", "result")):
            got[stage] = tr.run(stages=(stage,))[stage]
            if subdir:
                shutil.move(os.path.join(tout, subdir), own / subdir)
                shutil.copytree(os.path.join(jout, subdir),
                                os.path.join(tout, subdir))
        random.seed(11)
        got.update(tr.run(stages=("compose",)))
    finally:
        patch.undo()
    return jout, tout, str(own), want, got


def test_dag_writes_the_jax_file_tree(runs):
    jout, tout, own, want, got = runs
    assert _files(tout) == _files(jout)
    stages = {"stage/inpaint", "stage/retrieve", "stage/generate",
              "stage/compose"}
    assert set(want["timings"]) == stages
    # the port's runner hands its timer to stages 3 and 4: their spans
    # sit beside the stage totals (stage 3 prefetches its prior inputs)
    assert set(got["timings"]) == stages | {
        "prior", "prior/text", "prior/image", "denoise", "step", "decode",
        "prepare", "prior/inputs", "fill", "fill/inputs", "encode", "save"}
    for stage in ("inpaint", "generate"):
        assert got[stage] == want[stage], stage
    assert want["generate"] == {f"{DS}/1": {
        "processed": 2, "failed": 0, "skipped": 0, "fallback": 0}}


@pytest.mark.parametrize("stage,subdir,n_images", [
    ("inpaint", "lamainpaint", 2), ("retrieve", "retrieval_results", 2),
    ("generate", "result", 6), ("compose", "outpaint_hires", 8),
    ("compose", "final_results", 4)])
def test_dag_stage_matches_jax(runs, stage, subdir, n_images):
    jout, tout, own, want, got = runs
    where = own if subdir in ("lamainpaint", "result") else tout
    assert _same_stage(where, jout, subdir, tout, jout) == n_images
    _same_json(got[stage], want[stage], tout, jout)
