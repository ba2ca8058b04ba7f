"""Stage 3's dataset sweep in the port against the JAX package's, on the
JAX ``tiny_bundle`` weights carried by the bridge, and the port's four
stages chained, all on the CPU.

Limits, each with its reason:
- the reference helpers (``top_ranked_refs``, ``fallback_seed``,
  ``random_fallback_refs``) and the tolerant reader of ``stages.migrate``:
  equal (the same host code);
- ``process_dataset`` (pipelined, legacy and ``reference_artifacts``):
  the same file tree, the same ``batch_params.txt`` but for its
  ``completed:`` timestamp, the same manifest statuses and outputs, the
  same text artifacts, and the generated PNGs within 1 uint8 level (f32
  on both sides from the same noise; a value on a rounding edge may land
  on either side); the JAX noise is handed to the port;
- the port's pipelined loop against its own direct ``generate_sample``:
  equal bytes (threads change when the work runs, not what it computes).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from domainrag_tpu.core.config import FluxSamplingConfig as JSampling
from domainrag_tpu.core.config import GenerateConfig as JGenerateConfig
from domainrag_tpu.core.config import ReduxConfig as JRedux
from domainrag_tpu.models.flux import pipeline as jfp
from domainrag_tpu.stages import generate as jgen
from domainrag_tpu.stages import migrate as jmig
from domainrag_tpu_torch.core.config import (FluxSamplingConfig,
                                             GenerateConfig, ReduxConfig)
from domainrag_tpu_torch.core import prng
from domainrag_tpu_torch.core.log import StepTimer
from domainrag_tpu_torch.models.flux import pipeline as tfp
from domainrag_tpu_torch.stages import generate as tgen
from domainrag_tpu_torch.stages import migrate as tmig

from test_torch_generate import _port_bundle

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

SIZE, STEPS = 32, 2
DS, SHOT = "NEU-DET", 1


def _jax_noise(bundle, seeds, seq, c):
    return torch.stack([
        torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(int(s)), (seq, c), np.float32)))
        for s in seeds])


@pytest.fixture(scope="module")
def stages():
    jb = jfp.tiny_bundle(jax.random.PRNGKey(0))
    kw = dict(num_steps=STEPS, height=SIZE, width=SIZE, seed=0)
    jcfg = JGenerateConfig(sampling=JSampling(**kw), redux=JRedux(),
                           top_ranks=2)
    tcfg = GenerateConfig(sampling=FluxSamplingConfig(**kw),
                          redux=ReduxConfig(), top_ranks=2)
    return (jgen.GenerateStage(jb, jcfg),
            tgen.GenerateStage(_port_bundle(jb), tcfg))


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(tfp, "_noise", _jax_noise)


def _image(rng, path, w, h):
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                    ).save(path)
    return str(path)


def make_dataset(root, n_samples=3, break_ref_of=None):
    """A lamainpaint shot dir, a corpus, and a retrieval JSON that lists
    every sample but the last (which takes the seeded fallback)."""
    rng = np.random.default_rng(0)
    shot_dir = root / "lamainpaint" / DS / f"{SHOT}_shot"
    shot_dir.mkdir(parents=True)
    corpus = root / "corpus"
    corpus.mkdir()
    paths = [_image(rng, corpus / f"{i:012d}.jpg", 36, 30) for i in range(4)]
    entries = []
    for i in range(n_samples):
        sid = f"crazing_{i + 1}"
        _image(rng, shot_dir / f"{sid}.jpg", 40, 40)
        if i == n_samples - 1:
            continue
        sims = [{"rank": r + 1, "similarity": 0.9 - 0.1 * r,
                 "image_path": paths[(i + r) % len(paths)],
                 "source_dataset": "coco"} for r in range(3)]
        if break_ref_of == sid:
            sims[0]["image_path"] = str(root / "missing.jpg")
        entries.append({"sample_id": sid, "image_path": "x",
                        "category": "crazing", "similar_images": sims})
    rr = {DS: {f"{SHOT}_shot": {"crazing": entries}}}
    return str(root / "lamainpaint"), rr, paths


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _batch_params(path):
    with open(path) as f:
        return [line for line in f.read().splitlines()
                if not line.startswith("completed:")]


def _manifest(path, root):
    with open(path) as f:
        samples = json.load(f)["samples"]
    out = {}
    for sid, rec in samples.items():
        rec = {k: v for k, v in rec.items()
               if k not in ("updated_at", "elapsed_s")}
        if "outputs" in rec:
            rec["outputs"] = {k: [os.path.relpath(p, root) for p in v]
                              for k, v in rec["outputs"].items()}
        out[sid] = rec
    return out


def _same_run(jout, tout, run_dir):
    """The two run trees agree: files, batch_params, manifest, texts,
    images within 1 level."""
    assert _files(tout) == _files(jout)
    jrun, trun = os.path.join(jout, run_dir), os.path.join(tout, run_dir)
    assert _batch_params(os.path.join(trun, "batch_params.txt")) == \
        _batch_params(os.path.join(jrun, "batch_params.txt"))
    assert _manifest(os.path.join(trun, "manifest.json"), tout) == \
        _manifest(os.path.join(jrun, "manifest.json"), jout)
    n_png = 0
    for name in _files(jout):
        a, b = os.path.join(tout, name), os.path.join(jout, name)
        if name.endswith(".png") and "generated_image" in name:
            x = np.asarray(Image.open(a)).astype(int)
            y = np.asarray(Image.open(b)).astype(int)
            assert x.shape == y.shape == (SIZE, SIZE, 3)
            assert np.abs(x - y).max() <= 1, name
            n_png += 1
        elif name.endswith((".txt", ".jpg", ".png")) \
                and not name.endswith("batch_params.txt"):
            with open(a, "rb") as f, open(b, "rb") as g:
                assert f.read() == g.read(), name
    return n_png


# ---------------------------------------------------------------------------
# reference helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sample,top", [("crazing_1", 2), ("crazing_2", 5),
                                        ("crazing_3", 2), ("nope", 1)])
def test_top_ranked_refs_match_jax(tmp_path, sample, top):
    _, rr, _ = make_dataset(tmp_path)
    rr[DS][f"{SHOT}_shot"]["crazing"][0]["similar_images"][1]["rank"] = 9
    for ds, shot in ((DS, SHOT), (DS, 5), ("DIOR", SHOT)):
        assert tgen.top_ranked_refs(rr, ds, shot, sample, top) == \
            jgen.top_ranked_refs(rr, ds, shot, sample, top)


@pytest.mark.parametrize("key", [("NEU-DET", 1, "crazing_1"),
                                 ("DIOR", 10, "00017"), ("coco", 5, "")])
def test_fallback_refs_match_jax(key):
    seed = tgen.fallback_seed(*key)
    assert seed == jgen.fallback_seed(*key)
    corpus = [f"/c/{i}.jpg" for i in range(9)]
    for top in (1, 5, 20):
        assert tgen.random_fallback_refs(corpus, top, seed) == \
            jgen.random_fallback_refs(corpus, top, seed)


# ---------------------------------------------------------------------------
# process_dataset
# ---------------------------------------------------------------------------

def test_process_dataset_matches_jax(tmp_path, stages, jax_noise):
    lama, rr, corpus = make_dataset(tmp_path)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jgen.process_dataset(stages[0], DS, SHOT, rr, lama, jout,
                                corpus_paths=corpus, run_name="run")
    timer = StepTimer()
    got = tgen.process_dataset(stages[1], DS, SHOT, rr, lama, tout,
                               corpus_paths=corpus, run_name="run",
                               timer=timer)
    assert got == want == {"processed": 3, "failed": 0, "skipped": 0,
                           "fallback": 1}
    run = os.path.join("result", f"{DS}_{SHOT}shot_retrieval", "run")
    assert _same_run(jout, tout, run) == 6
    assert timer.counts["prior"] == 3 and timer.counts["step"] == 3 * STEPS
    assert "save" not in timer.counts          # the writer thread saves
    # resume skips what is done
    again = tgen.process_dataset(stages[1], DS, SHOT, rr, lama, tout,
                                 corpus_paths=corpus, run_name="run",
                                 resume=True)
    assert again == {"processed": 0, "failed": 0, "skipped": 3,
                     "fallback": 0}


def test_worker_shard_and_no_fallback(tmp_path, stages):
    lama, rr, _ = make_dataset(tmp_path)
    cfg = dataclasses.replace(stages[1].cfg, sampling=dataclasses.replace(
        stages[1].cfg.sampling, num_steps=1))
    stage = tgen.GenerateStage(stages[1].bundle, cfg)
    got = tgen.process_dataset(stage, DS, SHOT, rr, lama,
                               str(tmp_path / "out"), run_name="run",
                               worker_id=1, num_workers=2)
    # the sorted samples' odd share: crazing_2 only; worker 1 writes its
    # own manifest and appends a tagged totals block (worker 0 writes the
    # header)
    base = tmp_path / "out" / "result" / f"{DS}_{SHOT}shot_retrieval" / "run"
    assert got == {"processed": 1, "failed": 0, "skipped": 0, "fallback": 0}
    assert sorted(os.listdir(base)) == ["batch_params.txt", "crazing_2",
                                        "manifest.worker1.json"]
    text = (base / "batch_params.txt").read_text()
    assert text.startswith("\n[worker1]\nsucceeded_samples: 1\n")
    out = tgen.process_dataset(stage, DS, SHOT, rr, lama,
                               str(tmp_path / "out"), run_name="run2")
    assert out["failed"] == 1 and out["processed"] == 2   # no corpus given
    assert tgen.process_dataset(stage, "DIOR", SHOT, rr, lama,
                                str(tmp_path / "out")) == {}


def _statuses(tmp_path, out="out"):
    path = (tmp_path / out / "result" / f"{DS}_{SHOT}shot_retrieval" / "run"
            / "manifest.json")
    with open(path) as f:
        return {k: v["status"] for k, v in json.load(f)["samples"].items()}


def test_prefetch_failure_marks_only_that_sample(tmp_path, stages):
    lama, rr, corpus = make_dataset(tmp_path, break_ref_of="crazing_2")
    got = tgen.process_dataset(stages[1], DS, SHOT, rr, lama,
                               str(tmp_path / "out"), corpus_paths=corpus,
                               run_name="run")
    assert got["processed"] == 2 and got["failed"] == 1
    assert _statuses(tmp_path) == {"crazing_1": "done",
                                   "crazing_2": "failed",
                                   "crazing_3": "done"}
    base = tmp_path / "out" / "result" / f"{DS}_{SHOT}shot_retrieval" / "run"
    assert (base / "crazing_2" / "generation_failed.txt").exists()


def test_save_failure_marks_only_that_sample(tmp_path, stages,
                                             monkeypatch):
    lama, rr, corpus = make_dataset(tmp_path)
    real_write = tgen._write_rank_artifacts

    def flaky_write(sample_dir, ref, target_path, img):
        if sample_dir.endswith("crazing_2"):
            raise OSError("disk full (simulated)")
        return real_write(sample_dir, ref, target_path, img)

    monkeypatch.setattr(tgen, "_write_rank_artifacts", flaky_write)
    got = tgen.process_dataset(stages[1], DS, SHOT, rr, lama,
                               str(tmp_path / "out"), corpus_paths=corpus,
                               run_name="run")
    assert got["processed"] == 2 and got["failed"] == 1
    assert _statuses(tmp_path) == {"crazing_1": "done",
                                   "crazing_2": "failed",
                                   "crazing_3": "done"}


def test_pipelined_matches_direct_generate(tmp_path, stages):
    """The loop's PNG bytes equal a direct generate_sample call's."""
    lama, rr, corpus = make_dataset(tmp_path, n_samples=2)
    tgen.process_dataset(stages[1], DS, SHOT, rr, lama,
                         str(tmp_path / "out"), run_name="run")
    base = tmp_path / "out" / "result" / f"{DS}_{SHOT}shot_retrieval" / "run"
    refs = rr[DS][f"{SHOT}_shot"]["crazing"][0]["similar_images"][:2]
    paths = stages[1].generate_sample(
        "crazing_1", os.path.join(lama, DS, f"{SHOT}_shot", "crazing_1.jpg"),
        refs, str(tmp_path / "direct"))
    assert [os.path.basename(p) for p in paths] == [
        "generated_image_rank1.png", "generated_image_rank2.png"]
    for p in paths:
        with open(p, "rb") as f, \
                open(base / "crazing_1" / os.path.basename(p), "rb") as g:
            assert f.read() == g.read()


def test_writer_returns_a_future(tmp_path, stages):
    from concurrent.futures import Future, ThreadPoolExecutor
    lama, rr, _ = make_dataset(tmp_path, n_samples=2)
    refs = rr[DS][f"{SHOT}_shot"]["crazing"][0]["similar_images"][:1]
    target = os.path.join(lama, DS, f"{SHOT}_shot", "crazing_1.jpg")
    stage = stages[1]
    with ThreadPoolExecutor(1) as writer:
        fut = stage.generate_sample(
            "crazing_1", target, refs, str(tmp_path / "s"),
            prior_inputs=stage._prior_inputs(refs, target), writer=writer)
        assert isinstance(fut, Future)
        assert fut.result() == [str(tmp_path / "s" /
                                    "generated_image_rank1.png")]


def test_prior_for_pair_matches_jax(tmp_path, stages):
    lama, rr, _ = make_dataset(tmp_path, n_samples=2)
    ref = rr[DS][f"{SHOT}_shot"]["crazing"][0]["similar_images"][0]
    target = os.path.join(lama, DS, f"{SHOT}_shot", "crazing_1.jpg")
    want = stages[0]._prior_for_pair(ref["image_path"], target)
    got = stages[1]._prior_for_pair(ref["image_path"], target)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)
    ju, jp = stages[0]._prior_inputs([ref], target)
    tu, tp = stages[1]._prior_inputs([ref], target)
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(tp, jp)


@pytest.mark.parametrize("kwargs", [dict(mesh=True), dict(dp_samples=2),
                                    dict(pipe_mesh=True)],
                         ids=["mesh", "dp_samples", "pipe_mesh"])
def test_meshes_raise(tmp_path, stages, jax_noise, kwargs):
    """A one-device mesh (one process, a one-rank mesh), ``dp_samples``
    without a mesh and a pipe mesh of one device give JAX's sweep: the
    same counters and files (a pipe axis of one device fails each sample
    with JAX's ``ValueError``, recorded in ``generation_failed.txt``), the
    images within one level; ``generate_samples_dp`` of no items is
    empty."""
    from jax.sharding import Mesh as JMesh

    from domainrag_tpu.parallel import mesh as jmesh
    from domainrag_tpu_torch.parallel import mesh as tmesh
    lama, rr, _ = make_dataset(tmp_path, n_samples=2)
    meshes = {"mesh": (jmesh.create_mesh(devices=jax.devices()[:1]),
                       tmesh.create_mesh()),
              "pipe_mesh": (JMesh(np.array(jax.devices()[:1]), ("pipe",)),
                            tmesh.Mesh(np.arange(1), ("pipe",)))}
    runs = []
    for side, (stage, mod) in enumerate(zip(stages, (jgen, tgen))):
        kw = {k: meshes[k][side] if k in meshes else v
              for k, v in kwargs.items()}
        out = str(tmp_path / f"out{side}")
        runs.append((mod.process_dataset(stage, DS, SHOT, rr, lama, out,
                                         run_name="run", **kw), out))
        assert mod.generate_samples_dp(stage, [], kw.get("mesh")) == {}
    (want, jout), (got, tout) = runs
    assert got == want
    files = [sorted(os.path.relpath(os.path.join(d, f), root)
                    for d, _, fs in os.walk(root) for f in fs)
             for root in (jout, tout)]
    assert files[1] == files[0]
    for rel in files[0]:
        a, b = (os.path.join(r, rel) for r in (jout, tout))
        if rel.endswith(".png"):
            diff = np.abs(np.asarray(Image.open(a), int)
                          - np.asarray(Image.open(b), int))
            assert diff.max() <= 1
        elif rel.endswith("generation_failed.txt"):
            assert open(a).read() == open(b).read()


# ---------------------------------------------------------------------------
# legacy mode and the reference-artifact reader
# ---------------------------------------------------------------------------

def make_legacy(root):
    """The legacy inpaint layout and per-dataset retrieval file of the JAX
    package's legacy tests: two samples, one dir without its target."""
    rng = np.random.default_rng(3)
    inp = root / "inpainted"
    for s in ("crazing_1", "patches_2"):
        d = inp / DS / "inpainted_images" / s
        d.mkdir(parents=True)
        _image(rng, d / "1_inpainted.png", 40, 36)
    (inp / DS / "inpainted_images" / "missing_3").mkdir()
    corpus = root / "corpus"
    corpus.mkdir()
    sharp = _image(rng, corpus / "ref_a.jpg", 30, 30)
    blurred = _image(rng, corpus / "ref_b_blurred.jpg", 30, 30)
    rrd = root / "retrieval_results"
    rrd.mkdir()
    results = {
        "crazing": [{"original_filename": "crazing_1.jpg",
                     "similar_images": [
                         {"image_path": blurred, "similarity": 0.99},
                         {"image_path": sharp, "similarity": 0.42},
                         {"image_path": str(root / "gone.jpg"),
                          "similarity": 1.0}]}],
        "patches": [{"original_filename": "patches_2.jpg",
                     "similar_images": [{"image_path": blurred,
                                         "similarity": 0.7}]}]}
    with open(rrd / f"{DS}_all_categories_retrieval_results.json", "w") as f:
        json.dump(results, f)
    return str(inp), str(rrd), sharp, blurred


def test_legacy_mode_matches_jax(tmp_path, stages, jax_noise):
    inp, rrd, sharp, blurred = make_legacy(tmp_path)
    rr = tgen.load_legacy_retrieval_results(rrd, DS)
    assert rr == jgen.load_legacy_retrieval_results(rrd, DS)
    assert tgen.load_legacy_retrieval_results(rrd, "DIOR") is None
    for name, cats in (("crazing_1", ["crazing"]), ("patches_2", "patches"),
                       ("nope", ["crazing"])):
        assert tgen.find_similar_image_legacy(rr, name, cats) == \
            jgen.find_similar_image_legacy(rr, name, cats)
    assert tgen.find_similar_image_legacy(rr, "crazing_1",
                                          ["crazing"]) == sharp
    assert tgen.legacy_sample_folders(inp, DS) == \
        jgen.legacy_sample_folders(inp, DS)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jgen.process_dataset_legacy(stages[0], DS, inp, rrd, jout,
                                       run_name="run")
    got = tgen.process_dataset_legacy(stages[1], DS, inp, rrd, tout,
                                      run_name="run")
    assert got == want == {"processed": 2, "failed": 1, "skipped": 0}
    assert _same_run(jout, tout, os.path.join(DS, "run")) == 2
    again = tgen.process_dataset_legacy(stages[1], DS, inp, rrd, tout,
                                        run_name="run", resume=True)
    assert again == {"processed": 0, "failed": 1, "skipped": 2}


def _sims(n=5, prefix="/old/abs/coco"):
    return [{"rank": i + 1, "similarity": 1.0 - 0.1 * i,
             "image_path": f"{prefix}/img_{i}.jpg",
             "source_dataset": "coco"} for i in range(n)]


def _canonical(dataset="NEU-DET", shot=5, sample="inclusion_106"):
    return {dataset: {f"{shot}_shot": {"inclusion": [
        {"sample_id": sample, "image_path": "x.jpg",
         "category": "inclusion", "similar_images": _sims()}]}}}


# the drift cases of the JAX package's migration tests
DRIFT = [
    (_canonical(), "NEU-DET", 5, "inclusion_106", 5),
    (_canonical(dataset="Neu-Det"), "NEU-DET", 5, "inclusion_106", 5),
    ({"coco": {"1_shot": {"000000382438": [{"similar_images": _sims()}]}}},
     "coco", 1, "382438", 5),
    ({"coco": {"1_shot": {"382438": [{"similar_images": _sims()}]}}},
     "coco", 1, "000000382438", 5),
    ({"NEU-DET": {"5_shot": {"rolled-in_scale_14":
                             {"similar_images": _sims(3)}}}},
     "NEU-DET", 5, "rolled_in_scale_14", 5),
    (_canonical(), "NEU-DET", 5, "nope_1", 5),
    (_canonical(), "NEU-DET", 5, "inclusion_106", 2),
    ({"neu_det": {"5": {"inclusion": [
        {"sample_id": "INCLUSION-106", "similar_images": [
            {"path": "/p.jpg", "score": 0.5}]}]}}},
     "NEU-DET", 5, "inclusion_106", 5),
]


@pytest.mark.parametrize("case", range(len(DRIFT)))
def test_migrate_reader_matches_jax(case, tmp_path):
    data, ds, shot, sample, top = DRIFT[case]
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    (corpus / "img_0.jpg").write_bytes(b"x")
    roots = {"coco": str(corpus)}
    js, ts = jmig.MigrationStats(), tmig.MigrationStats()
    want = jmig.find_sample_refs_tolerant(data, ds, shot, sample, top,
                                          corpus_roots=roots, stats=js)
    got = tmig.find_sample_refs_tolerant(data, ds, shot, sample, top,
                                         corpus_roots=roots, stats=ts)
    assert got == want
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.summary() == js.summary()


def test_path_repair_matches_jax(tmp_path):
    root = tmp_path / "corpus"
    (root / "n01").mkdir(parents=True)
    (root / "img_0.jpg").write_bytes(b"x")
    (root / "n01" / "img_1.jpg").write_bytes(b"x")
    for path in ("/dead/absolute/img_0.jpg", "/dead/n01/img_1.jpg",
                 str(root / "img_0.jpg"), "/dead/img_9.jpg", ""):
        js, ts = jmig.MigrationStats(), tmig.MigrationStats()
        assert tmig.repair_image_path(path, {"coco": str(root)}, ts) == \
            jmig.repair_image_path(path, {"coco": str(root)}, js)
        assert ts.repaired_paths == js.repaired_paths


def test_reference_artifacts_mode_matches_jax(tmp_path, stages, jax_noise):
    """Reference-keyed JSON (case-variant dataset key, sample-keyed shot
    block, stale absolute paths) through both stages."""
    rng = np.random.default_rng(0)
    lam = tmp_path / "lamainpaint" / DS / "5_shot"
    lam.mkdir(parents=True)
    _image(rng, lam / "inclusion_106.jpg", 24, 24)
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for i in range(3):
        _image(rng, corpus / f"img_{i}.jpg", 16, 16)
    data = {"Neu-Det": {"5_shot": {"inclusion_106": {
        "similar_images": _sims(3, prefix="/stale/path")}}}}
    kw = dict(reference_artifacts=True, corpus_roots={"coco": str(corpus)},
              run_name="run")
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jgen.process_dataset(stages[0], DS, 5, data,
                                str(tmp_path / "lamainpaint"), jout, **kw)
    got = tgen.process_dataset(stages[1], DS, 5, data,
                               str(tmp_path / "lamainpaint"), tout, **kw)
    assert got == want
    assert got["processed"] == 1 and got["fuzzy_hits"] == 1
    assert got["repaired_paths"] == 2           # top_ranks 2 of the 3
    assert _same_run(jout, tout, os.path.join(
        "result", f"{DS}_5shot_retrieval", "run")) == 2


# ---------------------------------------------------------------------------
# the chain: stages 1 -> 2 -> 3 -> 4 of the port
# ---------------------------------------------------------------------------

def test_chain_stages_1_to_4(tmp_path):
    """Each stage reads only what the one before it wrote: stage 1 writes
    the backgrounds and ``category_mapping.json``; stage 2 reads them and
    writes ``all_shots_retrieval_results.json``; stage 3 reads that JSON
    and the backgrounds and writes the run tree; stage 4 reads the run
    tree (and the dataset's annotations) and writes the composites."""
    from domainrag_tpu_torch.core.coco import write_coco
    from domainrag_tpu_torch.core.config import (ComposeConfig,
                                                 DatasetParams,
                                                 ResolutionPolicy)
    from domainrag_tpu_torch.models import clip, lama, resnet_stem
    from domainrag_tpu_torch.stages import compose, encoders, inpaint
    from domainrag_tpu_torch.stages import retrieve

    rng = np.random.default_rng(21)
    datasets = tmp_path / "datasets"
    train = datasets / DS / "train"
    train.mkdir(parents=True)
    images = [{"id": 1, "file_name": "crazing_1.jpg", "width": 40,
               "height": 36},
              {"id": 2, "file_name": "patches_2.jpg", "width": 48,
               "height": 40}]
    for im in images:
        _image(rng, train / im["file_name"], im["width"], im["height"])
    write_coco(str(datasets / DS / "annotations" / f"{SHOT}_shot.json"),
               images=images,
               annotations=[{"id": 1, "image_id": 1, "category_id": 1,
                             "bbox": [4, 4, 12, 10]},
                            {"id": 2, "image_id": 2, "category_id": 2,
                             "bbox": [8, 8, 16, 12]}],
               categories=[{"id": 1, "name": "crazing"},
                           {"id": 2, "name": "patches"}])
    corpus = tmp_path / "coco" / "train2017"
    corpus.mkdir(parents=True)
    corpus_paths = [_image(rng, corpus / f"{i:012d}.jpg", 52, 40)
                    for i in range(6)]
    out = tmp_path / "output"

    # stage 1
    ks = prng.split(prng.PRNGKey(0), 3)
    runner = inpaint.LamaRunner(lama.init(ks[0], lama.TINY_LAMA),
                                lama.TINY_LAMA, device="cpu")
    s1 = inpaint.run_inpaint([DS], [SHOT], runner, str(datasets), str(out))
    assert s1 == {f"{DS}/{SHOT}": {"processed": 2, "skipped": 0,
                                   "failed": 0}}

    # stage 2
    clip_enc = encoders.ClipImageEncoder(
        clip.init_vision(ks[1], clip.TINY_VISION), clip.TINY_VISION,
        batch_size=4, device="cpu")
    style_enc = encoders.StyleEncoder(resnet_stem.init(ks[2]), resize=32,
                                      device="cpu")
    results = str(out / "retrieval_results")
    feats, kept = retrieve.load_or_compute_source_features(
        results, "coco", corpus_paths, clip_enc)
    bank = retrieve.EmbeddingBank.from_sources({"coco": feats},
                                               {"coco": kept}, device="cpu")
    retrieve.run_retrieval([DS], [SHOT], bank, clip_enc, style_enc,
                           str(out / "lamainpaint"), results)
    with open(os.path.join(results, "all_shots_retrieval_results.json")) as f:
        rr = json.load(f)
    assert sorted(rr[DS][f"{SHOT}_shot"]) == ["crazing", "patches"]

    # stage 3
    gcfg = GenerateConfig(
        sampling=FluxSamplingConfig(num_steps=STEPS, height=SIZE,
                                    width=SIZE), top_ranks=2)
    s3 = tgen.process_dataset(
        tgen.GenerateStage(tfp.tiny_bundle(device="cpu"), gcfg), DS,
        SHOT, rr, str(out / "lamainpaint"), str(out))
    assert s3 == {"processed": 2, "failed": 0, "skipped": 0, "fallback": 0}
    (run,) = os.listdir(out / "result" / f"{DS}_{SHOT}shot_retrieval")
    assert run.startswith("results_coco_0.8_target_1.0_")

    # stage 4
    ccfg = ComposeConfig(
        resolution=ResolutionPolicy(max_dimension=64), num_steps=2,
        dataset_params={DS: DatasetParams(strength=0.5, guidance_scale=4.0,
                                          upscale_dimension=32)})
    result = compose.process_dataset(
        compose.ComposeStage(tfp.tiny_bundle(device="cpu", fill=True),
                             ccfg, process_id="c", seed=0),
        DS, SHOT, str(datasets), str(out))
    composed = [f for f in _files(str(out / "outpaint_hires"))
                if f.endswith(".png") or f.endswith(".jpg")]
    assert len(composed) >= 4              # 2 samples x 2 backgrounds
    assert result
