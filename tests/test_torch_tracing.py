"""The port's one tracer, ``core.log.StepTimer``, and what reads it.

Outside :func:`core.log.maybe_trace` a span is two clock readings and
makes no torch call (``tests/test_torch_scheduler.py`` holds that path
to JAX's ``StepTimer``). Inside it, every span drains the card where
CUDA is initialised (an explicit ``sync=`` is called instead) and is a
``record_function`` range, so ``trace.json`` holds the stages' spans as
the code nests them: stage 3's ``prior`` with ``prior/inputs``,
``prior/text`` and ``prior/image``, stage 4's ``prepare`` and its fill's
``fill/inputs`` and ``encode``s. A prompt-cache hit opens no
``prior/text``. The benchmark's readers of those spans
(``gpubench/metrics``) give the arithmetic they state, and nothing where
the program opens no such span.
"""

import contextlib
import json
import os
import types

import numpy as np
import pytest
import torch
from PIL import Image

from domainrag_tpu_torch.core import log
from domainrag_tpu_torch.core import prng
from domainrag_tpu_torch.core.config import (ComposeConfig, DatasetParams,
                                             FluxSamplingConfig,
                                             GenerateConfig, ReduxConfig,
                                             ResolutionPolicy)
from domainrag_tpu_torch.core.log import StepTimer, maybe_trace
from domainrag_tpu_torch.models.flux import pipeline as tfp
from domainrag_tpu_torch.stages.compose import ComposeStage
from domainrag_tpu_torch.stages.generate import GenerateStage
from gpubench import run as bench_run

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

SIZE = 32


@pytest.fixture
def torch_calls(monkeypatch):
    """Every call to ``torch.cuda.synchronize`` and
    ``torch.profiler.record_function``, by name; CUDA reads as
    initialised."""
    calls = []
    real = torch.profiler.record_function

    def record_function(name, *a, **k):
        calls.append(("record_function", name))
        return real(name, *a, **k)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(("synchronize",)))
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    return calls


def _nest(timer):
    with timer.span("outer"):
        with timer.span("inner"):
            pass
        with timer.span("inner"):
            pass


def _annotations(trace_dir):
    with open(trace_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ts = float(e["ts"])
            out.setdefault(e["name"], []).append((ts, ts + float(e["dur"])))
    return out


def _inside(spans, child, parent, slack=1.0):
    """Each ``child`` range lies inside some ``parent`` range (to
    ``slack`` microseconds: the trace's epoch times parse to float64
    steps of a quarter microsecond)."""
    return all(any(pa - slack <= ca and cb <= pb + slack
                   for pa, pb in spans[parent])
               for ca, cb in spans[child])


@pytest.mark.parametrize("explicit", [False, True])
def test_span_off_makes_no_torch_call(torch_calls, explicit):
    """Tracing off: no synchronize and no record_function; an explicit
    ``sync`` is called as each span opens and closes, as before."""
    syncs = []
    timer = StepTimer(sync=(lambda: syncs.append(1)) if explicit else None)
    _nest(timer)
    assert torch_calls == []
    assert timer.counts == {"outer": 1, "inner": 2}
    assert len(syncs) == (6 if explicit else 0)


def test_maybe_trace_without_a_dir_leaves_tracing_off(torch_calls):
    with maybe_trace(None):
        _nest(StepTimer())
    assert torch_calls == []


def test_span_in_trace_syncs_and_annotates(torch_calls, tmp_path):
    """Inside ``maybe_trace``: each span drains the card as it opens and
    closes and is a trace range, nested as the code nests it; tracing is
    off again after the body."""
    timer = StepTimer()
    with maybe_trace(str(tmp_path)):
        _nest(timer)
    assert [c for c in torch_calls if c[0] == "record_function"] == [
        ("record_function", n) for n in ("outer", "inner", "inner")]
    assert torch_calls.count(("synchronize",)) == 2 * 3
    spans = _annotations(tmp_path)
    assert len(spans["outer"]) == 1 and len(spans["inner"]) == 2
    assert _inside(spans, "inner", "outer")
    del torch_calls[:]
    _nest(timer)
    assert torch_calls == [] and not log._tracing
    assert timer.counts == {"outer": 2, "inner": 4}


def test_span_in_trace_keeps_an_explicit_sync(torch_calls, tmp_path):
    """An explicit ``sync`` is the one called inside a trace too."""
    syncs = []
    with maybe_trace(str(tmp_path)):
        _nest(StepTimer(sync=lambda: syncs.append(1)))
    assert len(syncs) == 6
    assert ("synchronize",) not in torch_calls


def test_span_in_trace_without_cuda_does_not_sync(monkeypatch, tmp_path):
    """CUDA not initialised (this process never touched the card): the
    span does not start it."""
    def refuse():
        raise AssertionError("synchronize called without CUDA")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    with maybe_trace(str(tmp_path)):
        _nest(StepTimer())
    assert len(_annotations(tmp_path)["inner"]) == 2


# ---------------------------------------------------------------------------
# the stages' spans in a trace
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev_bundle():
    return tfp.tiny_bundle(device="cpu")


@pytest.fixture(scope="module")
def fill_bundle():
    return tfp.tiny_bundle(prng.PRNGKey(5), fill=True, device="cpu")


def _image(rng, w, h):
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def _generate_inputs(tmp_path, n_refs=2):
    rng = np.random.default_rng(9)
    target = tmp_path / "target.png"
    _image(rng, 24, 20).save(target)
    refs = []
    for i in range(n_refs):
        p = tmp_path / f"ref{i}.jpg"
        _image(rng, 20, 24).save(p)
        refs.append({"image_path": str(p), "rank": i + 1,
                     "similarity": 0.9 - 0.1 * i})
    return str(target), refs


def _generate_stage(bundle):
    return GenerateStage(bundle, GenerateConfig(
        sampling=FluxSamplingConfig(num_steps=2, height=SIZE, width=SIZE),
        redux=ReduxConfig(), top_ranks=2))


@contextlib.contextmanager
def _prompt_cache(bundle, prompts):
    """``precompute_prompts`` for the block; the bundle's cache as it was
    after."""
    saved = bundle.prompt_cache
    tfp.precompute_prompts(bundle, prompts)
    try:
        yield
    finally:
        bundle.prompt_cache = saved


def test_generate_sample_spans_in_trace(dev_bundle, torch_calls, tmp_path):
    """Stage 3 inside ``maybe_trace``: ``prior`` holds ``prior/inputs``,
    ``prior/text`` and ``prior/image``; the steps lie in ``denoise``;
    every span is drained as it opens and closes."""
    target, refs = _generate_inputs(tmp_path)
    timer = StepTimer()
    with maybe_trace(str(tmp_path / "trace")):
        _generate_stage(dev_bundle).generate_sample(
            "s", target, refs, str(tmp_path / "s"), timer=timer)
    assert timer.counts == {"prior": 1, "prior/inputs": 1, "prior/text": 1,
                            "prior/image": 1, "denoise": 1, "step": 2,
                            "decode": 1, "save": 1}
    assert torch_calls.count(("synchronize",)) == \
        2 * sum(timer.counts.values())
    spans = _annotations(tmp_path / "trace")
    assert {n: len(v) for n, v in spans.items()} == timer.counts
    for child in ("prior/inputs", "prior/text", "prior/image"):
        assert _inside(spans, child, "prior"), child
    for child in ("step", "decode"):
        assert _inside(spans, child, "denoise"), child


def test_compose_sample_spans_in_trace(fill_bundle, tmp_path):
    """Stage 4 inside ``maybe_trace``: ``prepare`` before ``prior``, which
    holds ``prior/inputs``, ``prior/text`` and ``prior/image``;
    ``fill/inputs`` and the two ``encode``s inside ``fill``."""
    rng = np.random.default_rng(5)
    bgs = []
    for rank in (1, 2):
        p = tmp_path / f"generated_image_rank{rank}.png"
        _image(rng, 32, 32).save(p)
        bgs.append(str(p))
    stage = ComposeStage(fill_bundle, ComposeConfig(
        resolution=ResolutionPolicy(max_dimension=64), num_steps=4,
        dataset_params={"UODD": DatasetParams(
            strength=0.5, guidance_scale=4.0, upscale_dimension=32)}),
        seed=0)
    timer = StepTimer()
    with maybe_trace(str(tmp_path / "trace")):
        stage.process_sample("UODD", 1, "s", _image(rng, 40, 36),
                             [(4, 4, 12, 10)], ["scallop"], bgs,
                             str(tmp_path / "out"), timer=timer)
    assert timer.counts == {"prepare": 1, "prior": 1, "prior/inputs": 1,
                            "prior/text": 1, "prior/image": 1, "fill": 1,
                            "fill/inputs": 1, "encode": 2, "step": 2,
                            "decode": 1, "save": 2}
    spans = _annotations(tmp_path / "trace")
    assert {n: len(v) for n, v in spans.items()} == timer.counts
    for child in ("prior/inputs", "prior/text", "prior/image"):
        assert _inside(spans, child, "prior"), child
    for child in ("fill/inputs", "encode", "step", "decode"):
        assert _inside(spans, child, "fill"), child
    assert spans["prepare"][0][1] <= spans["prior"][0][0]
    assert spans["fill/inputs"][0][1] <= min(a for a, _ in spans["encode"])


def test_prompt_cache_hit_opens_no_text_span(dev_bundle, tmp_path):
    """With the stage's prompt precomputed, the text towers do not run and
    no ``prior/text`` opens; the image towers still do."""
    target, refs = _generate_inputs(tmp_path)
    stage = _generate_stage(dev_bundle)
    with _prompt_cache(dev_bundle, [stage.cfg.redux.prompt]):
        timer = StepTimer()
        tfp.encode_prompt(dev_bundle, [stage.cfg.redux.prompt], timer=timer)
        assert timer.counts == {}
        stage.generate_sample("s", target, refs, str(tmp_path / "s"),
                              timer=timer)
    assert "prior/text" not in timer.counts
    assert timer.counts["prior/image"] == timer.counts["prior"] == 1
    timer = StepTimer()
    tfp.encode_prompt(dev_bundle, [stage.cfg.redux.prompt], timer=timer)
    assert timer.counts == {"prior/text": 1}


def test_prefetched_prior_inputs_open_no_inputs_span(dev_bundle, tmp_path):
    """Inputs handed in (``process_dataset``'s prefetch) are not made again:
    no ``prior/inputs`` span."""
    target, refs = _generate_inputs(tmp_path)
    stage = _generate_stage(dev_bundle)
    timer = StepTimer()
    stage.generate_sample("s", target, refs, str(tmp_path / "s"),
                          timer=timer,
                          prior_inputs=stage._prior_inputs(refs, target))
    assert "prior/inputs" not in timer.counts
    assert timer.counts["prior/text"] == timer.counts["prior/image"] == 1


# ---------------------------------------------------------------------------
# the benchmark's readers of these spans
# ---------------------------------------------------------------------------

def _spans(*named):
    """(name, start, end) triples of (name, seconds) pairs laid end to
    end: the readers take each span's length alone."""
    out, t = [], 100.0
    for name, sec in named:
        out.append((name, t, t + sec))
        t += sec
    return out


# two stage-4 samples as the program opens them; the second's prompt came
# from the cache (no prior/text)
SPANS = _spans(
    ("prepare", 0.08), ("prior/inputs", 0.2), ("prior/text", 0.15),
    ("prior/image", 0.1), ("prior", 0.5), ("fill/inputs", 0.4),
    ("encode", 1.0), ("encode", 0.9), ("step", 4.8), ("fill", 7.2),
    ("prepare", 0.12), ("prior/inputs", 0.3), ("prior/image", 0.06),
    ("prior", 0.4), ("fill/inputs", 0.6), ("encode", 1.2), ("encode", 0.8),
    ("step", 4.9))

# what the parent program opens: none of these spans
PARENT_SPANS = _spans(("prior", 0.6), ("encode", 1.0), ("encode", 1.0),
                      ("step", 4.8), ("fill", 7.5), ("save", 0.3))


@pytest.mark.parametrize("name,want", [
    ("prior.inputs_s", (0.2 + 0.3) / 2),
    ("prior.text_s", (0.15 + 0.0) / 2),
    ("prior.image_s", (0.1 + 0.06) / 2),
    ("compose.prepare_s", (0.08 + 0.12) / 2),
    ("fill.inputs_s", (0.4 + 0.6) / 2),
    ("fill.encode_s", (1.0 + 0.9 + 1.2 + 0.8) / 2),
])
def test_reader_arithmetic(name, want):
    read = bench_run._reader(name)
    assert read(types.SimpleNamespace(spans=SPANS)) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "prior.inputs_s", "prior.text_s", "prior.image_s", "compose.prepare_s",
    "fill.inputs_s", "fill.encode_s"])
@pytest.mark.parametrize("spans", [PARENT_SPANS, []],
                         ids=["parent", "empty"])
def test_reader_silent_without_its_spans(name, spans):
    read = bench_run._reader(name)
    assert read(types.SimpleNamespace(spans=spans)) is None


def test_readers_are_in_the_benchmark():
    """Each reader is a ``per_layer`` entry read from the program's
    spans, moving ``s_per_img``, in the cells that open its spans."""
    with open(os.path.join(bench_run.ROOT, "BENCHMARK.json")) as f:
        entries = {m["name"]: m for m in json.load(f)["per_layer"]}
    both = ["flux-dev.gen1024", "flux-fill.uodd2048"]
    for name, layer, cells in [
            ("prior.inputs_s", "prior", both),
            ("prior.text_s", "prior", both),
            ("prior.image_s", "prior", both),
            ("compose.prepare_s", "stage", both[1:]),
            ("fill.inputs_s", "Fill conditioning", both[1:]),
            ("fill.encode_s", "Fill conditioning", both[1:])]:
        m = entries[name]
        assert (m["source"], m["moves"], m["unit"], m["better"]) == (
            "program_span", "s_per_img", "s", "lower"), name
        assert (m["layer"], m["workloads"]) == (layer, cells), name
