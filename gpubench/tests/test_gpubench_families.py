"""The harness's family adapters and serving modes on the CPU.

- a toy family, defined by files under ``gpubench/tests`` alone, runs
  through ``run.measure`` and prints a result line: a family needs no
  edit to a file of the benchmark;
- the tiny stage-3 cell under the modes ``w8a8`` and ``int8_qk`` sets the
  program's int8 switches for set-up and the window and resets them,
  quantizes the MMDiT, and its result line's checks hold the int8 path's
  readings; the int4 control and each fault a serving cell can have fail
  the int8 cell's limits;
- on contexts of both FLUX cells, the readers that now take their counts
  from ``ctx`` return exactly what the formulas they replace return.
"""

import json
import os

import pytest
import torch

from gpubench import harness, run, weights
from gpubench.counts import flops
from gpubench.families import flux
from gpubench.tests.test_gpubench_bench import BENCH, _faulty
from gpubench.tests.tiny import tiny_cell

torch.set_num_threads(1)
ROOT = harness.ROOT
TOY = os.path.join(ROOT, "gpubench", "tests", "toy")
W8A8 = "flux-dev.gen1024-w8a8"
FLUX_CELLS = ["flux-dev.gen1024", "flux-fill.uodd2048"]


def _toy_cell() -> harness.Cell:
    def load(name):
        with open(os.path.join(TOY, name)) as f:
            return json.load(f)
    return harness.Cell("toy.cell", load("cell.json"), load("config.json"),
                        load("traffic.json"))


def _toy_bench() -> dict:
    """The benchmark's end-to-end metrics, and two of its readers listed
    for the toy cell."""
    return {"end_to_end": BENCH["end_to_end"],
            "per_layer": [dict(m, workloads=["toy.cell"])
                          for m in BENCH["per_layer"]
                          if m["name"] in ("denoise.step_s", "denoise.mfu")]}


@pytest.mark.parametrize("trace", [0, 1])
def test_a_family_added_by_files_alone(trace, capsys):
    cell = _toy_cell()
    assert cell.family.__name__ == "gpubench.tests.toy_family"
    fields, numbers = run.measure(cell, 3, 1e9, bool(trace), device="cpu",
                                  controls=True, max_samples=2)
    line = run.result_line(_toy_bench(), cell, fields, numbers, bool(trace),
                           "cpu", 1)
    print(json.dumps(line))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == 2 * 6 * cell.batch
    assert list(line["checks"]) == ["step_gap"]
    if trace:
        assert set(line["metrics"]) == {"denoise.step_s", "denoise.mfu"}
        assert line["metrics"]["denoise.mfu"]["value"] > 0
    else:
        assert set(line["metrics"]) == {"s_per_img", "peak_mem_gb",
                                        "setup_s"}
    # the toy's control (bfloat16 operands) fails its limit
    assert fields["control"]["step_gap"] > cell.spec["limits"]["step_gap"]


def _w8a8_limits() -> dict:
    return harness.load_json("cells", f"{W8A8}.json")["limits"]


@pytest.fixture
def quantize_tiny(monkeypatch):
    """``quantize_tree`` at ``min_size`` 1024: the default quantizes
    nothing at the tiny widths."""
    from domainrag_tpu_torch.models import quant
    real = quant.quantize_tree
    monkeypatch.setattr(quant, "quantize_tree",
                        lambda params, min_size=None: real(params, 1024))


def _switches():
    from domainrag_tpu_torch.models import common
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    return (common.int8_activations_enabled(), mma.int8_qk_enabled(),
            mma.int8_pv_enabled())


def _w8a8_cell() -> harness.Cell:
    cell = tiny_cell(False, _w8a8_limits())
    cell.name = W8A8
    cell.traffic["modes"] = harness.load_json(
        "traffic", "gen1024-w8a8.json")["modes"]
    return cell


def test_int8_modes_set_and_reset(monkeypatch, quantize_tiny):
    """The modes are on while the bundle is built and samples run, off
    after; the MMDiT is quantized; the checks read the int8 path."""
    from domainrag_tpu_torch.ops import int8_gemm
    cell = _w8a8_cell()
    assert cell.modes == ("w8a8", "int8_qk")
    seen, quantized = [], []
    real_build, real_run = flux.build_bundle, flux.run_sample

    def build(*a, **k):
        seen.append(_switches())
        bundle = real_build(*a, **k)
        quantized.append(sum("w_q" in p for p in _linears(
            bundle.flux_params)))
        return bundle

    def run_sample(*a, **k):
        seen.append(_switches())
        return real_run(*a, **k)
    monkeypatch.setattr(flux, "build_bundle", build)
    monkeypatch.setattr(flux, "run_sample", run_sample)
    calls = []
    real_ref = int8_gemm.w8a8_reference
    monkeypatch.setattr(int8_gemm, "w8a8_reference",
                        lambda *a, **k: calls.append(1) or real_ref(*a, **k))
    fields, numbers = run.measure(cell, 21, 1e9, False, device="cpu",
                                  max_samples=1)
    assert _switches() == (False, False, False)
    assert seen and all(s == (True, True, False) for s in seen), seen
    assert quantized[0] >= 2 * 10 + 2 * 3      # every block's linears
    assert calls                                # W8A8 products ran
    line = run.result_line(BENCH, cell, fields, numbers, False, "cpu", 1)
    assert set(line["checks"]) == set(_w8a8_limits())
    # float32 at the tiny widths reads under 1e-5 (test_gpubench_bench)
    assert line["checks"]["gemm_gap"]["value"] > 1e-3
    assert line["checks"]["velocity_gap"]["value"] > 1e-3
    assert line["checks"]["euler_gap"]["value"] == 0.0


def _linears(tree):
    if isinstance(tree, dict):
        if "w" in tree or "w_q" in tree:
            yield tree
        else:
            for v in tree.values():
                yield from _linears(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _linears(v)


def test_modes_unknown_to_the_family_are_refused():
    cell = tiny_cell(False)
    cell.traffic["modes"] = ["w4a4"]
    with pytest.raises(ValueError, match="w4a4"):
        with flux.serving_modes(cell):
            pass
    assert _switches() == (False, False, False)


def test_int4_in_the_programs_place_fails(quantize_tiny):
    """The int8 cell's control at a test's size: the reference with int4
    operands in the program's place fails the cell's limits of the
    sampled block's linears and attention."""
    import tempfile
    cell = _w8a8_cell()
    limits = _w8a8_limits()
    seed = 4
    rec = flux.Recorder([0], rows=range(cell.batch), block=1)
    with tempfile.TemporaryDirectory() as tmp, flux.serving_modes(cell):
        samples = flux.make_samples(cell, seed, tmp, 1)
        stage = flux.make_stage(cell, flux.build_bundle(cell, seed, "cpu"))
        with rec:
            flux.run_sample(cell, stage, samples[0],
                            os.path.join(tmp, "out"),
                            harness.BenchTimer(device="cpu"))
    with torch.inference_mode():
        comps = weights.components(cell.config, seed, "cpu")
        control = flux._mmdit_control(cell, comps, rec, "cpu")
    for k in ("gemm_gap", "attn_gap"):
        assert control[k] > limits[k], (k, control)


W8A8_FAULTS = ["state_unchanged", "velocity_altered",
               "double_attention_altered", "single_attention_altered",
               "answer_altered", "prior_altered"]


@pytest.mark.parametrize("fault", W8A8_FAULTS)
def test_a_fault_turns_correct_false_under_w8a8(monkeypatch, quantize_tiny,
                                                fault):
    """The int8 cell's run with its timed path broken underneath: its own
    limits see it."""
    cell = _w8a8_cell()
    _faulty(monkeypatch, fault)
    fields, numbers = run.measure(cell, 9, 1e9, False, device="cpu",
                                  max_samples=1)
    line = run.result_line(BENCH, cell, fields, numbers, False, "cpu", 1)
    assert line["correct"] is False, numbers


# Contexts of both FLUX cells as ``run.per_layer`` builds them: ten traced
# steps at the ledger's step times of PR 25, each step's device seconds by
# kernel group from the same runs' roofline readings.
CONTEXTS = {
    "flux-dev.gen1024": {"step": 0.89252, "groups": {
        "gemm": 0.45123, "b12": 0.20931, "other": 0.22185}},
    "flux-fill.uodd2048": {"step": 4.3727, "groups": {
        "gemm": 1.43371, "b3": 1.97706, "b12": 0.06093, "other": 0.75447}},
}


def _fields(cell_name: str) -> dict:
    c = CONTEXTS[cell_name]
    spans, t = [], 100.0
    for _ in range(10):
        spans.append(("step", t, t + c["step"]))
        t += c["step"] + 0.01
    trace = {"busy_s": 9.8 * c["step"], "window_s": 10.1 * c["step"],
             "groups": {k: 10 * v for k, v in c["groups"].items()},
             "steps_traced": 10, "device_ops": [], "idle_gaps": []}
    return {"spans": spans, "trace": trace, "setup": {"weights_s": 0.5}}


def _old_readings(cell: harness.Cell, fields: dict) -> dict:
    """The readers' formulas before their counts moved onto ``ctx``: FLUX
    sizes from the configuration, token counts from the traffic, the
    attention bound's default 24 heads of 128."""
    tc = cell.config["sizes"]["transformer"]
    t, b = cell.traffic, cell.batch
    steps = [e - a for name, a, e in fields["spans"] if name == "step"]
    tr = fields["trace"]
    f = flux.forward_flops(tc, t["s_img"], t["s_txt"], b)["total"]
    gemm = flops.gemm_bound_s(flux.forward_gemms(tc, t["s_img"], t["s_txt"],
                                                 b))
    attn = flops.attention_bound_s(b, t["s_img"] + t["s_txt"], 24, 128) \
        * flux.attention_calls(tc)
    out = {"denoise.mfu": 100.0 * f / (sum(steps) / len(steps))
           / flops.PEAK_BF16,
           "gemm_roofline": 100.0 * gemm * tr["steps_traced"]
           / tr["groups"]["gemm"]}
    for name, group in (("b12_roofline", "b12"), ("b3_roofline", "b3")):
        if tr["groups"].get(group):
            out[name] = 100.0 * attn * tr["steps_traced"] \
                / tr["groups"][group]
    return out


@pytest.mark.parametrize("name", FLUX_CELLS)
def test_moved_readers_read_as_before(name):
    cell = harness.Cell.load(BENCH, name)
    fields = _fields(name)
    got = run.per_layer(BENCH, cell, fields)
    want = _old_readings(cell, fields)
    listed = {m["name"] for m in run.cell_metrics(BENCH, name, trace=True)}
    assert set(want) & listed
    for k in set(want) & listed:
        assert got[k]["value"] == want[k], k
    assert not {"b4_roofline", "b7_roofline", "denoise.mfu.int8"} & set(got)


def test_int8_readers_take_the_int8_counts():
    cell = harness.Cell.load(BENCH, W8A8)
    fields = _fields("flux-dev.gen1024")
    fields["trace"]["groups"] = {"b4": 4.4, "b7": 2.4, "b12": 0.05,
                                 "other": 8.2}
    got = run.per_layer(BENCH, cell, fields)
    c = flux.counts(cell)
    assert got["b4_roofline"]["value"] == 100.0 * flops.gemm_bound_s(
        c["gemms"], flops.PEAK_INT8, in_bytes=1) * 10 / 4.4
    assert got["b7_roofline"]["value"] == 100.0 * (
        flops.i8_attention_bound_s(5, 5337, False, 24, 128) * 57) * 10 / 2.4
    f = flux.forward_flops(cell.config["sizes"]["transformer"], 4096, 1241, 5)
    attn = f["double_attn"] + f["single_attn"]
    assert got["denoise.mfu.int8"]["value"] == pytest.approx(
        100.0 * ((f["total"] - attn) / flops.PEAK_INT8
                 + attn / 2 / flops.PEAK_INT8 + attn / 2 / flops.PEAK_BF16)
        / 0.89252, rel=1e-12)
    assert 0 < got["denoise.mfu.int8"]["value"] < 100
    assert not {"denoise.mfu", "gemm_roofline", "b12_roofline"} & set(got)
