"""The benchmark's harness, reference and comparison on the CPU at the tiny
bundles' widths, and its one card-only case.

- every cell of BENCHMARK.json resolves to its files by name;
- the published-layout maker feeds the port's converters every key, at
  the shapes the port's inits give;
- a run of each cell's path prints a well-formed result line;
- the reference agrees with the port (float32 at tiny widths);
- the comparison fails under each fault a serving cell can have, a
  fault inside a block among them, and under the reference put in the
  program's place in float8;
- the import check compares whole top-level names.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from gpubench import check, harness, run, weights
from gpubench.families import flux
from gpubench.reference.ops import precision
from gpubench.tests.tiny import tiny_cell, tiny_config

torch.set_num_threads(1)
ROOT = harness.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]


def _cell_limits(fill: bool) -> dict:
    name = next(w["name"] for w in BENCH["workloads"]
                if ("fill" in w["config"]) == fill)
    return harness.load_json("cells", f"{name}.json")["limits"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card-only case runs on the chip")
    return "cuda"


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = harness.Cell.load(BENCH, name)
    assert {"prior_gap", "gemm_gap", "velocity_gap",
            "euler_gap"} <= set(cell.spec["limits"])
    assert flux._fill(cell) == ("encode_gap" in cell.spec["limits"])
    assert cell.config["reduced"] == []
    for m in run.cell_metrics(BENCH, name, trace=True):
        assert os.path.exists(os.path.join(ROOT, "gpubench", "metrics",
                                           f"{m['name']}.py"))
    names = {m["name"] for m in run.cell_metrics(BENCH, name, trace=False)}
    assert {"s_per_img", "peak_mem_gb", "setup_s"} <= names


@pytest.mark.parametrize("name", ["flux-dev", "flux-fill-dev"])
def test_frozen_layout_is_the_port_export(name):
    """The configuration file's key list is what the derivation gives
    today (the port's inits and export layouts at full width)."""
    with open(os.path.join(ROOT, "gpubench", "configs", f"{name}.json")) as f:
        frozen = json.load(f)
    fresh = flux.config_file(name)
    assert frozen["layout"] == json.loads(json.dumps(fresh["layout"]))
    assert frozen["sizes"] == json.loads(json.dumps(fresh["sizes"]))


class _Reads(dict):
    """A state dict that remembers which keys were read."""

    def __init__(self, comp):
        super().__init__({k: comp[k] for k in comp})
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


@pytest.mark.parametrize("fill", [False, True])
def test_maker_feeds_the_port_converters(fill):
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.models import clip, convert, redux, siglip, t5
    from domainrag_tpu_torch.models.common import leaves
    from domainrag_tpu_torch.models.flux import model as fm
    from domainrag_tpu_torch.models.flux import vae
    config = tiny_config(fill)
    cfgs = flux.port_configs(config)
    comps = weights.components(config, 3, "cpu")
    key = prng.PRNGKey(0, device="meta")
    cases = {
        "transformer": (lambda sd: convert.convert_flux_transformer(
            sd, cfgs["flux"], device="cpu"),
            fm.init(key, cfgs["flux"])),
        "vae": (lambda sd: convert.convert_flux_vae(sd, cfgs["vae"],
                                                    device="cpu"),
                vae.init(key, cfgs["vae"])),
        "t5": (lambda sd: t5.convert_hf_t5(sd, cfgs["t5"], device="cpu"),
               t5.init(key, cfgs["t5"])),
        "clip_text": (lambda sd: clip.convert_hf_clip_text(
            sd, cfgs["clip_text"], device="cpu"),
            clip.init_text(key, cfgs["clip_text"])),
        "siglip": (lambda sd: siglip.convert_hf_siglip(
            sd, cfgs["siglip"], device="cpu"),
            siglip.init(key, cfgs["siglip"])),
        "redux": (lambda sd: redux.convert_hf_redux(sd, device="cpu"),
                  redux.init(key, cfgs["redux"])),
    }
    for name, (convert_fn, template) in cases.items():
        sd = _Reads(comps[name])
        tree = convert_fn(sd)
        assert sd.read == set(sd), (name, set(sd) - sd.read)
        got = [tuple(t.shape) for t in leaves(tree)]
        want = [tuple(t.shape) for t in leaves(template)]
        assert sorted(got) == sorted(want), name


def test_group_draws_repeat_alone():
    config = tiny_config(False)
    a = weights.components(config, 11, "cpu")["transformer"]
    b = weights.components(config, 11, "cpu")["transformer"]
    c = weights.components(config, 12, "cpu")["transformer"]
    key = "single_transformer_blocks.1.proj_out.weight"
    x = a[key].clone()
    b.group("transformer_blocks.0")
    assert torch.equal(b[key], x)
    assert not torch.equal(c[key], x)
    assert float(x.std()) == pytest.approx(
        dict((e[0], e[4]) for e in config["layout"]["transformer"]
             ["single_transformer_blocks.1"])[key], rel=0.2)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("fill", [False, True])
def test_tiny_run_prints_a_result_line(fill, trace):
    cell = tiny_cell(fill, _cell_limits(fill))
    name = next(w["name"] for w in BENCH["workloads"]
                if ("fill" in w["config"]) == fill)
    cell.name = name
    fields, numbers = run.measure(cell, 21, 1e9, bool(trace), device="cpu",
                                  max_samples=1)
    line = json.loads(json.dumps(run.result_line(
        BENCH, cell, fields, numbers, bool(trace), "cpu", 1)))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    want = {m["name"] for m in run.cell_metrics(BENCH, name, bool(trace))}
    got = set(line["metrics"])
    if trace:
        # on the CPU no device kernel is traced: the device's readers
        # find nothing and stay silent
        assert {"stage.prior_s", "denoise.step_s", "denoise.mfu",
                "setup.weights_s"} <= got <= want
        assert "busy_s" in line["device"] and "breakdown" in line
    else:
        assert got == want
        assert line["metrics"]["s_per_img"]["value"] > 0


@pytest.mark.parametrize("tokens", [1024, 7])
@pytest.mark.parametrize("fill", [False, True])
def test_reference_agrees_with_the_port(fill, tokens):
    """Every token row of the sampled linears compared, or a sample of 7."""
    cell = tiny_cell(fill)
    cell.traffic["check_tokens"] = tokens
    _, numbers = run.measure(cell, 5, 1e9, False, device="cpu",
                               max_samples=1)
    assert numbers.pop("euler_gap") == 0.0
    assert max(numbers.values()) < 1e-5, numbers


def _faulty(monkeypatch, fault: str):
    """An answer altered where it is produced: its values rolled one token
    along the sequence (right values, wrong places). The velocity is
    altered in the batch's last row alone; the attention in every single
    block's call, or in every double block's."""
    from domainrag_tpu_torch.models.flux import model as fm
    from domainrag_tpu_torch.models.flux import pipeline as fp
    from domainrag_tpu_torch.models.flux import scheduler
    if fault == "state_unchanged":
        monkeypatch.setattr(scheduler, "euler_step",
                            lambda x, v, s, s1: x)
    elif fault == "velocity_altered":
        real = fm.apply

        def apply(*a, **k):
            v = real(*a, **k)
            return torch.cat([v[:-1], v[-1:].roll(1, dims=1)])
        monkeypatch.setattr(fm, "apply", apply)
    elif fault in ("single_attention_altered", "double_attention_altered"):
        name = "mmdit_" + fault.split("_")[0] + "_attention"
        real = getattr(fm, name)

        def attention(*a, **k):
            out = real(*a, **k)
            if isinstance(out, tuple):
                return tuple(o.roll(1, dims=1) for o in out)
            return out.roll(1, dims=1)
        monkeypatch.setattr(fm, name, attention)
    elif fault == "answer_altered":
        real = fm._final

        def final(*a, **k):
            return real(*a, **k).roll(1, dims=1)
        monkeypatch.setattr(fm, "_final", final)
    elif fault == "prior_altered":
        real = fp.redux_prior_pairs_indexed

        def prior(*a, **k):
            e, p = real(*a, **k)
            return e.roll(1, dims=1), p
        monkeypatch.setattr(fp, "redux_prior_pairs_indexed", prior)
    elif fault == "conditioning_altered":
        real = fp._fill_conditioning

        def cond(*a, **k):
            x, c = real(*a, **k)
            return x, c.roll(1, dims=1)
        monkeypatch.setattr(fp, "_fill_conditioning", cond)


# The Fill cell holds no limit on the single block's attention (its
# control reads under three times the sound runs), so a fault there is its
# velocity's to catch; at the tiny widths the velocity moves by 0.024
# under that fault, under the limit set for the full widths in bfloat16.
FAULTS = [(fill, fault) for fill in (False, True)
          for fault in ("state_unchanged", "velocity_altered",
                        "double_attention_altered", "answer_altered",
                        "prior_altered")] \
    + [(False, "single_attention_altered"), (True, "conditioning_altered")]


@pytest.mark.parametrize("fill,fault", FAULTS)
def test_a_fault_turns_correct_false(monkeypatch, fill, fault):
    """The timed path broken underneath, the rest of a run as it is: the
    cell's own limits see it. Every row is compared here, as in the
    stage-3 cell; the Fill cell compares a seeded sample of its rows."""
    limits = _cell_limits(fill)
    cell = tiny_cell(fill, limits)
    cell.traffic["check_rows"] = cell.batch
    _faulty(monkeypatch, fault)
    fields, numbers = run.measure(cell, 9, 1e9, False, device="cpu",
                                  max_samples=1)
    line = run.result_line(BENCH, cell, fields, numbers, False, "cpu", 1)
    assert line["correct"] is False, numbers


@pytest.mark.parametrize("fill", [False, True])
def test_float8_in_the_programs_place_fails(fill):
    """The control at a test's size: the reference one precision below
    the bfloat16 stages (float8 operands) in the program's place fails
    each of the cell's limits of the MMDiT (the velocity of every row,
    the sampled block's linears and, where the cell holds it, its
    attention) and, in the Fill cell, of the encode."""
    import tempfile
    limits = _cell_limits(fill)
    cell = tiny_cell(fill)
    seed = 4
    rec = flux.Recorder([0], rows=range(cell.batch), block=1)
    with tempfile.TemporaryDirectory() as tmp:
        samples = flux.make_samples(cell, seed, tmp, 1)
        stage = flux.make_stage(cell, flux.build_bundle(cell, seed, "cpu"))
        with rec:
            flux.run_sample(cell, stage, samples[0],
                            os.path.join(tmp, "out"),
                            harness.BenchTimer(device="cpu"))
        got = {}
        with torch.inference_mode():
            comps = weights.components(cell.config, seed, "cpu")
            control = flux._mmdit_control(cell, comps, rec, "cpu")
            if fill:
                for mode in ("f32", "fp8"):
                    with precision(mode):
                        got[mode] = flux.encode_reference(
                            cell, comps, samples[0], rec, "cpu")[0]
    held = {"velocity_gap", "gemm_gap", "attn_gap"} & set(limits)
    assert {"velocity_gap", "gemm_gap"} <= held
    for k in held:
        assert control[k] > limits[k], (k, control)
    if fill:
        assert check.rel_gap(got["fp8"], got["f32"]) > limits["encode_gap"]


def test_import_check_compares_whole_names(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "domainrag_tpu_torch_shadow",
                        types.ModuleType("domainrag_tpu_torch_shadow"))
    assert "domainrag_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "domainrag_tpu.stages",
                        types.ModuleType("domainrag_tpu.stages"))
    assert run.forbidden_modules() == ["domainrag_tpu"]


def test_the_run_path_loads_no_jax():
    code = ("import gpubench.run as r, gpubench.harness, gpubench.check, "
            "gpubench.trace, gpubench.control, gpubench.families.flux; "
            "import domainrag_tpu_torch.stages.generate, "
            "domainrag_tpu_torch.stages.compose, "
            "domainrag_tpu_torch.models.convert, domainrag_tpu_torch.cli.main; "
            "print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, gpubench.reference.flux, gpubench.reference.prior, "
            "gpubench.reference.vae, gpubench.weights, gpubench.counts.flops; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'domainrag_tpu_torch', 'domainrag_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [False, True])
def test_tiny_cell_on_the_card(cuda_device, fill):
    cell = tiny_cell(fill)
    _, numbers = run.measure(cell, 5, 1e9, False, device=cuda_device,
                               max_samples=1)
    assert numbers.pop("euler_gap") == 0.0
    assert max(numbers.values()) < 1e-4, numbers
