"""Run one cell of the benchmark once: set-up, warm-up, the measured
window, the check against the float32 reference, one JSON result line.

    python -m gpubench.run --workload flux-dev.gen1024 --seed 7 \\
        --seconds 45 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a ``torch.profiler`` trace of the same window.
Every number compared is printed beside its limit, last on standard
error and last in the result line (``checks``).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "domainrag_tpu")


def _environment():
    """Caches at fixed paths inside the checkout; no library may reach
    for JAX or the network."""
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    for k, v in (("USE_FLAX", "0"), ("USE_JAX", "0"), ("USE_TF", "0"),
                 ("HF_HUB_OFFLINE", "1"), ("TRANSFORMERS_OFFLINE", "1")):
        os.environ[k] = v


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _reader(name: str):
    path = os.path.join(ROOT, "gpubench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports in this kind of run."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def measure(cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda", controls: bool = False,
            max_samples: Optional[int] = None):
    """One run; returns (result fields, the numbers compared). With
    ``controls`` the fields also hold the controls' readings (the
    family's ``control``); ``max_samples`` closes the window after that
    many samples (the CPU tests' runs), where the deadline has not."""
    import torch
    from . import harness
    from . import trace as trace_mod

    fam = cell.family
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak():
        return torch.cuda.max_memory_allocated() if cuda else 0

    t = cell.traffic
    tmp = tempfile.mkdtemp(prefix="gpubench-", dir=os.environ.get("TMPDIR"))
    try:
        t_in = time.perf_counter()
        samples = fam.make_samples(cell, seed, tmp, t["samples"])
        sync()
        out_dir = os.path.join(tmp, "out")
        t_w = time.perf_counter()
        with fam.serving_modes(cell):
            bundle = fam.build_bundle(cell, seed, device)
            sync()
            setup = {"start_s": t_in - T0, "inputs_s": t_w - t_in,
                     "weights_s": time.perf_counter() - t_w}
            stage = fam.make_stage(cell, bundle)
            try:
                fam.run_sample(cell, stage, samples[0], out_dir,
                               harness.BenchTimer(max_steps=t["warm_steps"],
                                                  device=device))
            except harness.WindowClosed:
                pass
            sync()
            setup["warm_s"] = time.perf_counter() - t_w - setup["weights_s"]
            setup_peak = peak()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            setup_s = time.perf_counter() - T0

            rec = fam.recorder(cell, seed)
            spans = []
            prof = None
            if trace:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CPU]
                               + [ProfilerActivity.CUDA] * cuda)
            # the profiler starts (CUPTI's set-up takes seconds) before the
            # window opens
            with prof if prof is not None else contextlib.nullcontext():
                start = time.perf_counter()
                deadline = start + seconds
                # samples back to back, the first again after the last
                for i, sample in enumerate(itertools.islice(
                        itertools.cycle(samples), max_samples)):
                    timer = harness.BenchTimer(deadline=deadline,
                                               annotate=trace, device=device)
                    closed = False
                    try:
                        with rec if i == 0 else contextlib.nullcontext():
                            fam.run_sample(cell, stage, sample, out_dir,
                                           timer)
                    except harness.WindowClosed:
                        closed = True
                    spans += timer.spans
                    if closed:
                        break
                sync()
                stop = time.perf_counter()
            window_peak = peak()
        done = [b for name, a, b in spans if name == "step" and b <= deadline]
        if not done:
            raise RuntimeError("no denoise step completed in the window")
        image_steps = len(done) * cell.batch
        window = max(done) - start
        fields = {
            "s_per_img": window * t["steps_per_image"] / image_steps,
            "peak_mem_gb": window_peak / 1e9,
            "setup_s": setup_s,
            "attempted": image_steps,
            "memory_peak_bytes": max(setup_peak, window_peak),
            "spans": spans, "setup": setup,
        }
        if prof is not None:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            fields["trace"] = trace_mod.reduce_trace(path, stop - start)
            os.remove(path)
        del stage, bundle
        harness.free_program()
        t_ref = time.perf_counter()
        numbers = fam.compare(cell, seed, samples[0], rec, device)
        log(f"set-up {setup_s:.3f} s ("
            + ", ".join(f"{k} {v:.3f}" for k, v in setup.items()) + "); "
            f"window {window:.3f} s, {len(done)} steps of batch "
            f"{cell.batch}; spans "
            + ", ".join(f"{k} {v['total_s']:.3f} s / {v['count']}"
                        for k, v in _totals(spans).items())
            + f"; recorder {rec.seconds:.3f} s in the window"
            + f"; reference {time.perf_counter() - t_ref:.3f} s; numbers "
            + json.dumps(numbers))
        if controls:
            fields["control"] = fam.control(cell, seed, samples[0], rec,
                                            device)
        fields["failed"] = fam.failed(rec)
        return fields, numbers
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def log(msg: str) -> None:
    print(f"gpubench: {msg}", file=sys.stderr, flush=True)


def _totals(spans) -> dict:
    out = {}
    for name, a, b in spans:
        e = out.setdefault(name, {"total_s": 0.0, "count": 0})
        e["total_s"] += b - a
        e["count"] += 1
    return out


def per_layer(bench, cell, fields) -> dict:
    """The cell's per-layer metrics. Each reader's ``ctx`` carries the
    window's synchronised spans, the reduced trace, the set-up's timings
    and the family's counts of one forward (``counts``)."""
    ctx = types.SimpleNamespace(
        spans=fields["spans"], trace=fields.get("trace"),
        setup=fields["setup"], **cell.family.counts(cell))
    out = {}
    for m in cell_metrics(bench, cell.name, trace=True):
        value = _reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(bench, cell, fields, numbers, trace: bool, kind: str,
                count: int) -> dict:
    """The run's result: the keys the benchmark's contract names, and the
    numbers compared beside their limits last."""
    limits = cell.spec["limits"]
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    if trace:
        metrics = per_layer(bench, cell, fields)
    else:
        metrics = {m["name"]: {"value": fields[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, cell.name, trace=False)}
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": fields["memory_peak_bytes"]}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": fields["attempted"], "failed": fields["failed"],
              "metrics": metrics, "device": device}
    tr = fields.get("trace")
    if tr is not None:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    from .harness import Cell
    cell = Cell.load(bench, args.workload)
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    fields, numbers = measure(cell, args.seed, args.seconds,
                              bool(args.trace))

    bad = forbidden_modules()
    if bad:
        print(f"gpubench: loaded modules {bad}: the run may not load JAX "
              f"or the JAX package", file=sys.stderr)
        return 3
    result = result_line(bench, cell, fields, numbers, bool(args.trace),
                         torch.cuda.get_device_name(0), chips)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
