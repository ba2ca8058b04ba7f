"""One adapter per architecture: everything of a cell that depends on the
model it runs and on the program's entry points for it.

A configuration file names its family with the key ``"family"``: a module
of this package (``"flux"``, ``gpubench/families/flux.py``), or a dotted
module path. Where the key is absent the family is ``flux``.

The rest of the benchmark is family-neutral: ``harness.Cell`` (a cell's
files), ``harness.BenchTimer`` and ``harness.WindowClosed`` (the window's
clock), ``harness.Recorder`` (the base of a family's recorder), the
window, set-up and peak memory (``run.measure``), the trace reduction
(``trace.py``), the per-layer readers (``metrics/``, which read the
family's counts from ``ctx``), the result line and ``check.rel_gap``.

A new architecture is added by files alone: ``families/<family>.py`` with
the functions below, its float32 reference under ``reference/``, a
configuration ``configs/<config>.json`` naming the family, a traffic file,
a cell file of limits, and entries in ``BENCHMARK.json``.

The harness reads these keys of every traffic file: ``batch`` (images a
step; the window counts ``batch`` image-steps per ``step`` span),
``steps_per_image``, ``samples`` (how many are made; the window runs them
back to back, the first again after the last), ``warm_steps`` (the
warm-up sample is cut after that many steps) and, optionally, ``modes``
(the family's serving modes, ``Cell.modes``). The rest is the family's.

An adapter module defines:

``make_samples(cell, seed, root, n) -> list``
    ``n`` inputs of the cell's traffic made from ``seed``, as the
    program's entry point reads them (files under ``root``, which is
    deleted after the run).

``build_bundle(cell, seed, device) -> object``
    The program's model, built by the program's own loader from weights
    made on ``device`` from ``seed`` (``gpubench.weights``), prepared as
    the cell's modes say (quantized, say). Called inside
    ``serving_modes``; counted as set-up.

``serving_modes(cell)``
    A context manager: the program's process-wide switches for the
    cell's modes on for the block (set-up, warm-up and window), all off
    after it. Refuses a mode the family does not know.

``make_stage(cell, bundle) -> object``
    The program's entry point (a stage object) at the traffic's
    settings.

``run_sample(cell, stage, sample, out_dir, timer)``
    One input through the entry point, with the benchmark's
    ``BenchTimer`` as the program's timer: the program opens a ``step``
    span per denoise step, which is the window's clock, and the timer
    raises ``WindowClosed`` from it when the window closes.

``recorder(cell, seed) -> harness.Recorder``
    The recorder that the window's first sample runs under: it wraps the
    program's functions (``patches``) and keeps host copies of what the
    check compares at the steps, rows and layers drawn from ``seed``.

``failed(rec) -> int``
    The recorded outputs that hold a value not finite.

``compare(cell, seed, sample, rec, device) -> dict``
    The numbers compared (name -> float), once the program is freed: the
    recorded outputs against the float32 reference worked out again from
    ``sample`` and the weights drawn from ``seed``. The cell file's
    ``limits`` say which decide ``correct``.

``control(cell, seed, sample, rec, device) -> dict``
    The same numbers with the reference one precision below the
    program's put in its place (``control.py``; never in the
    benchmark's own runs).

``counts(cell) -> dict``
    Frozen operation counts of one denoise step's forward at the cell's
    sizes, put on the readers' ``ctx`` under their keys:
    ``forward_flops`` (FLOPs, a multiply-add 2), ``gemms`` (every linear
    as (M, K, N, calls)), ``attention_s`` (the least seconds of one bf16
    attention call on one H100), ``attention_calls`` (a forward's),
    ``i8_attention_s`` (of one int8 attention call, P.V as the modes
    say) and ``i8_forward_s`` (the forward's products at the int8 path's
    peaks). A family leaves out what it has no reader for.

``config_file(name) -> dict``
    The configuration file ``configs/<name>.json`` derived from the
    port's own inits and export layouts (``tools/derive_layout.py``).
"""

from __future__ import annotations

import importlib
from types import ModuleType

DEFAULT = "flux"


def adapter(config: dict) -> ModuleType:
    """The adapter module of the configuration's family."""
    name = config.get("family", DEFAULT)
    return importlib.import_module(name if "." in name
                                   else f"{__name__}.{name}")
