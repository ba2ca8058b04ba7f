"""A toy architecture, defined by files under ``gpubench/tests`` alone:
this module (its adapter and its "program"), and ``toy/config.json``,
``toy/traffic.json`` and ``toy/cell.json``. Its configuration names this
module as its family, so the harness runs it through the same functions
as a real family, with no edit to a file of the benchmark.

The program: a residual stack ``x <- x + dt * tanh(x @ w)`` over a batch
of token rows, one ``step`` span a step, float32 on the CPU. The check
compares the output of each recorded step with the same step in float64;
the control rounds the product's operands to bfloat16.
"""

from __future__ import annotations

import contextlib
import sys

import torch

from gpubench import harness
from gpubench.check import rel_gap


def _step(x: torch.Tensor, w: torch.Tensor, dt: float) -> torch.Tensor:
    return x + dt * torch.tanh(x @ w)


def make_samples(cell, seed, root, n):
    t, dim = cell.traffic, cell.config["sizes"]["dim"]
    gen = torch.Generator().manual_seed(seed)
    return [{"x": torch.randn(cell.batch, t["tokens"], dim, generator=gen)}
            for _ in range(n)]


def build_bundle(cell, seed, device):
    dim = cell.config["sizes"]["dim"]
    gen = torch.Generator().manual_seed(seed ^ 0x70F)
    return {"w": (torch.randn(dim, dim, generator=gen) / dim ** 0.5).to(
        device)}


def serving_modes(cell):
    if cell.modes:
        raise ValueError(f"the toy family has no serving modes: "
                         f"{cell.modes}")
    return contextlib.nullcontext()


def make_stage(cell, bundle):
    return bundle


def run_sample(cell, stage, sample, out_dir, timer):
    x = sample["x"].to(stage["w"].device)
    for _ in range(cell.traffic["steps"]):
        with timer.span("step"):
            x = _step(x, stage["w"], cell.traffic["dt"])
    return x


class Recorder(harness.Recorder):
    """Keeps every step's input and output."""

    def __init__(self):
        super().__init__()
        self.steps = []

    def patches(self):
        def step(real):
            def wrapped(x, w, dt):
                out = real(x, w, dt)
                self.steps.append((self._host(x), self._host(out)))
                return out
            return wrapped
        return [(sys.modules[__name__], "_step", step)]


def recorder(cell, seed):
    return Recorder()


def failed(rec):
    return sum(int(not torch.isfinite(out).all()) for _, out in rec.steps)


def _gap(cell, seed, rec, dtype):
    w = build_bundle(cell, seed, "cpu")["w"].double()
    dt = cell.traffic["dt"]
    return max(rel_gap(out, _step(x.double().to(dtype).double(),
                                  w.to(dtype).double(), dt))
               for x, out in rec.steps)


def compare(cell, seed, sample, rec, device):
    return {"step_gap": _gap(cell, seed, rec, torch.float64)}


def control(cell, seed, sample, rec, device):
    return {"step_gap": _gap(cell, seed, rec, torch.bfloat16)}


def counts(cell):
    t, dim = cell.traffic, cell.config["sizes"]["dim"]
    rows = cell.batch * t["tokens"]
    return {"forward_flops": 2 * rows * dim * dim,
            "gemms": [(rows, dim, dim, 1)]}
