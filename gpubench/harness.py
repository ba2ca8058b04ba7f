"""What every cell shares, whatever its architecture: a cell's files by
name, the timer the program's entry point is handed, and the base of the
recorder that copies what the check compares. The rest of a cell (its
inputs, the program's model and entry point, the comparison, the counts)
is its family's adapter's (``gpubench.families``).

The timer synchronises the device at each of the program's spans,
records every span, and closes the window at the first denoise step that
ends after the deadline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import time
from typing import List, Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class WindowClosed(Exception):
    """Raised by the timer at the first step that ends past the deadline."""


def load_json(*parts) -> dict:
    with open(os.path.join(ROOT, "gpubench", *parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict          # gpubench/cells/<name>.json
    config: dict        # gpubench/configs/<config>.json
    traffic: dict       # gpubench/traffic/<traffic>.json

    @classmethod
    def load(cls, bench: dict, name: str) -> "Cell":
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        spec = load_json("cells", f"{name}.json")
        conf = next(c for c in bench["configs"]
                    if c["name"] == entry["config"])
        with open(os.path.join(ROOT, conf["file"])) as f:
            config = json.load(f)
        return cls(name, spec, config,
                   load_json("traffic", f"{entry['traffic']}.json"))

    @property
    def family(self):
        """The adapter module of the configuration's family."""
        from . import families
        return families.adapter(self.config)

    @property
    def batch(self) -> int:
        return self.traffic["batch"]

    @property
    def modes(self) -> tuple:
        """The serving modes the traffic file names (none by default)."""
        return tuple(self.traffic.get("modes", ()))


class BenchTimer:
    """The stages' ``timer``: every span synchronised and recorded; the
    window closes at the first ``step`` that ends at or past
    ``deadline`` (or after ``max_steps``, for the warm-up)."""

    def __init__(self, deadline: float = float("inf"),
                 max_steps: Optional[int] = None, annotate: bool = False,
                 device: str = "cuda"):
        self.deadline, self.max_steps = deadline, max_steps
        self.cuda = torch.device(device).type == "cuda"
        self.annotate = annotate
        self.spans: List[tuple] = []      # (name, start, end)
        self.steps = 0

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        ctx = (torch.profiler.record_function(name) if self.annotate
               else contextlib.nullcontext())
        with ctx:
            yield
            self.sync()
        t1 = time.perf_counter()
        self.spans.append((name, t0, t1))
        if name == "step":
            self.steps += 1
            if t1 >= self.deadline or self.steps == self.max_steps:
                raise WindowClosed


class Recorder:
    """Wraps functions of the program while the window's first sample
    runs, keeping host copies of what they are given and what they
    return; a family's recorder lists them in ``patches``. The program's
    arithmetic is untouched. The copies' seconds are counted in
    ``seconds``: the device is drained before each, so they are the
    copies' own."""

    def __init__(self):
        self.seconds = 0.0
        self._saved = []

    def _host(self, x):
        if not torch.is_tensor(x):
            return x
        if x.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = x.detach().to("cpu", copy=True)
        self.seconds += time.perf_counter() - t0
        return out

    def patches(self) -> list:
        """[(module, name, wrapper)]: ``wrapper(real)`` takes the place of
        ``module.name`` inside the block."""
        raise NotImplementedError

    def _patch(self, module, name, wrapper):
        real = getattr(module, name)
        self._saved.append((module, name, real))
        setattr(module, name, wrapper(real))

    def __enter__(self):
        for module, name, wrapper in self.patches():
            self._patch(module, name, wrapper)
        return self

    def __exit__(self, *exc):
        for module, name, real in reversed(self._saved):
            setattr(module, name, real)
        self._saved = []


def free_program():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
