"""The framework logger, named wall-clock spans and the optional trace
of a run (own copy of ``domainrag_tpu/core/log.py``; :func:`maybe_trace`
is a ``torch.profiler`` trace where the JAX package takes a
``jax.profiler`` one)."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable, Dict, Iterator, Optional

_FORMAT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"


def get_logger(name: str = "domainrag_tpu_torch",
               log_file: Optional[str] = None,
               level: int = logging.INFO) -> logging.Logger:
    """A logger that writes to stderr (one handler per name, its level set
    when that handler is added), and also to ``log_file`` when given."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(level)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    return logger


class StepTimer:
    """Accumulates named wall-clock spans. ``sync`` (e.g.
    ``torch.cuda.synchronize``) is called as each span opens and closes,
    so that a span holds the device work queued inside it."""

    def __init__(self, *, sync: Optional[Callable[[], None]] = None):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.sync = sync

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if self.sync is not None:
            self.sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            dt = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, dict]:
        """``{name: {total_s, count, mean_s}}`` over the spans so far."""
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_s": self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace (host and, where a card is visible, CUDA
    activity) of the body, written as a Chrome trace
    ``trace_dir/trace.json``; does nothing when ``trace_dir`` is None."""
    if trace_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
