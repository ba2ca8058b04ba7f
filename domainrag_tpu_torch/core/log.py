"""The framework logger, named wall-clock spans and the optional trace
of a run (own copy of ``domainrag_tpu/core/log.py``; :func:`maybe_trace`
is a ``torch.profiler`` trace where the JAX package takes a
``jax.profiler`` one).

While :func:`maybe_trace` traces, every :class:`StepTimer` span drains
the card as it opens and closes (where CUDA is initialised) and is a
``torch.profiler.record_function`` range, so the Chrome trace names the
stages' spans on the device clock. Outside a trace a span is two clock
readings and makes no torch call."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable, ContextManager, Dict, Iterator, Optional

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


_tracing = False          # set by maybe_trace for its body


def _sync_cuda() -> None:
    """Drain the card, where this process has started CUDA."""
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Accumulates named wall-clock spans. ``sync`` (e.g.
    ``torch.cuda.synchronize``) is called as each span opens and closes,
    so that a span holds the device work queued inside it; inside
    :func:`maybe_trace` a timer without one drains the card, and each
    span is also a ``record_function`` range of the trace."""

    def __init__(self, *, sync: Optional[Callable[[], None]] = None):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.sync = sync

    def span(self, name: str) -> ContextManager[None]:
        if _tracing:
            return self._traced(name)
        return self._timed(name, self.sync)

    @contextlib.contextmanager
    def _traced(self, name: str) -> Iterator[None]:
        import torch
        with torch.profiler.record_function(name):
            with self._timed(name, self.sync or _sync_cuda):
                yield

    @contextlib.contextmanager
    def _timed(self, name: str,
               sync: Optional[Callable[[], None]]) -> Iterator[None]:
        if sync is not None:
            sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync()
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
    ``trace_dir/trace.json``, with every :class:`StepTimer` span drained
    and annotated in it; does nothing when ``trace_dir`` is None."""
    global _tracing
    if trace_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    was, _tracing = _tracing, True
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        _tracing = was
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
