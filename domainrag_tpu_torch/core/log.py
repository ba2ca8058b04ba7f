"""Named wall-clock spans (own copy of ``domainrag_tpu/core/log.py``'s
``StepTimer``)."""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, Optional


class StepTimer:
    """Accumulates named wall-clock spans. ``sync`` (e.g.
    ``torch.cuda.synchronize``) is called as each span opens and closes,
    so that a span holds the device work queued inside it."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
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
