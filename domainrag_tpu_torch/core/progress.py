"""Progress reporting (own copy of ``domainrag_tpu/core/progress.py``;
replaces the reference's multi-GPU monitor thread,
outpainting_updown_sampling_redux.py:333-401, and its tqdm/print mix).

One reporter per stage sweep: per-sample completions with rolling rate and
ETA, plus a final summary. Output goes through the framework logger so the
shell scripts' `.log` redirection pattern still works."""

from __future__ import annotations

import time
from typing import Optional

from .log import get_logger

logger = get_logger("domainrag_tpu_torch.progress")


class ProgressReporter:
    def __init__(self, total: int, label: str = "samples",
                 log_every: int = 1):
        self.total = total
        self.label = label
        self.log_every = max(log_every, 1)
        self.done = 0
        self.failed = 0
        self.start = time.perf_counter()

    def update(self, ok: bool = True, detail: Optional[str] = None) -> None:
        self.done += 1
        if not ok:
            self.failed += 1
        if self.done % self.log_every and self.done != self.total:
            return
        elapsed = time.perf_counter() - self.start
        rate = self.done / elapsed if elapsed > 0 else 0.0
        remaining = (self.total - self.done) / rate if rate > 0 else 0.0
        status = "ok" if ok else "FAILED"
        logger.info(
            "%s %d/%d (%s%s) %.2f %s/min, eta %.0fs%s",
            self.label, self.done, self.total, status,
            f": {detail}" if detail else "", rate * 60.0, self.label,
            remaining, f" [{self.failed} failed]" if self.failed else "")

    def summary(self) -> dict:
        elapsed = time.perf_counter() - self.start
        return {"total": self.total, "done": self.done,
                "failed": self.failed, "elapsed_s": elapsed,
                "per_min": self.done / elapsed * 60.0 if elapsed else 0.0}
