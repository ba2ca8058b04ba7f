"""Per-sample status manifest (own copy of
``domainrag_tpu/core/manifest.py``).

Replaces the reference's log-text-parsing resume
(``outpainting_updown_sampling_redux.py:1949-1993``: grepping its own stdout
for success/failure lines) with an explicit, atomically-updated JSON manifest.
Supports ``--resume`` (skip done), ``--failed_only`` (re-run failures) and
multi-process namespacing via ``process_id``
(ref ``:140-148,831,2064-2094``).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, Iterable, List, Optional

STATUS_PENDING = "pending"
STATUS_RUNNING = "running"
STATUS_DONE = "done"
STATUS_FAILED = "failed"


class Manifest:
    """A JSON file mapping sample key -> {status, error, timings, outputs}."""

    def __init__(self, path: str, process_id: str = "0"):
        self.path = path
        self.process_id = str(process_id)
        self._entries: Dict[str, dict] = {}
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
            self._entries = data.get("samples", {})

    # -- queries ---------------------------------------------------------
    def status(self, key: str) -> str:
        return self._entries.get(key, {}).get("status", STATUS_PENDING)

    def entry(self, key: str) -> dict:
        return dict(self._entries.get(key, {}))

    def keys_with_status(self, status: str) -> List[str]:
        return sorted(k for k, v in self._entries.items()
                      if v.get("status") == status)

    def pending(self, all_keys: Iterable[str],
                resume: bool = False,
                failed_only: bool = False) -> List[str]:
        """Which of ``all_keys`` still need work.

        - ``failed_only``: only previously-failed keys (ref ``--failed_only``).
        - ``resume``: skip keys already done (ref ``--resume``).
        - neither: everything.
        """
        keys = list(all_keys)
        if failed_only:
            failed = set(self.keys_with_status(STATUS_FAILED))
            return [k for k in keys if k in failed]
        if resume:
            return [k for k in keys if self.status(k) != STATUS_DONE]
        return keys

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for v in self._entries.values():
            s = v.get("status", STATUS_PENDING)
            out[s] = out.get(s, 0) + 1
        return out

    # -- updates ---------------------------------------------------------
    def mark(self, key: str, status: str,
             error: Optional[str] = None,
             outputs: Optional[dict] = None,
             elapsed_s: Optional[float] = None) -> None:
        entry = self._entries.setdefault(key, {})
        entry["status"] = status
        entry["process_id"] = self.process_id
        entry["updated_at"] = time.time()
        if error is not None:
            entry["error"] = error
        if outputs is not None:
            entry["outputs"] = outputs
        if elapsed_s is not None:
            entry["elapsed_s"] = elapsed_s
        self.save()

    def save(self) -> None:
        """Atomic write: tmp file + rename, so concurrent readers never see
        a torn manifest (the reference had last-writer-wins races on shared
        caches, retrieval/...py:644-646)."""
        directory = os.path.dirname(self.path) or "."
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump({"process_id": self.process_id,
                           "samples": self._entries}, f, indent=2)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
