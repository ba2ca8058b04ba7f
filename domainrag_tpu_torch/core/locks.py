"""Cross-process synchronization for shared on-disk caches (own copy of
``domainrag_tpu/core/locks.py``).

Shared-cache writers take an ``flock`` on a sidecar lockfile and publish
atomically (tmp + rename), so concurrent workers either reuse a finished
cache or compute behind the lock — never read a torn file.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import tempfile
from typing import Iterator

import numpy as np


@contextlib.contextmanager
def file_lock(path: str) -> Iterator[None]:
    """Exclusive inter-process lock on ``{path}.lock`` (blocking)."""
    lock_path = path + ".lock"
    os.makedirs(os.path.dirname(lock_path) or ".", exist_ok=True)
    with open(lock_path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def atomic_save_npy(path: str, array: np.ndarray) -> None:
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npy.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.save(f, array)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def atomic_write_text(path: str, text: str) -> None:
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
