"""Double-buffered host-side prefetching (own copy of
``domainrag_tpu/core/prefetch.py``).

A background thread keeps a bounded queue of preprocessed items ahead of
the consumer, so PIL decode/resize overlaps the device's denoise loop;
the device step is seconds long, so one worker thread hides the IO.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_SENTINEL = object()


class PrefetchIterator(Iterator[U]):
    """Maps ``fn`` over ``items`` in a worker thread, ``depth`` items ahead.

    Exceptions raised by ``fn`` are re-raised at the consuming side, tagged
    with the item, so per-sample failure handling (manifests) still works.
    """

    def __init__(self, items: Iterable[T], fn: Callable[[T], U],
                 depth: int = 2):
        self._queue: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(list(items), fn), daemon=True)
        self._thread.start()

    def _worker(self, items, fn):
        for item in items:
            if self._stop.is_set():
                break
            try:
                result = (None, fn(item))
            except Exception as e:  # propagate to consumer
                result = (e, item)
            self._queue.put(result)
        self._queue.put(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self) -> U:
        out = self._queue.get()
        if out is _SENTINEL:
            raise StopIteration
        err, value = out
        if err is not None:
            # RETURN (not raise) the wrapped failure so consumers can do
            # per-item error handling without losing the rest of the stream
            wrapped = PrefetchError(value)
            wrapped.__cause__ = err
            return wrapped
        return value

    def close(self):
        self._stop.set()
        # drain so the worker can exit
        try:
            while self._queue.get_nowait() is not _SENTINEL:
                pass
        except queue.Empty:
            pass


class PrefetchError(RuntimeError):
    """Wraps a failure for one prefetched item; ``args[0]`` is the item."""

    @property
    def item(self):
        return self.args[0]


def prefetch(items: Iterable[T], fn: Callable[[T], U],
             depth: int = 2) -> PrefetchIterator:
    return PrefetchIterator(items, fn, depth)
