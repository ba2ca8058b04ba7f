"""Graceful SIGINT/SIGTERM handling (own copy of
``domainrag_tpu/core/interrupt.py``; reference A6: the retrieval script's
signal handlers let a sweep finish the in-flight sample and save partial
results — retrieval/clip100_resnet_style_all_shots.py:27-41).

Stages check ``should_stop()`` between samples; manifests already persist
per-sample, so a stop is always resumable."""

from __future__ import annotations

import signal
import threading
from contextlib import contextmanager

_stop_event = threading.Event()


def should_stop() -> bool:
    return _stop_event.is_set()


def request_stop(*_args) -> None:
    _stop_event.set()


def reset() -> None:
    _stop_event.clear()


@contextmanager
def graceful_interrupts():
    """Install SIGINT/SIGTERM handlers that set the stop flag instead of
    killing the process; restore previous handlers on exit."""
    previous = {}
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            previous[sig] = signal.signal(sig, request_stop)
        except ValueError:  # non-main thread
            pass
    try:
        yield
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        reset()
