"""Structured logging — the port's copy of ``grayskull_tpu/structlog.py``, the
observability layer SURVEY.md §5 plans.

The reference's only observability is ``fprintf(stderr, ...)`` error prints
(nanomagick.c:62, 419-441) and printf result reports.  Here every event is
one JSON line with a wall-clock timestamp, an event name and free-form
fields, so production runs can be grepped/joined without parsing prose:

    from grayskull_tpu_torch import structlog
    structlog.event("scan.done", frames=64, latency_ms=45.4)
    with structlog.timed("orb.extract", frames=16):
        ...

Sink selection: the ``GS_LOG`` environment variable — a file path, ``-`` for
stderr, unset/empty disables logging entirely (zero overhead beyond one
``if``).  ``configure(path)`` overrides programmatically.  The CLI logs one
``cli.command`` event per invocation when enabled.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time

__all__ = ["configure", "enabled", "event", "timed"]

_lock = threading.Lock()
_sink = None
_configured = False


def configure(path: str | None):
    """Set the log sink: a file path, ``-`` for stderr, None disables."""
    global _sink, _configured
    with _lock:
        if _sink not in (None, sys.stderr):
            _sink.close()
        if not path:
            _sink = None
        elif path == "-":
            _sink = sys.stderr
        else:
            _sink = open(path, "a", buffering=1)
        _configured = True


def _ensure():
    if not _configured:
        configure(os.environ.get("GS_LOG") or None)
    return _sink


def enabled() -> bool:
    return _ensure() is not None


def event(name: str, **fields):
    """Emit one JSON line: {"ts": ..., "event": name, **fields}."""
    sink = _ensure()
    if sink is None:
        return
    rec = {"ts": round(time.time(), 6), "event": name}
    rec.update(fields)
    line = json.dumps(rec, default=str)
    with _lock:
        sink.write(line + "\n")


@contextlib.contextmanager
def timed(name: str, **fields):
    """Context manager emitting ``name`` with an ``elapsed_ms`` field."""
    if not enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        event(name, elapsed_ms=round((time.perf_counter() - t0) * 1e3, 3), **fields)
