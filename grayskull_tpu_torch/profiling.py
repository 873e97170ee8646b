"""Timing and profiling utilities for the card.

* :func:`sync` — wait for all work queued on a CUDA device;
* :func:`timeit` — steady-state seconds per call, timed with CUDA events;
* :func:`throughput` — frames/s and pixel rate of a batched call;
* :func:`hbm_bandwidth_gbps` — the device memory's copy and triad rates,
  from the port's own K17 ``copy`` and K18 ``triad`` kernels;
* :func:`trace` — a ``torch.profiler`` context that writes a Chrome trace;
* :func:`span`, :func:`spanned` — a named interval of the port's host path
  (``gs.<layer>.<name>``), recorded only while a profiler session records;
  :func:`spans` and :func:`clear_spans` read and empty their store.

The timers time the card only: without a CUDA device they raise rather than
time the CPU under a device metric's name.

Spans mark the port's layer boundaries: ``gs.pipelines.*`` (an entry call),
``gs.ops.*`` and ``gs.kernels.<key>`` (a kernel wrapper, named by its
``launches`` key).  With no profiler session a span costs one read of the
profiler's flag.  Inside one (``torch.profiler.profile``, :func:`trace`) each
span is a ``record_function`` range, on the profiler's timeline beside the
aten ops and the device events, and a :class:`Span` in a bounded store, on
``time.perf_counter_ns``'s clock.  Spans nest by a stack a thread; the spans
under one outermost span share its ``call`` id.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import statistics
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["Span", "clear_spans", "hbm_bandwidth_gbps", "span", "spanned", "spans", "sync",
           "throughput", "timeit", "trace"]

SPAN_STORE = 1 << 16  # spans kept, the newest


class Span(NamedTuple):
    """One closed span: ``start_ns``/``end_ns`` on ``time.perf_counter_ns``;
    ``parent`` the enclosing span's ``id`` (None for an outermost span) and
    ``call`` the outermost span's ``id``."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    call: int


_store = collections.deque(maxlen=SPAN_STORE)
_ids = itertools.count(1)
_open = threading.local()  # .stack: the thread's open spans, innermost last


_NULL = contextlib.nullcontext()  # every span of a call with no profiler session


class _Span:
    __slots__ = ("name", "id", "parent", "call", "start_ns", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        outer = stack[-1] if stack else None
        self.parent, self.call = (None, self.id) if outer is None else (outer.id, outer.call)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        try:
            self._range.__exit__(*exc)
        finally:
            _open.stack.pop()
            _store.append(Span(self.name, self.start_ns, end, self.id, self.parent, self.call))
        return False


def span(name: str):
    """``with span("gs.ops.blobs.stats"): ...`` — the block as a span while a
    profiler session records, else the shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def spanned(name: str):
    """``@spanned("gs.kernels.ccl")`` — each call of the function as :func:`span` ``(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def spans() -> list[Span]:
    """The stored spans, oldest first (each stored when it closes, so a child
    comes before its parent)."""
    return list(_store)


def clear_spans() -> None:
    _store.clear()


def sync(device=None) -> None:
    """Block until every kernel queued on ``device`` (default: current) has finished."""
    torch.cuda.synchronize(device)


def timeit(fn, *args, iters: int = 20, warmup: int = 2, repeat: int = 3, **kwargs) -> float:
    """Median over ``repeat`` windows of the mean seconds per call of ``fn(*args)``.

    Each window queues ``iters`` calls between two CUDA events on the current
    stream, after ``warmup`` calls and a synchronize.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA device")
    for _ in range(max(warmup, 1)):
        fn(*args, **kwargs)
    sync()
    windows = []
    for _ in range(max(repeat, 1)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args, **kwargs)
        end.record()
        end.synchronize()
        windows.append(start.elapsed_time(end) / 1e3 / iters)
    return statistics.median(windows)


def throughput(fn, batch, iters: int = 10, warmup: int = 2) -> dict:
    """Frames/s and pixel rate of ``fn(batch)`` on an (N, H, W) batch, timed by :func:`timeit`."""
    dt = timeit(fn, batch, iters=iters, warmup=warmup)
    n = batch.shape[0]
    pixels = batch.numel()
    return {"sec_per_batch": dt, "frames_per_sec": n / dt, "gpix_per_sec": pixels / dt / 1e9}


def hbm_bandwidth_gbps(mbytes: int = 256, iters: int = 20) -> dict:
    """The device memory's measured rate (GB/s) under K17 ``copy`` and K18
    ``triad``, the roofline's denominator measured on the card at hand.

    The operands are ``(mbytes * 2^20 / 2^19, 512, 1024)`` uint8, the JAX
    probe's shape; ``copy_gbps`` counts 2 bytes a byte, ``triad_gbps`` 3.
    Returns ``{"copy_gbps": ..., "triad_gbps": ...}``.  With no CUDA device it
    raises, as :func:`timeit` does: the JAX version returns ``{}`` off the TPU,
    but an empty result is easily read as a measurement that happened.
    """
    from .kernels.bandwidth import copy, triad

    if not torch.cuda.is_available():
        raise RuntimeError("hbm_bandwidth_gbps needs a CUDA device")
    h, w = 512, 1024
    n = int(mbytes) * 2**20 // (h * w)
    if n < 1:
        raise ValueError(f"hbm_bandwidth_gbps: mbytes must be >= 0.5, got {mbytes}")
    x = torch.ones((n, h, w), dtype=torch.uint8, device="cuda")
    y = copy(x)
    nbytes = x.numel()
    dt_copy = timeit(copy, x, iters=iters)
    dt_triad = timeit(triad, x, y, iters=iters)
    return {"copy_gbps": 2 * nbytes / dt_copy / 1e9, "triad_gbps": 3 * nbytes / dt_triad / 1e9}


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace("/tmp/tb"): ...`` profiles the block with ``torch.profiler``
    (the CPU, and the card when there is one) and writes ``trace.json``, a
    Chrome trace with the port's ``gs.`` spans, under ``logdir``.  Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
