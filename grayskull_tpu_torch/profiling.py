"""Timing utilities for the card.

* :func:`sync` — wait for all work queued on a CUDA device;
* :func:`timeit` — steady-state seconds per call, timed with CUDA events.

These time the card only: without a CUDA device they raise rather than time the
CPU under a device metric's name.
"""

from __future__ import annotations

import statistics

import torch

__all__ = ["sync", "timeit"]


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

