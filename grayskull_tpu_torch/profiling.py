"""Timing and profiling utilities for the card.

* :func:`sync` — wait for all work queued on a CUDA device;
* :func:`timeit` — steady-state seconds per call, timed with CUDA events;
* :func:`throughput` — frames/s and pixel rate of a batched call;
* :func:`hbm_bandwidth_gbps` — the device memory's copy and triad rates,
  from the port's own K17 ``copy`` and K18 ``triad`` kernels;
* :func:`trace` — a ``torch.profiler`` context that writes a Chrome trace.

The timers time the card only: without a CUDA device they raise rather than
time the CPU under a device metric's name.
"""

from __future__ import annotations

import contextlib
import os
import statistics

import torch

__all__ = ["hbm_bandwidth_gbps", "sync", "throughput", "timeit", "trace"]


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
    Chrome trace, under ``logdir``.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
