"""The closed loop that drives a cell's window.

A client keeps ``in_flight`` batches outstanding: it submits a batch (the
call into the port's entry, then an asynchronous copy of the batch's small
result to the host), and once ``in_flight`` batches are outstanding it waits
for the oldest, whose latency runs from the host's submit to its result
being on the host.  Batches are consecutive slices of the frame pool,
cycled.  The loop stops submitting when the window's time is up and then
drains what is outstanding: the window ends at the last completion.

A seeded reservoir keeps the whole outputs of ``check_batches`` batches of
the window, drawn uniformly over all of them, for the comparison after the
window closes.  With tracing on, the first ``trace_batches`` batches run
under ``torch.profiler`` and are drained before the window goes on; the
rest of the window, timed from there, runs untraced.
"""

from __future__ import annotations

import collections
import contextlib
import random
import time

import torch


class Window:
    """What a window did: per batch its pool slice, latency, host call time and
    host result; the reservoir of whole outputs; the trace of the traced batches."""

    def __init__(self):
        self.pool_index = []  # batch -> index of its pool slice
        self.latency_s = []  # batch -> submit to result on the host
        self.call_s = []  # batch -> host time inside the entry call
        self.results = []  # batch -> its small result, on the host
        self.kept = []  # (batch, whole outputs) of the reservoir
        self.traced = 0  # the profiled batches: 0 .. traced - 1
        self.profile = None  # the profiler of the traced batches
        self.seconds = 0.0  # first submit to last completion
        self.untraced_s = 0.0  # the profiler's end to the last completion
        self.frames = 0


class _Reservoir:
    def __init__(self, k, seed):
        self.k = k
        self.rng = random.Random(seed)
        self.items = []

    def offer(self, i, item):
        if len(self.items) < self.k:
            self.items.append((i, item))
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.items[j] = (i, item)


def run(call, result_key, pool, batch, in_flight, seconds, *, check_batches=0, seed=0,
        trace_batches=0, first_batch=0, max_batches=None):
    """Run ``call(frames)`` over ``pool`` in batches of ``batch`` for ``seconds``
    (or, with ``max_batches``, for that many batches).

    ``call`` returns a dict of device tensors; ``result_key`` names the small
    one read back.  ``first_batch`` is where the pool's cycle starts (the
    window goes on where the warm-up stopped).  Returns a :class:`Window`.
    """
    cuda = pool.is_cuda
    slices = pool.shape[0] // batch
    out = Window()
    reservoir = _Reservoir(check_batches, seed)
    ring = [None] * in_flight  # a host buffer a slot: reused only once its batch is done
    events = [torch.cuda.Event() if cuda else None for _ in range(in_flight)]
    pending = collections.deque()
    profile = None

    def complete():
        submitted, event, host = pending.popleft()
        if event is not None:
            event.synchronize()
        out.latency_s.append(time.perf_counter() - submitted)
        out.results.append(host.clone())

    if trace_batches:
        profile = _start_profile()
    t0 = untraced_t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while profile is not None or (time.perf_counter() < deadline if max_batches is None
                                  else i < max_batches):
        b = (first_batch + i) % slices
        frames = pool[b * batch:(b + 1) * batch]
        submitted = time.perf_counter()
        with _label(profile, "portbench.call"):
            outs = call(frames)
        called = time.perf_counter()
        with _label(profile, "portbench.readback"):
            small = outs[result_key]
            slot = i % in_flight
            if ring[slot] is None:
                ring[slot] = torch.empty(small.shape, dtype=small.dtype, pin_memory=cuda)
            ring[slot].copy_(small, non_blocking=cuda)
            event = events[slot]
            if event is not None:
                event.record()
        out.pool_index.append(b)
        out.call_s.append(called - submitted)
        pending.append((submitted, event, ring[slot]))
        if check_batches:
            reservoir.offer(i, outs)
        del outs, small
        i += 1
        session_done = profile is not None and i >= trace_batches
        with _label(profile, "portbench.wait"):
            while len(pending) >= in_flight or (session_done and pending):
                complete()
        if session_done:
            profile.stop()
            out.profile, out.traced, profile = _profile_or_none(profile), i, None
            untraced_t0 = time.perf_counter()
    while pending:
        complete()
    end = time.perf_counter()
    out.seconds, out.untraced_s = end - t0, end - untraced_t0
    out.frames = len(out.latency_s) * batch
    out.kept = sorted(reservoir.items, key=lambda item: item[0])
    return out


def _start_profile():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _profile_or_none(prof):
    """The stopped profiler if it recorded a device event, else None."""
    device = torch.autograd.DeviceType.CUDA
    return prof if any(e.device_type == device for e in prof.events()) else None


def _label(profile, name):
    """``torch.profiler.record_function(name)`` while profiling, else nothing."""
    if profile is None:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)
