"""Reduce a ``torch.profiler`` session of a window's traced batches.

The device's busy time is the union of its events (kernels, copies, fills;
not the device-side copies of the host's spans) inside the traced window,
which runs from the host's first submit to its last wait (the
``portbench.call`` and ``portbench.wait`` spans, on the trace's own
clock).  An idle gap is a stretch of that window with no device event;
each is named by what the host was doing at its middle: the ``portbench``
span and the innermost PyTorch op there.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

import torch

_NAME = 100  # characters of a kernel's name kept in the breakdown
_TOP = 10


@dataclasses.dataclass
class Trace:
    """A traced window: ``device_events`` as ``(name, seconds)``, ``op_device_s``
    (self device seconds by PyTorch op), ``busy_s``, ``window_s`` and
    ``breakdown``; ``batches`` is how many batches ran in it."""

    device_events: list
    op_device_s: dict
    busy_s: float
    window_s: float
    breakdown: dict
    batches: int


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


class _Cover:
    """The innermost of a set of host events that covers a time."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: e[1])
        self.starts = [e[1] for e in self.events]

    def at(self, t, reach=256):
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - reach, -1), -1):
            name, start, end = self.events[j]
            if end > t:
                return name
        return None


def _self_device_us(avg):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(avg, attr, None)
        if value is not None:
            return value
    return 0.0


def summarize(prof, batches) -> Trace | None:
    """The :class:`Trace` of a stopped profiler over ``batches`` batches, or
    None when it holds no device event."""
    device = torch.autograd.DeviceType.CUDA
    dev, spans, ops = [], [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == device:
            if not (e.name.startswith("portbench.") or getattr(e, "is_user_annotation", False)):
                dev.append((e.name, start, end))  # not the device's copy of a host span
        elif e.name.startswith("portbench."):
            spans.append((e.name, start, end))
        elif e.name.startswith("aten::"):
            ops.append((e.name, start, end))
    if not dev or not spans:
        return None
    lo = min(s for name, s, _ in spans if name == "portbench.call")
    hi = max(e for name, _, e in spans if name == "portbench.wait")
    dev = [(name, s, e) for name, s, e in dev if e > lo and s < hi]
    busy = _union([(max(s, lo), min(e, hi)) for _, s, e in dev])
    busy_us = sum(e - s for s, e in busy)

    span_at, op_at = _Cover(spans), _Cover(ops)
    gaps = collections.Counter()
    edges = [lo] + [t for s, e in busy for t in (s, e)] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            gaps[f"{span_at.at(mid) or 'python'}/{op_at.at(mid) or '-'}"] += (b - a) / 1e6
    by_kernel = collections.Counter()
    for name, s, e in dev:
        by_kernel[name[:_NAME]] += (e - s) / 1e6
    op_device_s = {a.key: _self_device_us(a) / 1e6 for a in prof.key_averages()
                   if _self_device_us(a) > 0}
    breakdown = {"device_ops": [[k, v] for k, v in by_kernel.most_common(_TOP)],
                 "idle_gaps": [[k, v] for k, v in gaps.most_common(_TOP)]}
    return Trace([(name, (e - s) / 1e6) for name, s, e in dev], op_device_s, busy_us / 1e6,
                 (hi - lo) / 1e6, breakdown, batches)
