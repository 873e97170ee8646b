"""Blob statistics, with their plain PyTorch version.

:func:`blob_stats` (K22, ``csrc/blobs.cu:gs_blob_stats``) replaces the
statistics of ``grayskull_tpu/ops/blobs.py:112 _aggregate_stats`` (XLA's
``segment_*`` ops on the CPU, a one-hot MXU contraction on the TPU; no Pallas
kernel): an ``(N, P)`` int32 label map of labels ``0 .. nseg - 1``, frames
``w`` pixels wide, rows counted from ``row0``, to seven ``(N, nseg)`` int64
tensors (area, sum_x, sum_y, min_x, min_y, max_x, max_y).  Label 0 is left
out: its area and sums are 0.  A label with no pixel reads 2^62 in the minima
and -1 in the maxima.  The sums are exact int64 (callers wrap them as C does).

Each block of the kernel keeps a table of every label in shared memory (36
bytes a label); where ``nseg`` labels do not fit a block's 227 KB, the same
kernel adds straight to the outputs with global atomics.  The wrapper picks
the path from ``nseg`` and counts it under its own key: ``launches["blob_stats"]``
or ``launches["blob_stats_global"]``, each the span ``gs.kernels.<key>``.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
:func:`blob_stats_plain`.  An empty batch launches nothing.
"""

from __future__ import annotations

import torch

from .. import profiling
from . import _build

__all__ = ["blob_stats", "blob_stats_plain", "launches", "path"]

launches = {"blob_stats": 0, "blob_stats_global": 0}

_EMPTY_MIN = 2**62  # the minima of a label with no pixel
_EMPTY_MAX = -1  # its maxima
_TABLE_BYTES_A_LABEL = 36  # csrc/blobs.cu: two 64-bit sums, five 32-bit fields
_SHARED_TABLE_BYTES = 232448  # 227 KB, the most shared memory a block has on Hopper


def blob_stats_plain(seg: torch.Tensor, nseg: int, w: int, row0: int = 0):
    """Plain version of :func:`blob_stats`: one ``scatter_add_`` or
    ``scatter_reduce_`` a statistic over the keys ``frame * nseg + label``."""
    n, npix = seg.shape
    dev = seg.device
    keys = (seg.to(torch.int64) + torch.arange(n, device=dev).view(n, 1) * nseg).view(-1)
    inside = (seg > 0).view(-1)
    pix = torch.arange(npix, device=dev, dtype=torch.int64)
    xs, ys = (pix % w).repeat(n), (pix // w + row0).repeat(n)
    ones = inside.to(torch.int64)

    def total(values):
        out = torch.zeros(n * nseg, dtype=torch.int64, device=dev)
        return out.scatter_add_(0, keys, values).view(n, nseg)

    def extreme(values, reduce, empty):
        out = torch.full((n * nseg,), empty, dtype=torch.int64, device=dev)
        vals = torch.where(inside, values, empty)
        return out.scatter_reduce_(0, keys, vals, reduce).view(n, nseg)

    return (total(ones), total(xs * ones), total(ys * ones),
            extreme(xs, "amin", _EMPTY_MIN), extreme(ys, "amin", _EMPTY_MIN),
            extreme(xs, "amax", _EMPTY_MAX), extreme(ys, "amax", _EMPTY_MAX))


def path(nseg: int) -> str:
    """The launch key of ``nseg`` labels: ``"blob_stats"`` where a block's
    table of them fits its shared memory, else ``"blob_stats_global"``."""
    if isinstance(nseg, bool) or not isinstance(nseg, int) or nseg < 1:
        raise ValueError(f"blob_stats: nseg must be an int >= 1, got {nseg!r}")
    fits = nseg * _TABLE_BYTES_A_LABEL <= _SHARED_TABLE_BYTES
    return "blob_stats" if fits else "blob_stats_global"


def _check(seg, w: int, row0: int) -> None:
    if not isinstance(seg, torch.Tensor):
        raise TypeError(f"blob_stats: expected a torch.Tensor, got {type(seg).__name__}")
    if seg.dtype != torch.int32:
        raise TypeError(f"blob_stats: expected int32 labels, got {seg.dtype}")
    if seg.ndim != 2:
        raise ValueError(f"blob_stats: expected an (N, P) label map, got shape {tuple(seg.shape)}")
    if not seg.is_contiguous():
        raise ValueError("blob_stats: the label map must be contiguous")
    npix = seg.shape[1]
    if w < 1 or npix % w:
        raise ValueError(f"blob_stats: {npix} pixels a frame are not whole rows of {w}")
    if npix >= 2**31 or row0 < 0 or row0 + npix // w >= 2**31:
        raise ValueError(f"blob_stats: rows {row0} .. {row0 + npix // w} of {w} pixels are out "
                         "of range")


def blob_stats(seg: torch.Tensor, nseg: int, w: int, row0: int = 0):
    """K22: (N, P) int32 labels -> (area, sum_x, sum_y, min_x, min_y, max_x,
    max_y), each (N, nseg) int64, as :func:`blob_stats_plain`."""
    key = path(nseg)
    with profiling.span("gs.kernels." + key):
        _check(seg, w, row0)
        if not seg.is_cuda:
            return blob_stats_plain(seg, nseg, w, row0)
        n, npix = seg.shape
        out = torch.empty((7, n, nseg), dtype=torch.int64, device=seg.device)
        if n == 0:
            return tuple(out.unbind(0))
        lib = _build.library()
        with torch.cuda.device(seg.device):
            code = lib.gs_blob_stats(seg.data_ptr(), out.data_ptr(), n, npix, w, row0, nseg,
                                     int(key == "blob_stats"), _build.stream_of(seg))
        _build.check(code, "blob_stats")
        launches[key] += 1
        return tuple(out.unbind(0))
