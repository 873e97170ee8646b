"""Moore-neighbour contour tracing — ``gs_trace_contour`` (grayskull.h:446-480)
and the multi-contour entry points of ``grayskull_tpu.ops.contour``, bit-exact with
them.

Every walk of a call runs in one K20 ``contour`` launch (a CUDA frame) or its
plain version (a CPU frame); ``largest_blob_contour`` and ``find_contours``
label the frame with :func:`~.blobs.blobs` (K9 ``ccl``) first.  Semantics kept
from the reference and the JAX package:

* 8 directions clockwise from East; the scan starts at ``(dir + 1) % 8`` and
  turns back to ``(sel + 6) % 8``;
* foreground is ``pixel > 128`` (strictly: blobs use ``>= 128``);
* ``length`` counts the pixels whose mask byte was 0; a walk stops at a dead
  end, at the second arrival at its start, or after ``4 * h * w + 8`` steps;
  the box updates in C's statement order.

Each entry point takes one ``(H, W)`` frame, as the JAX functions do, and
runs without a host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import Contour, Point, Rect, as_image, as_tensor
from ..kernels.contour import contour
from .blobs import blobs

__all__ = ["Contours", "find_contours", "largest_blob_contour", "trace_contour"]


class Contours(NamedTuple):
    """Fixed-capacity contour table (multi-contour extraction).

    Rows ``[0, n)`` are valid, in blob creation order (starts already covered
    by an earlier trace are skipped through the shared visited mask); rows
    past ``n`` are 0.  ``n`` is a 0-d int32 tensor, the fields of ``box``,
    ``start`` and ``length`` ``(cap,)`` int32, ``visited`` the ``(H, W)``
    uint8 union of every traced contour.
    """

    n: torch.Tensor
    box: Rect
    start: Point
    length: torch.Tensor
    visited: torch.Tensor


def _frame(img) -> torch.Tensor:
    img = as_image(img)
    if img.ndim != 2:
        raise ValueError(f"expected one (H, W) frame, got shape {tuple(img.shape)}")
    return img.contiguous()


def _contour(rows: torch.Tensor, visited: torch.Tensor) -> Contour:
    bx, by, bw, bh, sx, sy, length = rows[:, 0]
    return Contour(box=Rect(bx, by, bw, bh), start=Point(sx, sy), length=length, visited=visited)


def trace_contour(img, start, visited=None) -> Contour:
    """Trace one contour from ``start = (x, y)``.  Returns a :class:`Contour`
    with the box, length and the updated visited mask (255 at visited pixels).

    ``visited`` ((H, W) uint8) may carry state across calls, matching the
    reference's caller-provided mask; it is copied, not changed.  Any non-zero
    byte counts as visited and keeps its value.  A visited start is still
    walked.
    """
    img = _frame(img)
    if visited is None:
        vis = torch.zeros(img.shape, dtype=torch.uint8, device=img.device)
    else:
        given = as_tensor(visited)
        if given.dtype != torch.uint8:
            raise TypeError(f"the visited mask must be uint8, got {given.dtype}")
        vis = given.to(img.device, non_blocking=True).clone(memory_format=torch.contiguous_format)
    rows, _, _ = contour(img, vis, start=start)
    return _contour(rows, vis)


def largest_blob_contour(img, max_blobs: int = 50):
    """Trace the largest blob's contour — the WASM demo's
    ``gs_detect_largest_blob_contour`` (examples/wasm/grayskull.c:278-326):
    label blobs, pick the largest by area (first max wins), reject areas under
    100, start from the blob's first raster pixel, trace on a fresh mask.

    Returns ``(Contour, found)``, ``found`` a 0-d bool tensor; when it is False
    the contour is the zero contour with an all-zero mask.
    """
    img = _frame(img)
    if int(max_blobs) < 1:
        raise ValueError(f"max_blobs must be >= 1 to pick a largest blob, got {max_blobs}")
    table, label_map, _ = blobs(img, int(max_blobs))
    vis = torch.zeros(img.shape, dtype=torch.uint8, device=img.device)
    rows, found, _ = contour(img, vis, table=table, label_map=label_map, largest=True)
    return _contour(rows, vis), found


def find_contours(img, max_contours: int = 16, max_blobs: int = 64) -> Contours:
    """Trace every blob's outer contour with a shared visited mask.

    One labelling pass, then per blob (creation order, the first
    ``max_contours``) its first raster pixel, Moore-traced from there unless
    an earlier trace already visited it.  Same per-contour semantics as
    :func:`trace_contour`.  ``max_contours`` may not exceed ``max_blobs``.
    """
    if max_contours > max_blobs:
        raise ValueError(
            f"max_contours ({max_contours}) cannot exceed max_blobs ({max_blobs})")
    if max_contours < 0:
        raise ValueError(f"max_contours must be >= 0, got {max_contours}")
    img = _frame(img)
    table, label_map, _ = blobs(img, int(max_blobs))
    vis = torch.zeros(img.shape, dtype=torch.uint8, device=img.device)
    rows, n, _ = contour(img, vis, table=table, label_map=label_map,
                         max_contours=int(max_contours))
    bx, by, bw, bh, sx, sy, length = rows
    return Contours(n=n, box=Rect(bx, by, bw, bh), start=Point(sx, sy), length=length,
                    visited=vis)
