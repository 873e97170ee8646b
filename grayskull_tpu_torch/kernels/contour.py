"""Moore-neighbour contour walks, with their plain version.

:func:`contour` (K20, ``csrc/contour.cu:gs_contour``) replaces the XLA
while-loop ``grayskull_tpu/ops/contour.py:36 trace_contour`` and the scan of
walks around it in ``largest_blob_contour`` and ``find_contours``: one launch
runs every walk of a call over one frame and one visited mask.  The walk is
``gs_trace_contour`` (grayskull.h:446-480) with the JAX package's step bound
``4 * h * w + 8``; the source says how a step is laid out.  A walk's path
depends on the frame alone, so find's walks run side by side, a warp each,
recording their paths in a scratch map of ``(H, W)`` words; the rows are then
resolved in table order (which are kept, which pixels each counts, the marks),
exactly as the walks would have run one after another.

Three modes, by the arguments given:

* **trace** (``start``): one walk from ``start = (x, y)`` on ``visited``;
* **find** (``table`` and ``label_map``): for the blob rows ``k < min(n,
  max_contours)`` in table order, the walk from the blob's first raster pixel,
  skipped when that pixel is already visited; the kept rows compacted, their
  count in ``flag``;
* **largest** (``table``, ``label_map``, ``largest=True``): the walk of the
  first largest blob among rows ``< n`` when ``n > 0``, its area is at least
  100 and its pixel exists (``flag``, a bool); else every field 0.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
:func:`contour_plain`, the same walk step by step in Python.  ``launches``
counts the kernel launches.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from .. import profiling
from . import _build

__all__ = ["ROW_FIELDS", "contour", "contour_plain", "launches"]

launches = {"contour": 0}

# the rows of the (7, cap) int32 result
ROW_FIELDS = ("box_x", "box_y", "box_w", "box_h", "start_x", "start_y", "length")
_DX = (1, 1, 0, -1, -1, -1, 0, 1)  # clockwise from East (grayskull.h:448-449)
_DY = (0, 1, 1, 1, 0, -1, -1, -1)
_LABEL_MAP_LIMIT = 2**16  # a table past this many labels wraps its uint16 label map


def _i32(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


def _walk(img: bytes, vis: bytearray, h: int, w: int, sx: int, sy: int):
    """One walk, the JAX package's body step by step; returns (box, length, steps)."""
    max_steps = 4 * h * w + 8
    px, py, d, length, seen = sx, sy, 7, 0, False
    bx, by, bw, bh = sx, sy, 1, 1
    steps = 0
    while steps < max_steps:
        # the mask by JAX's index rule: a negative index adds the size once,
        # a read out of range is clamped, a write out of range dropped
        wx = px + w if px < 0 else px
        wy = py + h if py < 0 else py
        at = min(max(wy, 0), h - 1) * w + min(max(wx, 0), w - 1)
        length += vis[at] == 0
        if 0 <= wx < w and 0 <= wy < h:
            vis[at] = 255
        steps += 1
        ndir = (d + 1) % 8
        for k in range(8):
            sel = (ndir + k) % 8
            nx, ny = _i32(px + _DX[sel]), _i32(py + _DY[sel])
            if 0 <= nx < w and 0 <= ny < h and img[ny * w + nx] > 128:
                break
        else:
            break  # dead end
        px, py, d = nx, ny, (sel + 6) % 8
        bx, by = min(bx, px), min(by, py)
        bw, bh = max(bw, _i32(px - bx + 1)), max(bh, _i32(py - by + 1))
        at_start = px == sx and py == sy
        if at_start and seen:
            break
        seen = seen or at_start
    return (bx, by, bw, bh), length, steps


def _first_pixel(label_map: np.ndarray, lo: int, label: int):
    """The first raster index >= lo holding ``label``, as (x, y), or None."""
    hits = np.flatnonzero(label_map.reshape(-1)[lo:] == label)
    if not len(hits):
        return None
    idx = lo + int(hits[0])
    w = label_map.shape[1]
    return idx % w, idx // w


def _host_start(start):
    """``start`` as two Python ints if it holds host integers, else None."""
    if isinstance(start, torch.Tensor):
        return None
    x, y = start
    if not (isinstance(x, numbers.Integral) and isinstance(y, numbers.Integral)):
        return None
    if not all(-2**31 <= int(v) < 2**31 for v in (x, y)):
        raise OverflowError(f"contour: start {(int(x), int(y))} is not a pair of int32 values")
    return int(x), int(y)


def _start_tensor(start, device) -> torch.Tensor:
    """``start`` as a contiguous int32 (x, y) tensor on ``device``."""
    if isinstance(start, torch.Tensor):
        return start.to(device=device, dtype=torch.int32, non_blocking=True).reshape(2)
    return torch.stack([torch.as_tensor(v).to(device=device, dtype=torch.int32,
                                              non_blocking=True).reshape(())
                        for v in start])


def contour_plain(img, visited, start=None, table=None, label_map=None, max_contours=1,
                  largest=False):
    """Plain version of :func:`contour`: the walks in Python over host copies of
    the frame, the mask and the table; ``visited`` is updated in place and the
    outputs land on the frame's device."""
    h, w = img.shape
    dev = img.device
    frame = img.cpu().numpy().tobytes()
    vis = bytearray(visited.cpu().numpy().tobytes())
    cap = 1 if table is None or largest else int(max_contours)
    rows = np.zeros((len(ROW_FIELDS), cap), np.int32)
    steps = np.zeros(cap, np.int64)
    flag = None

    def put(k, walked, sx, sy):
        box, length, n_steps = walked
        rows[:, k] = (*box, sx, sy, length)
        steps[k] = n_steps

    if table is None:
        host = _host_start(start)
        sx, sy = host if host is not None else (int(v) for v in _start_tensor(start, "cpu"))
        put(0, _walk(frame, vis, h, w, sx, sy), sx, sy)
    else:
        lm = label_map.cpu().numpy()
        n = int(table.n)
        labels = table.label.cpu().numpy()
        full_scan = labels.shape[0] >= _LABEL_MAP_LIMIT
        box_x, box_y = table.box.x.cpu().numpy(), table.box.y.cpu().numpy()

        def first(k):
            lo = 0 if full_scan else int(box_y[k]) * w + int(box_x[k])
            return _first_pixel(lm, lo, int(labels[k]))

        if largest:
            area = np.where(np.arange(labels.shape[0]) < n, table.area.cpu().numpy(), -1)
            li = int(np.argmax(area)) if len(area) else 0
            px = first(li) if len(area) else None
            found = n > 0 and int(area[li]) >= 100 and px is not None
            if found:
                put(0, _walk(frame, vis, h, w, *px), *px)
            flag = torch.tensor(found, device=dev)
        else:
            kept = 0
            for k in range(min(n, cap)):
                px = first(k)
                if px is None or vis[px[1] * w + px[0]] != 0:
                    continue
                put(kept, _walk(frame, vis, h, w, *px), *px)
                kept += 1
            flag = torch.tensor(kept, dtype=torch.int32, device=dev)
    visited.copy_(torch.frombuffer(vis, dtype=torch.uint8).view(h, w))
    return (torch.from_numpy(rows).to(dev), flag, torch.from_numpy(steps).to(dev))


def _check(img, visited, table, label_map):
    for name, t, dtype in (("frame", img, torch.uint8), ("visited mask", visited, torch.uint8),
                           ("label map", label_map, torch.uint16)):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise TypeError(f"contour: the {name} must be a {dtype} tensor")
        if t.ndim != 2 or min(t.shape) < 1 or tuple(t.shape) != tuple(img.shape):
            raise ValueError(f"contour: the {name} must be (H, W) like the frame, got "
                             f"{tuple(t.shape)}")
        if t.device != img.device or not t.is_contiguous():
            raise ValueError(f"contour: the {name} must be contiguous on the frame's device")
    if table is not None:
        for t in (table.n, table.label, table.area, table.box.x, table.box.y):
            if t.dtype != torch.int32 or t.device != img.device or not t.is_contiguous():
                raise ValueError("contour: the blob table must be contiguous int32 on the "
                                 "frame's device")


@profiling.spanned("gs.kernels.contour")
def contour(img, visited, start=None, table=None, label_map=None, max_contours=1, largest=False):
    """K20: the walks of one call over the (H, W) uint8 frame ``img``.

    ``visited`` ((H, W) uint8, contiguous) is read and updated in place.
    Returns ``(rows, flag, steps)``: ``rows`` the (7, cap) int32 fields of
    :data:`ROW_FIELDS` (cap 1 but for find), ``flag`` the kept count (find), the
    found bool (largest) or None (trace), ``steps`` each kept walk's step
    count, (cap,) int64.  ``table`` is a one-frame :class:`~..core.Blobs` and
    ``label_map`` its (H, W) uint16 map.
    """
    if table is None and start is None:
        raise ValueError("contour: give a start (trace) or a blob table (find, largest)")
    if table is not None and label_map is None:
        raise ValueError("contour: a blob table needs its label map")
    _check(img, visited, table, label_map)
    max_contours = int(max_contours)
    if table is not None and not largest and not 0 <= max_contours <= table.label.shape[0]:
        raise ValueError(f"contour: max_contours {max_contours} must be in 0 .. "
                         f"{table.label.shape[0]}, the table's capacity")
    if not img.is_cuda:
        return contour_plain(img, visited, start, table, label_map, max_contours, largest)
    h, w = img.shape
    dev = img.device
    cap = 1 if table is None or largest else max_contours
    rows = torch.empty((len(ROW_FIELDS), cap), dtype=torch.int32, device=dev)
    steps = torch.empty(cap, dtype=torch.int64, device=dev)
    flag, start_ptr, sx, sy, path = None, None, 0, 0, None
    table_ptrs = [None] * 6
    if table is None:
        mode = 0
        host = _host_start(start)
        if host is not None:
            sx, sy = host
        else:
            start_t = _start_tensor(start, dev)
            start_ptr = start_t.data_ptr()
    else:
        mode = 2 if largest else 1
        flag = torch.empty((), dtype=torch.bool if largest else torch.int32, device=dev)
        if not largest:  # the walks' path bits, zero on entry (the kernel leaves it zero)
            path = torch.zeros((h, w), dtype=torch.int32, device=dev)
        table_ptrs = [label_map.data_ptr(), table.n.data_ptr(), table.label.data_ptr(),
                      table.area.data_ptr(), table.box.x.data_ptr(), table.box.y.data_ptr()]
    bcap = 0 if table is None else table.label.shape[0]
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.gs_contour(img.data_ptr(), visited.data_ptr(), h, w, mode, start_ptr, sx, sy,
                              *table_ptrs, bcap, cap, int(bcap >= _LABEL_MAP_LIMIT),
                              rows.data_ptr(), flag.data_ptr() if mode == 1 else None,
                              flag.data_ptr() if mode == 2 else None, steps.data_ptr(),
                              None if path is None else path.data_ptr(), _build.stream_of(img))
    _build.check(code, "contour")
    launches["contour"] += 1
    return rows, flag, steps
