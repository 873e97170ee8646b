"""The bilinear quad warp, with its plain PyTorch version.

:func:`quad_warp` (K10, ``csrc/warp.cu:gs_quad_warp``) replaces the Pallas
kernels ``grayskull_tpu/kernels/warp.py:163 _quad_sample_banded_pallas`` and
``:98 _quad_sample_pallas``, which fetch the four bilinear corner samples of
each output pixel with one-hot matrix products over a source band.  On the
card that is a gather, so one kernel does the coordinate math, the four
samples and the lerp of ``gs_perspective_correct`` (grayskull.h:423-444) in
the reference's float order: a block owns a tile of a page, a thread 4
columns (32 apart) of 8 rows, with the terms of a column, a row and a frame
computed once (``csrc/warp.cu``).  The TPU's band configs, their ladder and
its gather fallback have no counterpart: every quad goes through the kernel.

:func:`quad_warp_rows` (``csrc/warp.cu:gs_quad_warp_rows``, the same kernel)
writes a band of rows of the same pages, each row's ``v`` still the whole
page's: the space-sharded scanner's shard warps its own band, as
``grayskull_tpu/ops/warp.py:68 _warp_rows`` does for the JAX package.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
:func:`quad_warp_plain` (:func:`quad_warp_rows_plain`).  ``launches`` counts
the kernel launches.
"""

from __future__ import annotations

import torch

from .. import profiling
from . import _build
from .preproc import _check_frames

__all__ = ["launches", "quad_warp", "quad_warp_plain", "quad_warp_rows", "quad_warp_rows_plain",
           "warp_grid"]

launches = {"quad_warp": 0, "quad_warp_rows": 0}


def warp_grid(n: int, dev, start: int = 0, stop: int | None = None) -> torch.Tensor:
    """``arange(n) / (n - 1)`` in float32, an IEEE division per element (NaN
    for ``n == 1``); with ``start`` and ``stop``, only its elements ``start``
    to ``stop - 1``.

    The divisor is a tensor on the device: PyTorch's CUDA division by a host
    scalar multiplies by its reciprocal, which is not the reference's
    division.
    """
    num = torch.arange(start, n if stop is None else stop, dtype=torch.float32, device=dev)
    return num / torch.full_like(num, float(n - 1))


def _clamp_coord(v: torch.Tensor, hi: float) -> torch.Tensor:
    """``max(0, min(v, hi))``, a NaN to 0.

    A NaN comes from a page of one row or one column (0/0 in the grid).  C
    leaves that undefined; the JAX package's integer float adder
    (``grayskull_tpu/exactf32.py``) makes the coordinate -inf, which its clamp
    sends to 0, so such a page is ``src[0, 0]`` everywhere, and so is the port's.
    """
    v = torch.where(v > hi, hi, v)
    return torch.where(v >= 0, v, 0.0)


def _less_one(size: int) -> float:
    """``(float)size - 1`` with both steps rounded to float32."""
    return float(torch.tensor(float(size), dtype=torch.float32) - 1.0)


def quad_warp_plain(src: torch.Tensor, corners: torch.Tensor, size) -> torch.Tensor:
    """Plain version of :func:`quad_warp`: ``_warp_coords``, a gather and
    ``_warp_lerp`` of ``grayskull_tpu/ops/warp.py:25-65``, each float op its
    own eager (rounded) op.

    The clamp's bound is the float32 ``(float)sw - 1``.  Past 2^24 it can
    round above ``sw - 1``, so the truncated coordinate can pass the frame's
    last column (row); the reads then clamp to the frame, as the JAX
    package's gather does, and the weight of such a column (row) is 1 since
    every float there is an integer."""
    return quad_warp_rows_plain(src, corners, size, 0, int(size[0]))


def quad_warp_rows_plain(src: torch.Tensor, corners: torch.Tensor, size, row0: int,
                         rows: int) -> torch.Tensor:
    """Plain version of :func:`quad_warp_rows`: :func:`quad_warp_plain`'s rows
    ``row0 .. row0 + rows - 1``, computed for those rows only."""
    n, sh, sw = src.shape
    dh, dw = size
    dev = src.device
    u = warp_grid(dw, dev).view(1, 1, dw)
    v = warp_grid(dh, dev, row0, row0 + rows).view(1, rows, 1)
    c = corners.to(torch.float32).view(n, 4, 2, 1, 1)

    def edge(p0, p1, t):
        return p0 * (1.0 - t) + p1 * t

    top_x, top_y = edge(c[:, 0, 0], c[:, 1, 0], u), edge(c[:, 0, 1], c[:, 1, 1], u)
    bot_x, bot_y = edge(c[:, 3, 0], c[:, 2, 0], u), edge(c[:, 3, 1], c[:, 2, 1], u)
    src_x = _clamp_coord(edge(top_x, bot_x, v), _less_one(sw))
    src_y = _clamp_coord(edge(top_y, bot_y, v), _less_one(sh))
    x0 = src_x.to(torch.int64)  # truncation, values >= 0
    y0 = src_y.to(torch.int64)
    x1 = (x0 + 1).clamp(max=sw - 1)
    y1 = (y0 + 1).clamp(max=sh - 1)
    dx = src_x - x0.to(torch.float32)
    dy = src_y - y0.to(torch.float32)
    x0r, y0r = x0.clamp(max=sw - 1), y0.clamp(max=sh - 1)
    flat = src.view(n, sh * sw)

    def sample(yi, xi):
        return flat.gather(1, (yi * sw + xi).view(n, rows * dw)).view(n, rows, dw).to(torch.float32)

    t1 = (sample(y0r, x0r) * (1.0 - dx)) * (1.0 - dy)
    t2 = (sample(y0r, x1) * dx) * (1.0 - dy)
    t3 = (sample(y1, x0r) * (1.0 - dx)) * dy
    t4 = (sample(y1, x1) * dx) * dy
    return (((t1 + t2) + t3) + t4).to(torch.uint8)


def _check(src: torch.Tensor, corners: torch.Tensor, size, name: str) -> tuple[int, int]:
    _check_frames(src, name)
    if not isinstance(corners, torch.Tensor):
        raise TypeError(f"{name}: expected torch.Tensor corners, got {type(corners).__name__}")
    n = src.shape[0]
    if (corners.dtype != torch.int32 or tuple(corners.shape) != (n, 4, 2)
            or corners.device != src.device or not corners.is_contiguous()):
        raise ValueError(f"{name}: corners must be contiguous ({n}, 4, 2) int32 on the frames' "
                         f"device, got {tuple(corners.shape)} {corners.dtype} on {corners.device}")
    dh, dw = int(size[0]), int(size[1])
    if dh < 1 or dw < 1:
        raise ValueError(f"{name}: page size must be positive, got {(dh, dw)}")
    return dh, dw


@profiling.spanned("gs.kernels.quad_warp")
def quad_warp(src: torch.Tensor, corners: torch.Tensor, size) -> torch.Tensor:
    """K10: (N, sh, sw) uint8 frames, (N, 4, 2) int32 corners (x, y rows: TL,
    TR, BR, BL), ``size = (dh, dw)`` -> (N, dh, dw) uint8 pages."""
    dh, dw = _check(src, corners, size, "quad_warp")
    n, sh, sw = src.shape
    if not src.is_cuda:
        return quad_warp_plain(src, corners, (dh, dw))
    lib = _build.library()
    out = torch.empty((n, dh, dw), dtype=torch.uint8, device=src.device)
    with torch.cuda.device(src.device):
        code = lib.gs_quad_warp(src.data_ptr(), corners.data_ptr(), out.data_ptr(), n, sh, sw,
                                dh, dw, _build.stream_of(src))
    _build.check(code, "quad_warp")
    launches["quad_warp"] += 1
    return out


@profiling.spanned("gs.kernels.quad_warp_rows")
def quad_warp_rows(src: torch.Tensor, corners: torch.Tensor, size, row0: int,
                   rows: int) -> torch.Tensor:
    """K10's rows entry: the rows ``row0 .. row0 + rows - 1`` of
    :func:`quad_warp`'s (N, dh, dw) pages, as (N, rows, dw) uint8."""
    dh, dw = _check(src, corners, size, "quad_warp_rows")
    row0, rows = int(row0), int(rows)
    if rows < 1 or row0 < 0 or row0 + rows > dh:
        raise ValueError(f"quad_warp_rows: rows {row0} .. {row0 + rows - 1} are not rows of a "
                         f"{dh}-row page")
    if not src.is_cuda:
        return quad_warp_rows_plain(src, corners, (dh, dw), row0, rows)
    n, sh, sw = src.shape
    lib = _build.library()
    out = torch.empty((n, rows, dw), dtype=torch.uint8, device=src.device)
    with torch.cuda.device(src.device):
        code = lib.gs_quad_warp_rows(src.data_ptr(), corners.data_ptr(), out.data_ptr(), n, sh,
                                     sw, dh, dw, row0, rows, _build.stream_of(src))
    _build.check(code, "quad_warp_rows")
    launches["quad_warp_rows"] += 1
    return out
