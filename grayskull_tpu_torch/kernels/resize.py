"""The bilinear resize, with its plain PyTorch version.

:func:`resize` (K14, ``csrc/resize.cu:gs_resize``) replaces the Pallas kernel
``grayskull_tpu/kernels/resize.py:217 resize_pallas``, which picks each output
pixel's four corner samples with one-hot matrix products over a source band and
host-made coordinate tables.  On the card a block makes each coordinate once
for many frames, gathers the four corners (from source rows staged in shared
memory, or through L1) and lerps, in the float order of ``gs_resize``
(grayskull.h:171-187).  The TPU's shape gate
``resize_pallas_available`` has no counterpart: every shape goes through the
kernel.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
:func:`resize_plain`.  ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from .. import profiling
from . import _build
from .preproc import _check_frames

__all__ = ["launches", "resize", "resize_plain", "source_coords"]

launches = {"resize": 0}


def source_coords(dst_n: int, src_n: int):
    """``(i0, i1, d)`` along one axis: ``s = ((o + 0.5) * src_n) / dst_n - 0.5``
    clamped to ``[0, src_n - 1]``, ``i0 = (int)s``, ``i1 = min(i0 + 1, src_n - 1)``,
    ``d = s - i0`` (grayskull.h:174-177), on the CPU in float32.

    The divisor is a tensor: PyTorch's CUDA division by a host scalar multiplies
    by its reciprocal, which is not the reference's division.
    """
    o = torch.arange(dst_n, dtype=torch.float32)
    s = (o + 0.5) * float(src_n) / torch.full_like(o, float(dst_n)) - 0.5
    s = s.clamp(min=0.0, max=float(src_n) - 1.0)
    i0 = s.to(torch.int64)  # truncation, s >= 0
    return i0, (i0 + 1).clamp(max=src_n - 1), s - i0.to(torch.float32)


def resize_plain(imgs: torch.Tensor, size) -> torch.Tensor:
    """Plain version of :func:`resize`: coordinate tables on the CPU, four
    ``index_select`` gathers, the lerp as separate eager float32 ops in C's
    order, a truncating store."""
    dh, dw = int(size[0]), int(size[1])
    n, sh, sw = imgs.shape
    dev = imgs.device
    x0, x1, dx = (t.to(dev) for t in source_coords(dw, sw))
    y0, y1, dy = (t.to(dev) for t in source_coords(dh, sh))
    ndx, ndy = 1.0 - dx.view(1, 1, dw), 1.0 - dy.view(1, dh, 1)
    dx, dy = dx.view(1, 1, dw), dy.view(1, dh, 1)
    r0, r1 = imgs.index_select(1, y0), imgs.index_select(1, y1)

    def corner(rows, cols):
        return rows.index_select(2, cols).to(torch.float32)

    t1 = (corner(r0, x0) * ndx) * ndy
    t2 = (corner(r0, x1) * dx) * ndy
    t3 = (corner(r1, x0) * ndx) * dy
    t4 = (corner(r1, x1) * dx) * dy
    return (((t1 + t2) + t3) + t4).to(torch.uint8)


@profiling.spanned("gs.kernels.resize")
def resize(imgs: torch.Tensor, size) -> torch.Tensor:
    """K14: (N, sh, sw) uint8 frames, ``size = (dh, dw)`` -> (N, dh, dw) uint8,
    bilinear with half-pixel centres, bit-exact ``gs_resize``."""
    _check_frames(imgs, "resize")
    dh, dw = int(size[0]), int(size[1])
    if dh < 1 or dw < 1:
        raise ValueError(f"resize: output size must be positive, got {(dh, dw)}")
    if not imgs.is_cuda:
        return resize_plain(imgs, (dh, dw))
    n, sh, sw = imgs.shape
    lib = _build.library()
    out = torch.empty((n, dh, dw), dtype=torch.uint8, device=imgs.device)
    with torch.cuda.device(imgs.device):
        code = lib.gs_resize(imgs.data_ptr(), out.data_ptr(), n, sh, sw, dh, dw,
                             _build.stream_of(imgs))
    _build.check(code, "resize")
    launches["resize"] += 1
    return out
