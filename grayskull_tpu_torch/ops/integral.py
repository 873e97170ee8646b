"""Integral image — ``gs_integral`` / ``gs_integral_sum`` (grayskull.h:744-763),
bit-exact with ``grayskull_tpu.ops.integral``.

Integrals are ``torch.uint32`` with wraparound, as in the reference.  On a CUDA
tensor :func:`integral` launches K4; on a CPU tensor it runs the plain version.
:func:`integral_sum` is plain tensor ops everywhere, as the JAX version is XLA.
"""

from __future__ import annotations

import torch

from ..core import as_image
from ..kernels.integral import from_int64, integral as _integral_kernel, u32_to_int64

__all__ = ["integral", "integral_sum"]


def integral(img) -> torch.Tensor:
    """Inclusive 2-D prefix sum, uint32 — ``gs_integral`` (grayskull.h:744-752).

    Accepts (H, W) or (N, H, W) uint8; returns the same shape as ``torch.uint32``.
    """
    img = as_image(img)
    frames = (img if img.ndim == 3 else img[None]).contiguous()
    return _integral_kernel(frames).view(img.shape)


def integral_sum(ii: torch.Tensor, x, y, w, h) -> torch.Tensor:
    """Inclusive rect sum from an integral image — ``gs_integral_sum``
    (grayskull.h:754-763): ``D + A - B - C`` with its edge guards, mod 2^32.

    ``ii`` is a uint32 integral, ``(..., H, W)``; ``x, y, w, h`` are ints or
    integer tensors that broadcast together.  Returns ``torch.uint32``.
    """
    if ii.dtype != torch.uint32:
        raise TypeError(f"integral_sum: expected a torch.uint32 integral, got {ii.dtype}")
    dev = ii.device

    def arg(v):
        return torch.as_tensor(v, device=dev).to(torch.int64)

    x, y, w, h = arg(x), arg(y), arg(w), arg(h)
    x2 = x + w - 1
    y2 = y + h - 1
    bits = ii.view(torch.int32)  # indexing is implemented for int32, not uint32

    def take(yy, xx):
        # clamped gather; the guard masks zero out the clamped reads
        yy, xx = torch.broadcast_tensors(yy.clamp(0, ii.shape[-2] - 1),
                                         xx.clamp(0, ii.shape[-1] - 1))
        return u32_to_int64(bits[..., yy, xx])

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    a = torch.where((x > 0) & (y > 0), take(y - 1, x - 1), zero)
    b = torch.where(y > 0, take(y - 1, x2), zero)
    c = torch.where(x > 0, take(y2, x - 1), zero)
    d = take(y2, x2)
    return from_int64(d + a - b - c)
