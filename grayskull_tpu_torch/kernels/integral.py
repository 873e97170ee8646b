"""The integral image, with its plain PyTorch version.

:func:`integral` (K4, ``csrc/integral.cu:gs_integral``) replaces the Pallas kernel
``grayskull_tpu/kernels/integral.py:111 integral_pallas``: ``(N, H, W)`` uint8
frames to their inclusive 2-D prefix sums, ``torch.uint32`` with wraparound, as
``gs_integral`` computes them in unsigned ints.

The output dtype is ``torch.uint32``, the JAX package's dtype.  PyTorch gives
that dtype few operations, so the port's consumers reinterpret it with
``.view(torch.int32)`` and widen with :func:`u32_to_int64`.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
:func:`integral_plain`.  ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from .. import profiling
from . import _build

__all__ = ["from_int64", "integral", "integral_plain", "launches", "u32_to_int64"]

launches = {"integral": 0}

_U32 = 0xFFFFFFFF


def u32_to_int64(t: torch.Tensor) -> torch.Tensor:
    """A uint32 (or int32 holding uint32 bits) tensor as int64 values in [0, 2^32)."""
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    return t.to(torch.int64) & _U32


def from_int64(t: torch.Tensor) -> torch.Tensor:
    """int64 values, taken mod 2^32, as a ``torch.uint32`` tensor."""
    t = t & _U32
    return torch.where(t >= 2**31, t - 2**32, t).to(torch.int32).view(torch.uint32)


def integral_plain(imgs: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`integral`: int64 ``cumsum`` along W then H, mod 2^32.

    Modular addition is associative, so the wrapped result equals the
    reference's sequential uint32 running sum.
    """
    return from_int64(torch.cumsum(torch.cumsum(imgs.to(torch.int64), dim=-1), dim=-2))


@profiling.spanned("gs.kernels.integral")
def integral(imgs: torch.Tensor) -> torch.Tensor:
    """K4: (N, H, W) uint8 -> (N, H, W) ``torch.uint32`` inclusive prefix sums."""
    if not isinstance(imgs, torch.Tensor):
        raise TypeError(f"integral: expected a torch.Tensor, got {type(imgs).__name__}")
    if imgs.dtype != torch.uint8:
        raise TypeError(f"integral: frames must be torch.uint8, got {imgs.dtype}")
    if imgs.ndim != 3 or min(imgs.shape) < 1:
        raise ValueError(f"integral: expected non-empty (N, H, W) frames, got {tuple(imgs.shape)}")
    if not imgs.is_contiguous():
        raise ValueError("integral: frames must be contiguous")
    if not imgs.is_cuda:
        return integral_plain(imgs)
    n, h, w = imgs.shape
    if n > 65535:
        raise ValueError(f"integral: at most 65535 frames per call, got {n}")
    lib = _build.library()
    out = torch.empty((n, h, w), dtype=torch.uint32, device=imgs.device)
    with torch.cuda.device(imgs.device):
        code = lib.gs_integral(imgs.data_ptr(), out.data_ptr(), n, h, w, _build.stream_of(imgs))
    _build.check(code, "integral")
    launches["integral"] += 1
    return out
