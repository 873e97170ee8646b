"""The device-memory bandwidth probe's two kernels, with their plain PyTorch versions.

* :func:`copy` (K17, ``csrc/bandwidth.cu:gs_copy``) replaces the copy
  ``pallas_call`` of ``grayskull_tpu/profiling.py:hbm_bandwidth_gbps``: ``out = x``.
* :func:`triad` (K18, ``csrc/bandwidth.cu:gs_triad``) replaces its triad
  ``pallas_call``: ``out = (x + y) mod 256``, the TPU's int32 add truncated to uint8.

Both take uint8 tensors of any shape and size.  They are what
:func:`grayskull_tpu_torch.profiling.hbm_bandwidth_gbps` times; their plain
versions are nearly the library calls (``clone``, an int32 add), and the point
of the kernels is that the probe times code the port owns, 16 bytes a thread.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version.  ``launches`` counts the kernel launches (an empty tensor launches none).
"""

from __future__ import annotations

import torch

from .. import profiling
from . import _build

__all__ = ["copy", "copy_plain", "launches", "triad", "triad_plain"]

launches = {"copy": 0, "triad": 0}


def _check(x, name: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != torch.uint8:
        raise TypeError(f"{name}: expected torch.uint8, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the tensor must be contiguous")


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`copy`."""
    return x.clone()


def triad_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`triad`: the add in int32, truncated to uint8."""
    return ((x.to(torch.int32) + y.to(torch.int32)) & 255).to(torch.uint8)


@profiling.spanned("gs.kernels.copy")
def copy(x: torch.Tensor) -> torch.Tensor:
    """K17: a uint8 tensor -> a new tensor with the same bytes."""
    _check(x, "copy")
    if not x.is_cuda:
        return copy_plain(x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        code = lib.gs_copy(x.data_ptr(), out.data_ptr(), x.numel(), _build.stream_of(x))
    _build.check(code, "copy")
    launches["copy"] += 1
    return out


@profiling.spanned("gs.kernels.triad")
def triad(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K18: two uint8 tensors of one shape -> ``(x + y) mod 256``."""
    _check(x, "triad")
    _check(y, "triad")
    if x.shape != y.shape or x.device != y.device:
        raise ValueError(f"triad: operands differ: {tuple(x.shape)} on {x.device}, "
                         f"{tuple(y.shape)} on {y.device}")
    if not x.is_cuda:
        return triad_plain(x, y)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        code = lib.gs_triad(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
                            _build.stream_of(x))
    _build.check(code, "triad")
    launches["triad"] += 1
    return out
