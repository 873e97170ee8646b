"""The reference's ``GS_NO_STDLIB`` trig, with its plain PyTorch versions.

K21 (``csrc/freestanding.cu``) replaces the XLA polynomials
``grayskull_tpu/libm32.py`` ``_freestanding_atan2`` and ``_freestanding_sin``
(grayskull.h:70-88), the math of the nostdlib build, which the ORB path runs
in the ``freestanding`` trig mode.  :func:`fs_orient` (``gs_fs_orient``) is
the ORB path's call: each keypoint's int32 moments in, its angle, sine and
reference cosine out, in one launch, the angle kept in registers.
:func:`fs_atan2` and :func:`fs_sin` (``gs_fs_atan2``, ``gs_fs_sin``) serve
``libm32``'s ``atan2f``, ``sinf`` and ``cosf_like_reference`` on any float
tensor.  A thread runs C's range reduction on its own element, so a call is
one launch and no host wait; every float operation rounds on its own.

The plain versions mirror the JAX functions operation by operation: every
constant is the float32 C rounds it to, each product and sum is its own
tensor op (an eager float32 op rounds once; none is fused), ``abs_y`` keeps
``-0.0`` as C's ``y >= 0 ? y : -y`` does.  Two differences from C and JAX,
shared by kernel and plain version: an input with ``!(|x| < 2^20)`` (NaN,
``±inf``, or past 2^20) gives NaN in the sine, where C's loop would never
end or would take up to 2^24 steps; and every NaN result is the quiet NaN
``0x7fc00000``, whatever the payload an operand carried.  Every ``|x| < 2^20``
runs C's loops exactly; ORB's angles lie in ``[-pi, pi + 1.58]``.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version.  ``launches`` counts the kernel launches (an empty tensor launches none).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import profiling
from . import _build

__all__ = ["COS_OFFSET", "LOOP_BOUND", "fs_atan2", "fs_atan2_plain", "fs_orient",
           "fs_orient_plain", "fs_sin", "fs_sin_plain", "launches"]

launches = {"freestanding": 0}

LOOP_BOUND = 2.0**20  # the sine's inputs at or past it (and NaN) give NaN
COS_OFFSET = 1.57079  # the reference's cosine is gs_sin(angle + 1.57079f)

# grayskull.h's constants as float32 values, exact as Python floats
_QUARTER_PI = float(np.float32(0.785398))
_THREE_QUARTER_PI = float(np.float32(3.0) * np.float32(0.785398))  # folded in f32, as C does
_HALF_PI = float(np.float32(1.570796))
_PI = float(np.float32(3.141592))
_TWO_PI = float(np.float32(6.283185))
_SIN3 = float(np.float32(0.16666667))
_SIN5 = float(np.float32(0.0083333310))
_NAN = float("nan")  # 0x7fc00000 as a float32


def fs_atan2_plain(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``gs_atan2`` under ``GS_NO_STDLIB`` (grayskull.h:71-79), elementwise."""
    abs_y = torch.where(y >= 0, y, -y)
    ang_pos = _QUARTER_PI - _QUARTER_PI * ((x - abs_y) / (x + abs_y))
    ang_neg = _THREE_QUARTER_PI - _QUARTER_PI * ((x + abs_y) / (abs_y - x))
    angle = torch.where(x >= 0, ang_pos, ang_neg)
    angle = torch.where(y < 0, -angle, angle)
    zero_case = torch.where(y > 0, _HALF_PI, torch.where(y < 0, -_HALF_PI, 0.0))
    angle = torch.where(x == 0, zero_case.to(angle.dtype), angle)
    return torch.where(torch.isnan(angle), _NAN, angle)


def _loop(v: torch.Tensor, cond, step) -> None:
    """C's ``while (cond(x)) x = step(x);`` on each element of the flat ``v``, in
    place; each round computes only the elements still stepping."""
    idx = torch.nonzero(cond(v)).view(-1)
    while idx.numel():
        vals = step(v[idx])
        v[idx] = vals
        idx = idx[cond(vals)]


def fs_sin_plain(x: torch.Tensor, offset: float | None = None) -> torch.Tensor:
    """``gs_sin`` under ``GS_NO_STDLIB`` (grayskull.h:81-88), elementwise, of
    ``x + offset`` (the add rounded to float32) when an offset is given.

    C's two reduction loops run until no element needs a step; each round is
    a host wait on a CUDA tensor, so this version is for the CPU and for
    checking the kernel.
    """
    if offset is not None:
        x = x + float(np.float32(offset))
    past = ~(x.abs() < LOOP_BOUND)
    v = torch.where(past, 0.0, x).reshape(-1)  # a copy: the loops write it in place
    _loop(v, lambda t: t > _PI, lambda t: t - _TWO_PI)
    _loop(v, lambda t: t < -_PI, lambda t: t + _TWO_PI)
    v = v.view(x.shape)
    neg = v < 0
    v = torch.where(neg, -v, v)
    v = torch.where(v > _HALF_PI, _PI - v, v)
    x2 = v * v
    t = _SIN3 - _SIN5 * x2
    res = v * (1.0 - x2 * t)
    res = torch.where(neg, -res, res)
    return torch.where(past | torch.isnan(res), _NAN, res)


def fs_orient_plain(m01: torch.Tensor, m10: torch.Tensor):
    """The orientation's trig from int32 moments: ``angle = gs_atan2(m01, m10)``
    of the moments as float32, then ``gs_sin(angle)`` and the reference's
    cosine ``gs_sin(angle + 1.57079f)``.  Returns (angle, sin, cos)."""
    angle = fs_atan2_plain(m01.to(torch.float32), m10.to(torch.float32))
    return angle, fs_sin_plain(angle), fs_sin_plain(angle, COS_OFFSET)


def _check(t, name: str, dtype=torch.float32) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the tensor must be contiguous")


@profiling.spanned("gs.kernels.freestanding")
def fs_orient(m01: torch.Tensor, m10: torch.Tensor):
    """K21: int32 moments ``m01``, ``m10`` of one shape -> (angle, sin, cos) as
    :func:`fs_orient_plain`, float32, in one launch."""
    _check(m01, "fs_orient", torch.int32)
    _check(m10, "fs_orient", torch.int32)
    if m01.shape != m10.shape or m01.device != m10.device:
        raise ValueError(f"fs_orient: operands differ: {tuple(m01.shape)} on {m01.device}, "
                         f"{tuple(m10.shape)} on {m10.device}")
    if not m01.is_cuda:
        return fs_orient_plain(m01, m10)
    n = m01.numel()
    angle, sin, cos = torch.empty((3, *m01.shape), dtype=torch.float32,
                                  device=m01.device).unbind(0)  # one allocation
    if n == 0:
        return angle, sin, cos
    lib = _build.library()
    with torch.cuda.device(m01.device):
        code = lib.gs_fs_orient(m01.data_ptr(), m10.data_ptr(), angle.data_ptr(), sin.data_ptr(),
                                cos.data_ptr(), n, _build.stream_of(m01))
    _build.check(code, "fs_orient")
    launches["freestanding"] += 1
    return angle, sin, cos


@profiling.spanned("gs.kernels.freestanding")
def fs_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K21: float32 ``y``, ``x`` of one shape -> ``gs_atan2(y, x)``."""
    _check(y, "fs_atan2")
    _check(x, "fs_atan2")
    if y.shape != x.shape or y.device != x.device:
        raise ValueError(f"fs_atan2: operands differ: {tuple(y.shape)} on {y.device}, "
                         f"{tuple(x.shape)} on {x.device}")
    if not y.is_cuda:
        return fs_atan2_plain(y, x)
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(y.device):
        code = lib.gs_fs_atan2(y.data_ptr(), x.data_ptr(), out.data_ptr(), y.numel(),
                               _build.stream_of(y))
    _build.check(code, "fs_atan2")
    launches["freestanding"] += 1
    return out


@profiling.spanned("gs.kernels.freestanding")
def fs_sin(x: torch.Tensor, offset: float | None = None) -> torch.Tensor:
    """K21: float32 ``x`` -> ``gs_sin(x + offset)``, the add rounded to float32
    (no add without an offset)."""
    _check(x, "fs_sin")
    if not x.is_cuda:
        return fs_sin_plain(x, offset)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    # -0.0 is the add's identity for every float32, -0.0 included
    add = ctypes.c_float(-0.0 if offset is None else float(np.float32(offset)))
    lib = _build.library()
    with torch.cuda.device(x.device):
        code = lib.gs_fs_sin(x.data_ptr(), out.data_ptr(), x.numel(), add, _build.stream_of(x))
    _build.check(code, "fs_sin")
    launches["freestanding"] += 1
    return out
