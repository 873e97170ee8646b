"""float32 ``atan2f`` / ``sinf`` of the ORB orientation and descriptor path.

The reference calls libm's ``atan2f`` and ``sinf`` (grayskull.h:100-101), so its
bits depend on the libm it was linked against.  Three modes, as in
``grayskull_tpu.libm32``:

* **fast** (the default): float64 on the tensor's own device, rounded to
  float32.  No host round-trip.  On the CPU this equals the JAX package's fast
  mode; CUDA's float64 ``atan2`` is not glibc's, so an angle on the card may
  differ from the CPU's by an ulp.
* **exact_host**: the process's own libm through :mod:`ctypes`, element by
  element, bit-identical to the C reference built on this machine.  Each call
  copies its input to the host and the result back, one round-trip, as the
  JAX package's ``pure_callback`` does; it is the mode of the parity tests.

* **freestanding**: the reference's ``GS_NO_STDLIB`` polynomials (the octant
  ``atan2`` and the range-reduced quintic sine, grayskull.h:70-88), the math of
  its nostdlib build.  A CUDA tensor runs K21 (``kernels.freestanding``: a
  thread an element, one launch a call, no host wait; ORB's angle, sine and
  cosine, :func:`orientation_trig`, in one launch), a CPU tensor its plain
  version; both are bit-identical to the JAX package's freestanding mode on
  the CPU, but for two inputs JAX never returns from (the sine's ``±inf``, and
  every ``|x| >= 2^20``, give NaN here) and NaN payloads (every NaN is
  ``0x7fc00000``).

``exact_mode()`` is true in the last two.  ``force_reference=True`` runs the
plain freestanding polynomials on the tensor's own device (the ORB entry
points' plain path); it changes nothing in the other modes.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np
import torch

from .kernels.freestanding import (COS_OFFSET, fs_atan2, fs_atan2_plain, fs_orient,
                                   fs_orient_plain, fs_sin, fs_sin_plain)

__all__ = ["atan2f", "cosf_like_reference", "exact_mode", "orientation_trig", "sinf",
           "trig_mode", "use_exact_host_libm", "use_freestanding"]

_MODE = "fast"  # "fast" | "exact_host" | "freestanding"


def exact_mode() -> bool:
    """True when a bit-exact parity mode (``exact_host`` or ``freestanding``) is active."""
    return _MODE != "fast"


def trig_mode() -> str:
    return _MODE


def use_exact_host_libm(enable: bool = True) -> None:
    """Toggle bit-exact host-libm trig (the parity tests' mode)."""
    global _MODE
    _MODE = "exact_host" if enable else "fast"


def use_freestanding(enable: bool = True) -> None:
    """Toggle the reference's ``GS_NO_STDLIB`` polynomial trig (grayskull.h:70-88)."""
    global _MODE
    _MODE = "freestanding" if enable else "fast"


# the JAX package's names for the plain polynomials
_freestanding_atan2 = fs_atan2_plain
_freestanding_sin = fs_sin_plain


_libm = None


def _get_libm():
    global _libm
    if _libm is None:
        _libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        _libm.atan2f.restype = ctypes.c_float
        _libm.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]
        _libm.sinf.restype = ctypes.c_float
        _libm.sinf.argtypes = [ctypes.c_float]
    return _libm


def _on_host(fn, *args: torch.Tensor) -> torch.Tensor:
    """``fn`` of the float32 libm, element by element on the host, back on the args' device."""
    arrays = [a.detach().to("cpu", torch.float32).numpy().ravel() for a in args]
    out = np.fromiter((fn(*(float(v) for v in vals)) for vals in zip(*arrays)), np.float32,
                      count=arrays[0].size)
    return torch.from_numpy(out).view(args[0].shape).to(args[0].device)


def _as_f32(v, like=None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return torch.as_tensor(v, dtype=torch.float32,
                           device=like.device if isinstance(like, torch.Tensor) else None)


def atan2f(y, x, force_reference: bool = False) -> torch.Tensor:
    """``atan2f(y, x)`` in float32, by the current mode."""
    y, x = torch.broadcast_tensors(_as_f32(y, x), _as_f32(x, y))
    if _MODE == "exact_host":
        return _on_host(_get_libm().atan2f, y.contiguous(), x.contiguous())
    if _MODE == "freestanding":
        if force_reference:
            return fs_atan2_plain(y, x)
        return fs_atan2(y.contiguous(), x.contiguous())
    return torch.atan2(y.to(torch.float64), x.to(torch.float64)).to(torch.float32)


def sinf(x, force_reference: bool = False) -> torch.Tensor:
    """``sinf(x)`` in float32, by the current mode."""
    x = _as_f32(x)
    if _MODE == "exact_host":
        return _on_host(_get_libm().sinf, x)
    if _MODE == "freestanding":
        return fs_sin_plain(x) if force_reference else fs_sin(x.contiguous())
    return torch.sin(x.to(torch.float64)).to(torch.float32)


def cosf_like_reference(x, force_reference: bool = False) -> torch.Tensor:
    """The reference's cosine, ``gs_sin(angle + 1.57079f)`` (grayskull.h:626): the add
    rounds to float32 and the constant is truncated, so this is not ``cos(angle)``."""
    x = _as_f32(x)
    if _MODE == "freestanding":  # K21 rounds the add in: one launch
        if force_reference:
            return fs_sin_plain(x, COS_OFFSET)
        return fs_sin(x.contiguous(), COS_OFFSET)
    # the float32 constant as an exact Python float: the add rounds once to float32,
    # and no tensor is copied to the device (a host sync)
    return sinf(x + float(np.float32(COS_OFFSET)))


def orientation_trig(m01: torch.Tensor, m10: torch.Tensor, force_reference: bool = False):
    """ORB's trig from each keypoint's int32 moments: (angle, sin, cos), the angle
    ``atan2f(m01, m10)`` of the moments as float32, then ``sinf(angle)`` and
    ``cosf_like_reference(angle)``, by the current mode.  In the freestanding
    mode one K21 launch computes all three (``fs_orient``)."""
    if _MODE == "freestanding":
        return fs_orient_plain(m01, m10) if force_reference else fs_orient(m01, m10)
    angle = atan2f(m01.to(torch.float32), m10.to(torch.float32), force_reference)
    return angle, sinf(angle, force_reference), cosf_like_reference(angle, force_reference)
