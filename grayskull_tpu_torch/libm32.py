"""float32 ``atan2f`` / ``sinf`` of the ORB orientation and descriptor path.

The reference calls libm's ``atan2f`` and ``sinf`` (grayskull.h:100-101), so its
bits depend on the libm it was linked against.  Two modes, as in
``grayskull_tpu.libm32``:

* **fast** (the default): float64 on the tensor's own device, rounded to
  float32.  No host round-trip.  On the CPU this equals the JAX package's fast
  mode; CUDA's float64 ``atan2`` is not glibc's, so an angle on the card may
  differ from the CPU's by an ulp.
* **exact_host**: the process's own libm through :mod:`ctypes`, element by
  element, bit-identical to the C reference built on this machine.  Each call
  copies its input to the host and the result back, one round-trip, as the
  JAX package's ``pure_callback`` does; it is the mode of the parity tests.

The JAX package's third mode, ``freestanding`` (the reference's
``GS_NO_STDLIB`` polynomials), is not ported yet.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np
import torch

__all__ = ["atan2f", "cosf_like_reference", "exact_mode", "sinf", "trig_mode",
           "use_exact_host_libm"]

_MODE = "fast"  # "fast" | "exact_host"


def exact_mode() -> bool:
    """True when the bit-exact host-libm mode is active."""
    return _MODE != "fast"


def trig_mode() -> str:
    return _MODE


def use_exact_host_libm(enable: bool = True) -> None:
    """Toggle bit-exact host-libm trig (the parity tests' mode)."""
    global _MODE
    _MODE = "exact_host" if enable else "fast"


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


def atan2f(y, x) -> torch.Tensor:
    """``atan2f(y, x)`` in float32, by the current mode."""
    y, x = torch.broadcast_tensors(_as_f32(y, x), _as_f32(x, y))
    if _MODE == "exact_host":
        return _on_host(_get_libm().atan2f, y.contiguous(), x.contiguous())
    return torch.atan2(y.to(torch.float64), x.to(torch.float64)).to(torch.float32)


def sinf(x) -> torch.Tensor:
    """``sinf(x)`` in float32, by the current mode."""
    x = _as_f32(x)
    if _MODE == "exact_host":
        return _on_host(_get_libm().sinf, x)
    return torch.sin(x.to(torch.float64)).to(torch.float32)


def cosf_like_reference(x) -> torch.Tensor:
    """The reference's cosine, ``gs_sin(angle + 1.57079f)`` (grayskull.h:626): the add
    rounds to float32 and the constant is truncated, so this is not ``cos(angle)``."""
    # the float32 constant as an exact Python float: the add rounds once to float32,
    # and no tensor is copied to the device (a host sync)
    return sinf(_as_f32(x) + float(np.float32(1.57079)))
