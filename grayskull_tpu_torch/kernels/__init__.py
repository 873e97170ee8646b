"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

* :mod:`.preproc` — K1 ``blur_hist`` (box blur + per-frame histogram) and
  K2 ``threshold_sobel`` (per-frame binarize + interior Sobel)
* :mod:`.otsu` — K3 ``otsu`` (the bit-exact float32 Otsu sweep, a thread per frame)
* :mod:`._build` — ``nvcc`` build of ``csrc/*.cu`` on first use, ``ctypes`` binding

A wrapper launches its kernel for a CUDA tensor (or raises) and runs the plain
version for a CPU tensor.  :func:`launch_counts` reads how often each kernel was
launched; :func:`reset_launch_counts` sets every count to 0.
"""

from . import otsu as _otsu_mod
from . import preproc as _preproc_mod
from .otsu import otsu, otsu_plain  # noqa: F401
from .preproc import (blur_hist, blur_hist_plain, frame_histograms,  # noqa: F401
                      sobel_plain, threshold_sobel, threshold_sobel_plain)

__all__ = [
    "blur_hist",
    "blur_hist_plain",
    "frame_histograms",
    "launch_counts",
    "otsu",
    "otsu_plain",
    "reset_launch_counts",
    "sobel_plain",
    "threshold_sobel",
    "threshold_sobel_plain",
]

_COUNTERS = (_preproc_mod.launches, _otsu_mod.launches)


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    out = {}
    for counter in _COUNTERS:
        out.update(counter)
    return out


def reset_launch_counts() -> None:
    for counter in _COUNTERS:
        for name in counter:
            counter[name] = 0
