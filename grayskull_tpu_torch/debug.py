"""Debug utilities: image dumps, NaN guards, overlay rendering — the port of
``grayskull_tpu.debug`` with its names and defaults.

* :func:`dump` — write any (H, W) or (N, H, W) image array to auto-numbered PGMs;
* :func:`nan_guard` — a context manager that raises ``FloatingPointError`` when
  a torch function in the block returns a floating tensor holding a NaN (in
  place of JAX's ``jax_debug_nans``);
* :func:`draw_rects` / :func:`draw_crosses` — host-side overlays of detection
  tables or lists, drawn with the CLI's Bresenham :func:`~.cli.draw_line`.

Each function takes tensors on any device or numpy arrays; tables and images
come to the host with ``.cpu()`` and the results are numpy, as the JAX
package's are.  ``nan_guard`` checks every result, a host wait each: it is for
debugging, not for a path that is timed.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from . import io as gio
from .cli import draw_line

__all__ = ["dump", "nan_guard", "draw_rects", "draw_crosses"]

_counter = itertools.count()

# the JAX package's /tmp/grayskull_dumps, under the process's own temporary directory
DUMP_DIR = os.path.join(tempfile.gettempdir(), "grayskull_dumps")


def _host(a) -> np.ndarray:
    """``a`` as a numpy array: a tensor on any device comes back with ``.cpu()``."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def dump(arr, name: str = "dump", directory: str = DUMP_DIR) -> list[str]:
    """Write image array(s) as PGM(s); returns the written paths.

    A float image is scaled to 0..255 by its minimum and maximum, in numpy in
    its own dtype, as the JAX package does, so the files are byte-identical.
    """
    os.makedirs(directory, exist_ok=True)
    arr = _host(arr)
    if arr.dtype != np.uint8:
        lo, hi = arr.min(), arr.max()
        arr = ((arr - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
    frames = arr[None] if arr.ndim == 2 else arr
    paths = []
    for frame in frames:
        path = os.path.join(directory, f"{name}_{next(_counter):04d}.pgm")
        gio.write_pgm(frame, path)
        paths.append(path)
    return paths


# allocators return memory no op wrote: its bits may read as NaN
_ALLOCATORS = frozenset({torch.empty, torch.empty_like, torch.empty_strided,
                         torch.Tensor.new_empty, torch.Tensor.new_empty_strided})


def _nan_in(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_floating_point() and bool(torch.isnan(out).any())
    if isinstance(out, (tuple, list)):
        return any(_nan_in(o) for o in out)
    return False


class _NanGuard(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        # attribute reads (``t.data``) compute nothing
        if func in _ALLOCATORS or getattr(func, "__name__", "") == "__get__":
            return out
        if _nan_in(out):
            raise FloatingPointError(f"NaN produced by {getattr(func, '__name__', func)}")
        return out


@contextlib.contextmanager
def nan_guard():
    """Raise on NaN production inside the block (useful for float paths).

    Guards nest; leaving a block restores the guards that were active before it.
    """
    with _NanGuard():
        yield


def draw_rects(img, rects, color: int = 255) -> np.ndarray:
    """Overlay a Rects table (or iterable of (x, y, w, h)) on a copy of img."""
    out = _host(img).copy()
    if hasattr(rects, "n"):
        n = int(rects.n)
        items = zip(*(_host(v)[:n] for v in (rects.x, rects.y, rects.w, rects.h)))
    else:
        items = rects
    for (x, y, w, h) in items:
        x, y, w, h = int(x), int(y), int(w), int(h)
        draw_line(out, x, y, x + w, y, color)
        draw_line(out, x, y + h, x + w, y + h, color)
        draw_line(out, x, y, x, y + h, color)
        draw_line(out, x + w, y, x + w, y + h, color)
    return out


def draw_crosses(img, kps, color: int = 255, r: int = 2) -> np.ndarray:
    """Overlay a Keypoints table (or iterable of (x, y)) as crosses."""
    out = _host(img).copy()
    h, w = out.shape
    if hasattr(kps, "n"):
        n = int(kps.n)
        pts = zip(_host(kps.x)[:n], _host(kps.y)[:n])
    else:
        pts = kps
    for (x, y) in pts:
        x, y = int(x), int(y)
        for d in range(-r, r + 1):
            if 0 <= y + d < h and 0 <= x < w:
                out[y + d, x] = color
            if 0 <= y < h and 0 <= x + d < w:
                out[y, x + d] = color
    return out
