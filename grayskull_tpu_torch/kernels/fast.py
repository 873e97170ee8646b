"""FAST-9 score map, 3x3 NMS and packed scan-order keys, with the plain version.

:func:`fast` (K6, ``csrc/fast.cu:gs_fast``) replaces the Pallas kernel
``grayskull_tpu/kernels/fast.py:207 _fast_call`` (``fast_pallas`` and its
``_compact`` / ``_lean`` forms).  It takes ``(N, H, W)`` uint8 frames and a
threshold and returns ``(score, key)``:

* ``score``: the ``(N, H, W)`` uint8 FAST score map (``gs_fast`` pass 1,
  grayskull.h:489-515), or None unless ``want_score``;
* ``key``: ``(N, H, W)``, ``(h*w - raster_index) << 8 | score`` at the 3x3-NMS
  maxima of the interior and 0 elsewhere, so the largest keys are the first
  corners in raster order with their scores packed in.  It is int32 when
  ``h*w < 2^23`` (the JAX package's packing) and int64 above, where the int32
  packing would overflow.

The TPU kernel's fold compaction (``_fold_compact``) only fed
``approx_max_k``; the port emits with ``torch.topk`` over the key map and has
no counterpart.  A negative threshold clamps to 0, as ``ops.features.fast``
does.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
:func:`fast_plain`.  ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from .. import profiling
from . import _build
from .preproc import _check_frames

__all__ = ["fast", "fast_plain", "launches"]

launches = {"fast": 0}

# FAST Bresenham circle of radius 3 (grayskull.h:485-486)
_CIRCLE_DX = (0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1)
_CIRCLE_DY = (-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3)
_PACKED_LIMIT = 1 << 23  # h*w below this packs into int32 (features.py:320-326)


def _key_dtype(h: int, w: int) -> torch.dtype:
    """The key map's dtype for an ``h`` x ``w`` frame."""
    return torch.int32 if h * w < _PACKED_LIMIT else torch.int64


def _threshold(threshold) -> int:
    return min(max(int(threshold), 0), 2**31 - 1)  # C's unsigned, as a non-negative int32


def _run9(mask: torch.Tensor) -> torch.Tensor:
    """A run of >= 9 set bits in the 16-bit ``mask`` read circularly (16 + 9 samples)."""
    x = mask | ((mask & 0x1FF) << 16)
    m1 = x & (x >> 1)
    m2 = m1 & (m1 >> 2)
    m4 = m2 & (m2 >> 4)
    return (m4 & (x >> 8)) != 0


def fast_plain(imgs: torch.Tensor, threshold, want_score: bool = False):
    """Plain version of :func:`fast`, computed as ``ops.features._fast_score_slab``
    and ``ops.features.fast`` compute it: 16 shifted views of the frame in int64
    (C's unsigned compares mirrored by an explicit wrap), the run of 9 as a
    bitmask fold, the minimum |v - p| over the whole circle, the 3-pixel
    interior, then a 3x3 NMS where only a strictly greater neighbour suppresses
    and neighbours outside the frame read 0.
    """
    _check_frames(imgs, "fast_plain")
    n, h, w = imgs.shape
    thr = _threshold(threshold)
    wrap = 1 << 32
    p = imgs.to(torch.int64)
    pad = torch.nn.functional.pad(p, (3, 3, 3, 3))
    hi = p + thr
    lo = (p - thr) % wrap  # uint32 p - thr wraps when p < thr
    bright_bits = torch.zeros_like(p)
    dark_bits = torch.zeros_like(p)
    min_diff = torch.full_like(p, 255)
    for k, (dx, dy) in enumerate(zip(_CIRCLE_DX, _CIRCLE_DY)):
        v = pad[:, 3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w]
        bright = v > hi
        dark = ~bright & (v < lo)  # the C else-if: bright wins when both hold
        bright_bits |= bright.to(torch.int64) << k
        dark_bits |= dark.to(torch.int64) << k
        min_diff = torch.minimum(min_diff, (v - p).abs())
    corner = _run9(bright_bits) | _run9(dark_bits)
    ys = torch.arange(h, device=imgs.device).view(h, 1)
    xs = torch.arange(w, device=imgs.device).view(1, w)
    interior = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    score = torch.where(corner & interior, min_diff, 0)

    sp = torch.nn.functional.pad(score, (1, 1, 1, 1))
    is_max = score > 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx or dy:
                is_max &= ~(sp[:, 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w] > score)
    idx = torch.arange(h * w, device=imgs.device, dtype=torch.int64).view(h, w)
    key = torch.where(is_max, ((h * w - idx) << 8) | score, 0).to(_key_dtype(h, w))
    return (score.to(torch.uint8) if want_score else None), key


@profiling.spanned("gs.kernels.fast")
def fast(imgs: torch.Tensor, threshold, want_score: bool = False):
    """K6: (N, H, W) uint8 frames + threshold -> (score uint8 or None, packed keys)."""
    _check_frames(imgs, "fast")
    if not imgs.is_cuda:
        return fast_plain(imgs, threshold, want_score)
    n, h, w = imgs.shape
    if h * w >= 2**31:
        raise ValueError(f"fast: frames of < 2^31 pixels, got {tuple(imgs.shape)}")
    lib = _build.library()
    score = torch.empty((n, h, w), dtype=torch.uint8, device=imgs.device) if want_score else None
    key = torch.empty((n, h, w), dtype=_key_dtype(h, w), device=imgs.device)
    with torch.cuda.device(imgs.device):
        code = lib.gs_fast(imgs.data_ptr(), score.data_ptr() if want_score else None,
                           key.data_ptr(), n, h, w, _threshold(threshold),
                           int(key.dtype == torch.int64), _build.stream_of(imgs))
    _build.check(code, "fast")
    launches["fast"] += 1
    return score, key
