"""Keypoint-window kernels of ORB — disc moments and rBRIEF — with their plain versions.

Both replace the Pallas kernel ``grayskull_tpu/kernels/patches.py:99
_extract_pallas``, which cut one zero-padded 48x48 patch per keypoint at
``(x - 20, y - 20)`` for ``ops.features`` to reduce: the moments at
``features.py:495-512`` and rBRIEF at ``features.py:515-564``.  The port never
writes the ``(N, K, 48, 48)`` patch tensor; each kernel reads its window
straight from the frame, and a read outside the frame gives 0, as the patch's
zero padding does.

* :func:`orb_moments` (K7, ``csrc/patches.cu:gs_orb_moments``): ``(N, K)``
  keypoints to the int32 intensity moments ``m01 = sum dy*p`` and
  ``m10 = sum dx*p`` over the disc ``dx^2 + dy^2 <= radius^2``.
* :func:`orb_brief` (K8, ``csrc/patches.cu:gs_orb_brief``): keypoints and the
  float32 ``sin`` and ``cos`` of their angles to ``(N, K, 8)`` ``torch.uint32``
  words; bit i of word j is pair ``32*j + i`` of :data:`BRIEF_PATTERN`, set when
  the sample at ``(x + dx1, y + dy1)`` is brighter than the one at
  ``(x + dx2, y + dy2)``, with ``dx = (int)(px*cos - py*sin)`` and
  ``dy = (int)(px*sin + py*cos)``, every product and sum rounded to float32.

The trig stays out of the kernels (``libm32``), so that a trig mode gives the
same angles on the card as on the CPU.

The plain versions (:func:`extract_patches_plain`, :func:`orb_moments_plain`,
:func:`orb_brief_plain`) build the patches and reduce them exactly as
``features.py:484-564`` does.  A CUDA tensor launches the kernel or raises; a
CPU tensor runs the plain version.  ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import profiling
from . import _build
from .integral import from_int64
from .preproc import _check_frames

__all__ = ["BRIEF_PATTERN", "extract_patches_plain", "launches", "orb_brief", "orb_brief_plain",
           "orb_moments", "orb_moments_plain"]

launches = {"orb_moments": 0, "orb_brief": 0}

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                     "grayskull_tpu", "data", "brief_pattern.npy")
# 256 (x1, y1, x2, y2) BRIEF test pairs (grayskull.h:541-605), framework-neutral data
BRIEF_PATTERN = np.load(_DATA)
PATCH = 48      # patch side (features.py:_BRIEF_PATCH)
PATCH_PAD = 20  # the keypoint's offset in its patch; rotated offsets stay in [-20, 20]


@functools.lru_cache(maxsize=8)
def _device_pattern(device: torch.device) -> torch.Tensor:
    """:data:`BRIEF_PATTERN` as a (256, 4) float32 tensor on ``device``."""
    return torch.from_numpy(BRIEF_PATTERN.astype(np.float32)).to(device)


def _check_points(imgs: torch.Tensor, name: str, *coords: torch.Tensor) -> None:
    _check_frames(imgs, name)
    if coords[0].numel() >= 2**31 // 8:
        raise ValueError(f"{name}: at most {2**31 // 8 - 1} keypoints per call")
    for c in coords:
        if not isinstance(c, torch.Tensor) or c.dtype != torch.int32:
            raise TypeError(f"{name}: keypoint coordinates must be int32 tensors")
        if c.ndim != 2 or c.shape[0] != imgs.shape[0] or c.shape != coords[0].shape:
            raise ValueError(f"{name}: coordinates must be (N, K) for {imgs.shape[0]} frames, "
                             f"got {tuple(c.shape)}")
        if c.device != imgs.device or not c.is_contiguous():
            raise ValueError(f"{name}: coordinates must be contiguous, on the frames' device")


def _check_radius(radius: int) -> int:
    radius = int(radius)
    if not 0 <= radius <= PATCH_PAD:
        raise ValueError(f"orb_moments: radius must be in [0, {PATCH_PAD}], got {radius}")
    return radius


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def extract_patches_plain(imgs: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(N, H, W) uint8 + (N, K) keypoints -> (N, K, 48, 48) uint8 patches,
    ``patch[r, c] = frame[y - 20 + r, x - 20 + c]`` and 0 outside the frame."""
    n, h, w = imgs.shape
    off = torch.arange(PATCH, device=imgs.device) - PATCH_PAD
    rows = y.to(torch.int64)[..., None] + off  # (N, K, 48)
    cols = x.to(torch.int64)[..., None] + off
    ok = ((rows >= 0) & (rows < h))[..., :, None] & ((cols >= 0) & (cols < w))[..., None, :]
    flat = rows.clamp(0, h - 1)[..., :, None] * w + cols.clamp(0, w - 1)[..., None, :]
    vals = imgs.reshape(n, -1).gather(1, flat.reshape(n, -1)).view(flat.shape)
    return torch.where(ok, vals, 0)


def _disc_weights(radius: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(48, 48) int32 dy and dx weights of the disc inside a patch (features.py:502-508)."""
    dy, dx = np.mgrid[-PATCH_PAD: PATCH - PATCH_PAD, -PATCH_PAD: PATCH - PATCH_PAD]
    disc = dx * dx + dy * dy <= radius * radius
    return (torch.from_numpy(np.where(disc, dy, 0).astype(np.int32)).to(device),
            torch.from_numpy(np.where(disc, dx, 0).astype(np.int32)).to(device))


def orb_moments_plain(imgs: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      radius: int = 15) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`orb_moments`: the patches against two disc masks."""
    _check_points(imgs, "orb_moments_plain", x, y)
    wy, wx = _disc_weights(_check_radius(radius), imgs.device)
    p = extract_patches_plain(imgs, x, y).to(torch.int32)
    m01 = (p * wy).sum(dim=(-2, -1), dtype=torch.int32)
    m10 = (p * wx).sum(dim=(-2, -1), dtype=torch.int32)
    return m01, m10


def orb_brief_plain(imgs: torch.Tensor, x: torch.Tensor, y: torch.Tensor, sin: torch.Tensor,
                    cos: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`orb_brief` (``features.py:515-564``): the 512 rotated
    pattern endpoints, truncated toward zero, index each keypoint's patch; an
    index outside the patch reads 0."""
    _check_points(imgs, "orb_brief_plain", x, y)
    pat = _device_pattern(imgs.device)
    px = torch.cat([pat[:, 0], pat[:, 2]])  # (512,): the first endpoints, then the second
    py = torch.cat([pat[:, 1], pat[:, 3]])
    s, c = sin[..., None], cos[..., None]
    dx = (px * c - py * s).to(torch.int32) + PATCH_PAD  # each op rounds to float32
    dy = (px * s + py * c).to(torch.int32) + PATCH_PAD
    ok = (dx >= 0) & (dx < PATCH) & (dy >= 0) & (dy < PATCH)
    patches = extract_patches_plain(imgs, x, y).flatten(-2)
    idx = (dy.clamp(0, PATCH - 1) * PATCH + dx.clamp(0, PATCH - 1)).to(torch.int64)
    vals = torch.where(ok, patches.gather(-1, idx), 0)
    bits = (vals[..., :256] > vals[..., 256:]).to(torch.int64).unflatten(-1, (8, 32))
    weights = torch.ones((), dtype=torch.int64, device=imgs.device) << torch.arange(
        32, device=imgs.device)
    return from_int64((bits * weights).sum(-1))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


@profiling.spanned("gs.kernels.orb_moments")
def orb_moments(imgs: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                radius: int = 15) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: (N, H, W) uint8 + (N, K) int32 keypoints -> int32 ``(m01, m10)``, each (N, K)."""
    _check_points(imgs, "orb_moments", x, y)
    radius = _check_radius(radius)
    if not imgs.is_cuda:
        return orb_moments_plain(imgs, x, y, radius)
    n, h, w = imgs.shape
    k = x.shape[1]
    m01 = torch.empty((n, k), dtype=torch.int32, device=imgs.device)
    m10 = torch.empty((n, k), dtype=torch.int32, device=imgs.device)
    if k == 0:
        return m01, m10
    lib = _build.library()
    with torch.cuda.device(imgs.device):
        code = lib.gs_orb_moments(imgs.data_ptr(), x.data_ptr(), y.data_ptr(), m01.data_ptr(),
                                  m10.data_ptr(), n, h, w, k, radius, _build.stream_of(imgs))
    _build.check(code, "orb_moments")
    launches["orb_moments"] += 1
    return m01, m10


@profiling.spanned("gs.kernels.orb_brief")
def orb_brief(imgs: torch.Tensor, x: torch.Tensor, y: torch.Tensor, sin: torch.Tensor,
              cos: torch.Tensor) -> torch.Tensor:
    """K8: frames, (N, K) int32 keypoints, float32 sin and cos -> (N, K, 8) uint32 words."""
    _check_points(imgs, "orb_brief", x, y)
    for t in (sin, cos):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or t.shape != x.shape:
            raise TypeError("orb_brief: sin and cos must be float32 tensors shaped like x")
        if t.device != imgs.device or not t.is_contiguous():
            raise ValueError("orb_brief: sin and cos must be contiguous, on the frames' device")
    if not imgs.is_cuda:
        return orb_brief_plain(imgs, x, y, sin, cos)
    n, h, w = imgs.shape
    k = x.shape[1]
    desc = torch.empty((n, k, 8), dtype=torch.int32, device=imgs.device)
    if k == 0:
        return desc.view(torch.uint32)
    lib = _build.library()
    pattern = _device_pattern(imgs.device)
    with torch.cuda.device(imgs.device):
        code = lib.gs_orb_brief(imgs.data_ptr(), x.data_ptr(), y.data_ptr(), sin.data_ptr(),
                                cos.data_ptr(), pattern.data_ptr(), desc.data_ptr(), n, h, w, k,
                                _build.stream_of(imgs))
    _build.check(code, "orb_brief")
    launches["orb_brief"] += 1
    return desc.view(torch.uint32)
