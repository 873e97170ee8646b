"""Perspective correction — ``gs_perspective_correct`` (grayskull.h:423-444),
bit-exact with ``grayskull_tpu.ops.warp``.

As in the reference, this is a **bilinear quad warp**, not a homography: page
pixel (u, v) interpolates linearly between the top edge c0→c1 and the bottom
edge c3→c2, in float32 with every operation rounded on its own, and the store
truncates like C's uint8 cast.  A CUDA tensor runs K10 ``quad_warp``, a CPU
tensor its plain version.
"""

from __future__ import annotations

import torch

from .. import profiling
from ..core import as_image, as_tensor
from ..kernels.warp import quad_warp, quad_warp_plain

__all__ = ["perspective_correct"]


@profiling.spanned("gs.ops.perspective_correct")
def perspective_correct(src, corners, size, force_reference: bool = False) -> torch.Tensor:
    """Warp the quad ``corners`` (TL, TR, BR, BL as integer (x, y) rows) to a
    ``size=(h, w)`` page.

    ``src`` is one (H, W) frame with (4, 2) corners, or an (N, H, W) batch with
    (4, 2) corners shared by every frame or (N, 4, 2) corners, one quad per
    frame.  Corners may lie outside the frame: the sample coordinates clamp.
    A page of one row or one column is ``src[0, 0]`` everywhere, as the JAX
    package's is (its grid divides 0 by 0).  ``force_reference=True`` runs the
    plain version on the tensor's device.
    """
    src = as_image(src)
    dev = src.device
    c = as_tensor(corners)
    if c.dtype.is_floating_point or c.dtype == torch.bool:
        raise TypeError(f"corners are integer points (gs_point), got {c.dtype}")
    c = c.to(device=dev, dtype=torch.int32)
    if tuple(c.shape[-2:]) != (4, 2) or c.ndim not in (2, 3):
        raise ValueError(f"corners must be (4, 2) or (N, 4, 2) (x, y) rows, got {tuple(c.shape)}")
    single = src.ndim == 2
    frames = (src[None] if single else src).contiguous()
    n = frames.shape[0]
    if c.ndim == 2:
        c = c.expand(n, 4, 2)
    elif single or c.shape[0] != n:
        raise ValueError(f"{tuple(c.shape)} corners for {tuple(src.shape)} frames")
    size = (int(size[0]), int(size[1]))
    warp = quad_warp_plain if force_reference else quad_warp
    out = warp(frames, c.contiguous(), size)
    return out[0] if single else out
