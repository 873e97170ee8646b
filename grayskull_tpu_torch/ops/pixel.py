"""Dense pixel ops of the main path — ``threshold``, ``blur`` and ``sobel``
(grayskull.h:225-228, 268-283, 306-320), bit-exact with ``grayskull_tpu.ops.pixel``.

Each takes a uint8 ``(H, W)`` or ``(N, H, W)`` tensor (or numpy array, which
becomes a CPU tensor) and returns the same layout on the same device.  ``blur``
and ``sobel`` launch the port's kernels on a CUDA tensor and run their plain
versions on a CPU tensor; ``threshold`` is plain PyTorch everywhere.
"""

from __future__ import annotations

import torch

from ..core import as_image
from ..kernels.preproc import blur_hist, threshold_sobel

__all__ = ["blur", "sobel", "threshold"]


def _frames(img: torch.Tensor) -> torch.Tensor:
    return (img if img.ndim == 3 else img[None]).contiguous()


def threshold(img, thresh) -> torch.Tensor:
    """Global binarize ``pixel > t ? 255 : 0`` — ``gs_threshold`` (grayskull.h:225-228).

    ``thresh`` is a scalar, or for an (N, H, W) batch an (N,) vector with one
    threshold per frame; it is cast to uint8 like the JAX op's ``thresh``.
    """
    img = as_image(img)
    t = torch.as_tensor(thresh, device=img.device).to(torch.uint8)
    if img.ndim == 3 and t.ndim == 1:
        t = t.view(-1, 1, 1)
    return (img > t).to(torch.uint8) * 255


def blur(img, radius: int) -> torch.Tensor:
    """Clipped-window box mean with truncating division — ``gs_blur`` (grayskull.h:268-283)."""
    img = as_image(img)
    out, _ = blur_hist(_frames(img), radius, with_hist=False)
    return out.view(img.shape)


def sobel(img) -> torch.Tensor:
    """Sobel magnitude ``(|gx|+|gy|)/2`` on the interior, 1-pixel border 0 — ``gs_sobel``
    (grayskull.h:306-320)."""
    img = as_image(img)
    _, edges = threshold_sobel(_frames(img))
    return edges.view(img.shape)
