"""Dense pixel ops — grayskull's L2 layer (grayskull.h:150-320), bit-exact with
``grayskull_tpu.ops.pixel``, with its names and signatures.

Each takes a uint8 ``(H, W)`` or ``(N, H, W)`` tensor (or numpy array, which
goes to the CUDA device) and returns the same layout on the same device.  On a
CUDA tensor ``blur``, ``sobel``, ``adaptive_threshold``, ``erode``, ``dilate``,
``resize`` and a 3x3 ``filter2d`` (with its presets) launch the port's kernels;
on a CPU tensor they run the plain versions.  ``crop``, ``copy``,
``resize_nn``, ``threshold``, ``downsample`` and a ``filter2d`` of any other
size are plain PyTorch everywhere, as the JAX package leaves them to XLA.

Borders differ per op, as in the reference: ``blur``, ``adaptive_threshold``,
``erode`` and ``dilate`` clip the window at the frame's edge; ``filter2d``
reads 0 outside the frame (``gs_get``); ``sobel`` computes the interior only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import as_image
from ..kernels.preproc import adaptive, blur_hist, filter3, filter_plain, morph, threshold_sobel
from ..kernels.resize import resize as _resize_kernel

__all__ = [
    "BLUR_BOX_KERNEL",
    "BLUR_GAUSSIAN_KERNEL",
    "EMBOSS_KERNEL",
    "SHARPEN_KERNEL",
    "adaptive_threshold",
    "blur",
    "blur_box",
    "blur_gaussian",
    "copy",
    "crop",
    "dilate",
    "downsample",
    "emboss",
    "erode",
    "filter",
    "filter2d",
    "resize",
    "resize_nn",
    "sharpen",
    "sobel",
    "threshold",
]


def _frames(img: torch.Tensor) -> torch.Tensor:
    return (img if img.ndim == 3 else img[None]).contiguous()


def crop(img, roi) -> torch.Tensor:
    """ROI copy — ``gs_crop`` (grayskull.h:154-158); ``roi`` is ``(x, y, w, h)`` ints."""
    img = as_image(img)
    x, y, w, h = (int(v) for v in roi[:4])
    if x < 0 or y < 0 or w <= 0 or h <= 0:
        raise ValueError(f"invalid crop rect {tuple(roi)}")
    H, W = img.shape[-2:]
    if x + w > W or y + h > H:
        raise ValueError(f"crop rect {tuple(roi)} exceeds image {W}x{H}")
    return img[..., y : y + h, x : x + w].clone(memory_format=torch.contiguous_format)


def copy(img) -> torch.Tensor:
    """``gs_copy`` (grayskull.h:160-162): a new tensor with the same pixels."""
    return as_image(img).clone()


def resize_nn(img, size) -> torch.Tensor:
    """Nearest-neighbour resize — ``gs_resize_nn`` (grayskull.h:164-169): output
    pixel ``(y, x)`` reads ``(y * sh // dh, x * sw // dw)``.  ``size`` is ``(h, w)``."""
    img = as_image(img)
    dh, dw = int(size[0]), int(size[1])
    sh, sw = img.shape[-2:]
    sy = torch.arange(dh, device=img.device) * sh // dh
    sx = torch.arange(dw, device=img.device) * sw // dw
    return img.index_select(-2, sy).index_select(-1, sx)


def resize(img, size) -> torch.Tensor:
    """Bilinear resize with half-pixel centres — ``gs_resize`` (grayskull.h:171-187).

    ``size`` is ``(h, w)``.  Float32 in the reference's operation order; the
    store truncates toward zero like the C uint8 cast.
    """
    img = as_image(img)
    out = _resize_kernel(_frames(img), size)
    return out if img.ndim == 3 else out[0]


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


def adaptive_threshold(img, radius: int, c) -> torch.Tensor:
    """Mean-offset adaptive threshold — ``gs_adaptive_threshold`` (grayskull.h:230-247).

    ``threshold = sum / count - c`` with C's unsigned division over the clipped
    window, then an int32 subtraction; the output is ``src > threshold ? 255 : 0``.
    ``c`` is an int.
    """
    img = as_image(img)
    return adaptive(_frames(img), radius, c).view(img.shape)


def blur(img, radius: int) -> torch.Tensor:
    """Clipped-window box mean with truncating division — ``gs_blur`` (grayskull.h:268-283)."""
    img = as_image(img)
    out, _ = blur_hist(_frames(img), radius, with_hist=False)
    return out.view(img.shape)


# Kernel presets (grayskull.h:249-253): int8 weights (the reference stores them
# as uint8 and reinterprets, grayskull.h:261) and the divisor.
SHARPEN_KERNEL = (np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]], np.int8), 1)
EMBOSS_KERNEL = (np.array([[-2, -1, 0], [-1, 1, 1], [0, 1, 2]], np.int8), 1)
BLUR_BOX_KERNEL = (np.ones((3, 3), np.int8), 9)
BLUR_GAUSSIAN_KERNEL = (np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.int8), 16)


def filter2d(img, kernel, norm: int) -> torch.Tensor:
    """Correlation with zero-padded borders — ``gs_filter`` (grayskull.h:255-266).

    Two C quirks, exactly: a uint8 kernel image is reinterpreted as int8 weights;
    ``sum / norm`` is unsigned division, so a negative sum with ``norm > 1``
    wraps to a huge value and clamps to 255.  A 3x3 kernel runs K13; any other
    size runs the plain int32 formula on the image's device, as the JAX package
    leaves kernels other than 3x3 to XLA.
    """
    kernel = np.asarray(kernel)
    if kernel.dtype == np.uint8:
        kernel = kernel.astype(np.int8)
    kernel = kernel.astype(np.int32)
    kh, kw = kernel.shape
    norm = int(norm)
    if norm <= 0:
        raise ValueError("norm must be > 0")
    img = as_image(img)
    taps = kernel.tolist()
    if (kh, kw) == (3, 3):
        out = filter3(_frames(img), taps, norm)
    else:
        out = filter_plain(_frames(img), taps, norm)
    return out.view(img.shape)


filter = filter2d  # the reference's name (shadows the builtin only inside this module)


def sharpen(img) -> torch.Tensor:
    """``gs_sharpen`` preset filter (grayskull.h:249)."""
    return filter2d(img, *SHARPEN_KERNEL)


def emboss(img) -> torch.Tensor:
    """``gs_emboss`` preset filter (grayskull.h:250)."""
    return filter2d(img, *EMBOSS_KERNEL)


def blur_box(img) -> torch.Tensor:
    """``gs_blur_box`` preset filter (grayskull.h:251)."""
    return filter2d(img, *BLUR_BOX_KERNEL)


def blur_gaussian(img) -> torch.Tensor:
    """``gs_blur_gaussian`` preset filter (grayskull.h:252-253)."""
    return filter2d(img, *BLUR_GAUSSIAN_KERNEL)


def erode(img) -> torch.Tensor:
    """3x3 min filter with clipped borders — ``gs_erode`` (grayskull.h:286-303)."""
    img = as_image(img)
    return morph(_frames(img), "erode").view(img.shape)


def dilate(img) -> torch.Tensor:
    """3x3 max filter with clipped borders — ``gs_dilate`` (grayskull.h:286-304)."""
    img = as_image(img)
    return morph(_frames(img), "dilate").view(img.shape)


def sobel(img) -> torch.Tensor:
    """Sobel magnitude ``(|gx|+|gy|)/2`` on the interior, 1-pixel border 0 — ``gs_sobel``
    (grayskull.h:306-320)."""
    img = as_image(img)
    _, edges = threshold_sobel(_frames(img))
    return edges.view(img.shape)


def downsample(img) -> torch.Tensor:
    """2x box downsample, integer ``sum // 4`` of each 2x2 block, an odd last row or
    column dropped — ``gs_downsample`` (grayskull.h:189-197)."""
    img = as_image(img)
    h, w = img.shape[-2:]
    x = img[..., : h // 2 * 2, : w // 2 * 2].to(torch.int32)
    s = x[..., 0::2, 0::2] + x[..., 0::2, 1::2] + x[..., 1::2, 0::2] + x[..., 1::2, 1::2]
    return (s // 4).to(torch.uint8)
