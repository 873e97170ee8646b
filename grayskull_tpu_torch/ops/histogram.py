"""Histogram and Otsu threshold — ``gs_histogram`` / ``gs_otsu_threshold``
(grayskull.h:199-223), bit-exact with ``grayskull_tpu.ops.histogram``.

Histograms are ``torch.int32`` (the JAX package returns uint32; torch's uint32
lacks most ops).  Otsu's float32 sweep runs in C's order: on a CUDA tensor in
the K3 kernel, on a CPU tensor in its plain version.
"""

from __future__ import annotations

import torch

from ..core import as_image
from ..kernels.otsu import otsu
from ..kernels.preproc import frame_histograms

__all__ = ["histogram", "otsu_from_histogram", "otsu_threshold"]


def histogram(img) -> torch.Tensor:
    """256-bin histogram: (H, W) -> (256,), (N, H, W) -> (N, 256), int32 counts."""
    img = as_image(img)
    if img.ndim == 2:
        return frame_histograms(img[None])[0]
    return frame_histograms(img)


def otsu_from_histogram(hist, total) -> torch.Tensor:
    """Otsu sweep over histogram(s) (..., 256) with ``total`` pixels each -> uint8 (...)."""
    hist = torch.as_tensor(hist)
    if hist.shape[-1:] != (256,):
        raise ValueError(f"expected (..., 256) histograms, got {tuple(hist.shape)}")
    flat = hist.reshape(-1, 256).to(torch.int32).contiguous()
    return otsu(flat, int(total)).view(hist.shape[:-1])


def otsu_threshold(img) -> torch.Tensor:
    """Otsu's threshold — ``gs_otsu_threshold``: a uint8 scalar, or (N,) for a batch."""
    img = as_image(img)
    h, w = img.shape[-2:]
    return otsu_from_histogram(histogram(img), h * w)
