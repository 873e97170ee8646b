"""Preprocessing pipeline — the benchmark headline:

    blur(r) -> Otsu -> threshold -> sobel        (BASELINE.json config #1 + sobel)

On a CUDA tensor this is three kernel launches with no host sync between them:
K1 ``blur_hist`` (blur + per-frame histogram), K3 ``otsu`` (thresholds stay on
the device) and K2 ``threshold_sobel`` (binarize + Sobel).  On a CPU tensor the
same wrappers run their plain versions.  ``preprocess_reference`` composes the
plain versions alone, on the tensor's device, and is what the kernel path is
checked against.  Both are bit-exact with ``grayskull_tpu.pipelines.preproc``.
"""

from __future__ import annotations

from .. import profiling
from ..core import as_image
from ..kernels.otsu import otsu, otsu_plain
from ..kernels.preproc import (blur_hist, blur_hist_plain, frame_histograms,
                               threshold_sobel, threshold_sobel_plain)

__all__ = ["preprocess", "preprocess_reference"]


def _unbatch(out, single: bool):
    if not single:
        return out
    return tuple(None if v is None else v[0] for v in out)


def preprocess_reference(imgs, radius: int = 2, want_binary: bool = True):
    """Plain-ops path on the input's device: ``(blurred, binary or None, edges, t)``."""
    imgs = as_image(imgs)
    single = imgs.ndim == 2
    batch = (imgs[None] if single else imgs).contiguous()
    h, w = batch.shape[-2:]
    blurred, _ = blur_hist_plain(batch, radius, with_hist=False)
    t = otsu_plain(frame_histograms(blurred), h * w)
    binary, edges = threshold_sobel_plain(blurred, t, want_binary)
    return _unbatch((blurred, binary, edges, t), single)


@profiling.spanned("gs.pipelines.preprocess")
def preprocess(imgs, radius: int = 2, force_reference: bool = False,
               want_binary: bool = True):
    """blur -> otsu -> threshold -> sobel.  (N, H, W) or (H, W) uint8.

    Returns ``(blurred, binary, edges, thresholds)``; a single (H, W) frame gives
    unbatched outputs.  ``want_binary=False`` returns ``binary=None`` and skips
    its write.  ``force_reference=True`` runs :func:`preprocess_reference`.
    """
    if force_reference:
        return preprocess_reference(imgs, radius, want_binary)
    imgs = as_image(imgs)
    single = imgs.ndim == 2
    batch = (imgs[None] if single else imgs).contiguous()
    h, w = batch.shape[-2:]
    blurred, hist = blur_hist(batch, radius)
    t = otsu(hist, h * w)
    binary, edges = threshold_sobel(blurred, t, want_binary)
    return _unbatch((blurred, binary, edges, t), single)

