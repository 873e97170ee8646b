"""Document scanner pipeline — ``scan`` (nanomagick.c:186-210), bit-exact with
``grayskull_tpu.pipelines.scan``:

    blur(1) -> threshold(otsu + 10) -> blobs -> largest blob -> corners -> quad warp

On a CUDA tensor every frame of the batch goes through one launch of each
kernel, with no host sync: K1 ``blur_hist`` (blur + histogram), K3 ``otsu``,
K9 ``ccl`` inside :func:`~grayskull_tpu_torch.ops.blobs.blobs`, then K10
``quad_warp`` on the original frames.  ``force_reference=True`` runs the plain
versions on the tensor's device.
"""

from __future__ import annotations

import torch

from .. import profiling
from ..core import Point, Rect
from ..kernels.otsu import otsu, otsu_plain
from ..kernels.preproc import blur_hist, blur_hist_plain
from ..ops.blobs import _frames, blob_corners, blobs
from ..ops.warp import perspective_correct

__all__ = ["preprocess_binarize", "scan"]


@profiling.spanned("gs.pipelines.scan.binarize")
def _binarize(frames: torch.Tensor, force_reference: bool) -> torch.Tensor:
    h, w = frames.shape[-2:]
    if force_reference:
        blurred, hist = blur_hist_plain(frames, 1)
        t = otsu_plain(hist, h * w)
    else:
        blurred, hist = blur_hist(frames, 1)
        t = otsu(hist, h * w)
    # C passes otsu + 10 through a uint8 parameter (nanomagick.c:191): it wraps
    t = ((t.to(torch.int32) + 10) % 256).to(torch.uint8)
    return (blurred > t.view(-1, 1, 1)).to(torch.uint8) * 255


def preprocess_binarize(img, force_reference: bool = False) -> torch.Tensor:
    """blur(1) -> threshold(otsu + 10), the scanner's binarization stage; the
    threshold wraps mod 256 as the reference's uint8 parameter does."""
    frames, single = _frames(img)
    out = _binarize(frames, force_reference)
    return out[0] if single else out


@profiling.spanned("gs.pipelines.scan")
def scan(img, out_size=(1000, 800), max_blobs: int = 1000, force_reference: bool = False):
    """Scan document photo(s) to rectified ``out_size=(h, w)`` pages.

    Returns ``(page, corners)``: (h, w) uint8 and (4, 2) int32 for one frame,
    (N, h, w) and (N, 4, 2) for a batch.  The reference CLI's page is 800x1000
    (nanomagick.c:204) and its blob capacity 1000 (nanomagick.c:194).  The
    largest blob is the first of the largest areas (nanomagick.c:197-199); a
    frame with no blob warps from its centroid corners, as the JAX package
    does.
    """
    if int(max_blobs) < 1:  # the largest blob of an empty table (JAX: argmax of nothing)
        raise ValueError(f"scan needs max_blobs >= 1, got {max_blobs}")
    frames, single = _frames(img)
    out_size = (int(out_size[0]), int(out_size[1]))
    binary = _binarize(frames, force_reference)
    table, labels, _ = blobs(binary, max_blobs, force_reference=force_reference)
    largest = table.area.argmax(1, keepdim=True)

    def pick(v):
        return v.gather(1, largest).view(-1)

    corners = blob_corners(binary, labels, pick(table.label), Rect(*map(pick, table.box)),
                           Point(*map(pick, table.centroid)))
    pages = perspective_correct(frames, corners, out_size, force_reference=force_reference)
    if single:
        return pages[0], corners[0]
    return pages, corners
