"""Face detection pipeline — ``faces()``
(the C reference's ``examples/nanomagick/nanomagick.c:347-376``).

integral -> multi-scale LBP cascade sweep (scales 1.0 -> 4.0 x1.2) -> the first
``max_rects`` detections in ladder order.  On a CUDA tensor that is one K4
launch, one K5 launch per ladder scale and a ``torch.topk`` emission, with no
host sync; on a CPU tensor the same wrappers run their plain versions.
:func:`detect_faces` is the span ``gs.pipelines.detect_faces``.

As in the JAX package, ``step`` is the window stride: the reference CLI passes
its ``min_neighbors`` argument there, and there is no neighbour grouping
(nanomagick.c:363-364).  Any frame size works.
"""

from __future__ import annotations

from .. import profiling
from ..cascade import load_frontalface
from ..core import LbpCascade, Rects, as_image
from ..kernels.integral import integral_plain
from ..ops.integral import integral
from ..ops.lbp import lbp_detect, lbp_warm_start

__all__ = ["detect_faces", "warm_start"]


@profiling.spanned("gs.pipelines.detect_faces")
def detect_faces(img, cascade: LbpCascade | None = None, max_rects: int = 100,
                 scale_factor=1.2, min_scale=1.0, max_scale=4.0, step: int = 1,
                 force_reference: bool = False) -> Rects:
    """Detect faces in a uint8 frame (or an (N, H, W) batch); returns a
    fixed-capacity :class:`Rects` table.

    ``force_reference=True`` runs the plain versions of the integral and of the
    cascade on the input's device, which is what the kernel path is held to.
    """
    if cascade is None:
        cascade = load_frontalface()
    img = as_image(img)
    if force_reference:
        frames = (img if img.ndim == 3 else img[None]).contiguous()
        ii = integral_plain(frames).view(img.shape)
    else:
        ii = integral(img)
    return lbp_detect(cascade, ii, max_rects, scale_factor, min_scale, max_scale, step,
                      force_reference=force_reference)


def warm_start(h: int, w: int, batch: int = 1, cascade: LbpCascade | None = None,
               max_rects: int = 100, scale_factor=1.2, min_scale=1.0,
               max_scale=4.0, step: int = 1, max_workers: int = 4) -> float:
    """Prepare :func:`detect_faces` for one frame geometry; returns seconds spent.

    Builds the kernel library and uploads the cascade and scale-plan tables for
    ``batch`` frames of ``h`` x ``w`` (see ``ops.lbp.lbp_warm_start``).  The
    port builds one library, with no per-scale programs to compile concurrently,
    so ``max_workers`` is accepted for the JAX signature and not used.
    """
    if cascade is None:
        cascade = load_frontalface()
    return lbp_warm_start(cascade, h, w, nb=batch, max_rects=max_rects,
                          scale_factor=scale_factor, min_scale=min_scale,
                          max_scale=max_scale, step=step)
