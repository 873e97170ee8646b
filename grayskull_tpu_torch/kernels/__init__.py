"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

* :mod:`.preproc` — K1 ``blur_hist`` (box blur + per-frame histogram),
  K2 ``threshold_sobel`` (per-frame binarize + interior Sobel), K11 ``adaptive``
  (mean-offset threshold on K1's window sum), K12 ``morph`` (3x3 erode or
  dilate), K13 ``filter3`` (the zero-padded 3x3 ``gs_filter``), and K15
  ``blur_hist_window`` and K16 ``threshold_sobel_window`` (K1 and K2 on one
  H-shard with its halo rows, at the frame's global rows)
* :mod:`.otsu` — K3 ``otsu`` (the bit-exact float32 Otsu sweep, a warp per frame)
* :mod:`.integral` — K4 ``integral`` (uint32 2-D prefix sum: row scan, column scan)
* :mod:`.lbp` — K5 ``lbp_eval_scale`` (one ladder scale of the LBP cascade, a
  thread per window with early exit)
* :mod:`.fast` — K6 ``fast`` (FAST-9 score map, 3x3 NMS, packed scan-order keys)
* :mod:`.patches` — K7 ``orb_moments`` (disc moments, a warp per keypoint) and
  K8 ``orb_brief`` (rBRIEF words, a ballot per word)
* :mod:`.ccl` — K9 ``ccl`` (4-connected component minima by union-find)
* :mod:`.warp` — K10 ``quad_warp`` (the bilinear quad warp, a thread per page pixel)
  and ``quad_warp_rows`` (a band of a page's rows, the same kernel)
* :mod:`.resize` — K14 ``resize`` (the bilinear resize, a thread per output pixel)
* :mod:`.bandwidth` — K17 ``copy`` and K18 ``triad`` (the device-memory
  bandwidth probe, 16 bytes a thread)
* :mod:`.template` — K19 ``match_template`` (the exact SSD of every placement:
  the correlation on int8 tensor cores, narrow templates four bytes an
  instruction)
* :mod:`.contour` — K20 ``contour`` (the Moore walks of a call, a warp each and
  side by side, one ballot a step)
* :mod:`.freestanding` — K21 ``fs_orient``, ``fs_atan2`` and ``fs_sin`` (the
  reference's ``GS_NO_STDLIB`` trig of the ``freestanding`` mode: ORB's angle,
  sine and cosine from int32 moments in one launch; each element's range
  reduction in its own loop)
* :mod:`.blobs` — K22 ``blob_stats`` (each label's area, coordinate sums and box
  over a batch of label maps: a table of every label in each block's shared
  memory, one atomic a label and field at the end; global atomics where the
  table does not fit)
* :mod:`._build` — ``nvcc`` build of ``csrc/*.cu`` on first use, ``ctypes`` binding

A wrapper launches its kernel for a CUDA tensor (or raises) and runs the plain
version for a CPU tensor.  :func:`launch_counts` reads how often each kernel was
launched; :func:`reset_launch_counts` sets every count to 0.  Each wrapper that
counts is also the span ``gs.kernels.<key>`` of its count's key
(``profiling.spanned``): its checks, allocations, the library's load and the
launch.
"""

from . import bandwidth as _bandwidth_mod
from . import blobs as _blobs_mod
from . import ccl as _ccl_mod
from . import contour as _contour_mod
from . import fast as _fast_mod
from . import freestanding as _freestanding_mod
from . import integral as _integral_mod
from . import lbp as _lbp_mod
from . import otsu as _otsu_mod
from . import patches as _patches_mod
from . import preproc as _preproc_mod
from . import resize as _resize_mod
from . import template as _template_mod
from . import warp as _warp_mod
from .bandwidth import copy, copy_plain, triad, triad_plain  # noqa: F401
from .blobs import blob_stats, blob_stats_plain  # noqa: F401
from .ccl import ccl, ccl_plain  # noqa: F401
from .contour import contour, contour_plain  # noqa: F401
from .fast import fast, fast_plain  # noqa: F401
from .freestanding import (fs_atan2, fs_atan2_plain, fs_orient, fs_orient_plain,  # noqa: F401
                           fs_sin, fs_sin_plain)
from .integral import integral, integral_plain  # noqa: F401
from .lbp import lbp_eval_scale, lbp_eval_scale_plain  # noqa: F401
from .otsu import otsu, otsu_plain  # noqa: F401
from .patches import (extract_patches_plain, orb_brief, orb_brief_plain,  # noqa: F401
                      orb_moments, orb_moments_plain)
from .preproc import (adaptive, adaptive_plain, blur_hist, blur_hist_plain,  # noqa: F401
                      blur_hist_window, blur_hist_window_plain, filter3, filter3_plain,
                      filter_plain, frame_histograms, morph, morph_plain, sobel_plain,
                      threshold_sobel, threshold_sobel_plain, threshold_sobel_window,
                      threshold_sobel_window_plain)
from .resize import resize, resize_plain  # noqa: F401
from .template import match_template, match_template_plain  # noqa: F401
from .warp import quad_warp, quad_warp_plain, quad_warp_rows, quad_warp_rows_plain  # noqa: F401

__all__ = [
    "adaptive",
    "adaptive_plain",
    "blob_stats",
    "blob_stats_plain",
    "blur_hist",
    "blur_hist_plain",
    "blur_hist_window",
    "blur_hist_window_plain",
    "ccl",
    "ccl_plain",
    "contour",
    "contour_plain",
    "copy",
    "copy_plain",
    "extract_patches_plain",
    "fast",
    "fast_plain",
    "filter3",
    "filter3_plain",
    "filter_plain",
    "frame_histograms",
    "fs_atan2",
    "fs_atan2_plain",
    "fs_orient",
    "fs_orient_plain",
    "fs_sin",
    "fs_sin_plain",
    "integral",
    "integral_plain",
    "launch_counts",
    "lbp_eval_scale",
    "lbp_eval_scale_plain",
    "match_template",
    "match_template_plain",
    "morph",
    "morph_plain",
    "orb_brief",
    "orb_brief_plain",
    "orb_moments",
    "orb_moments_plain",
    "otsu",
    "otsu_plain",
    "quad_warp",
    "quad_warp_plain",
    "quad_warp_rows",
    "quad_warp_rows_plain",
    "reset_launch_counts",
    "resize",
    "resize_plain",
    "sobel_plain",
    "threshold_sobel",
    "threshold_sobel_plain",
    "threshold_sobel_window",
    "threshold_sobel_window_plain",
    "triad",
    "triad_plain",
]

_COUNTERS = (_preproc_mod.launches, _otsu_mod.launches, _integral_mod.launches,
             _lbp_mod.launches, _fast_mod.launches, _patches_mod.launches, _ccl_mod.launches,
             _warp_mod.launches, _resize_mod.launches, _bandwidth_mod.launches,
             _template_mod.launches, _contour_mod.launches, _freestanding_mod.launches,
             _blobs_mod.launches)


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    out = {}
    for counter in _COUNTERS:
        out.update(counter)
    return out


def reset_launch_counts() -> None:
    for counter in _COUNTERS:
        for name in counter:
            counter[name] = 0
