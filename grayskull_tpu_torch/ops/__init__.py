"""Op layer: the ported ``gs_*`` ops on uint8 tensors."""

from .blobs import blob_corners, blobs, label_components  # noqa: F401
from .contour import Contours, find_contours, largest_blob_contour, trace_contour  # noqa: F401
from .features import (BRIEF_PATTERN, brief_descriptor, compute_orientation, fast,  # noqa: F401
                       fast_scoremap, hamming_distance, match_orb, orb_extract)
from .histogram import histogram, otsu_from_histogram, otsu_threshold  # noqa: F401
from .integral import integral, integral_sum  # noqa: F401
from .lbp import lbp_detect, lbp_warm_start, lbp_window, scale_ladder  # noqa: F401
from .pixel import (BLUR_BOX_KERNEL, BLUR_GAUSSIAN_KERNEL, EMBOSS_KERNEL,  # noqa: F401
                    SHARPEN_KERNEL, adaptive_threshold, blur, blur_box, blur_gaussian, copy, crop,
                    dilate, downsample, emboss, erode, filter2d, resize, resize_nn, sharpen, sobel,
                    threshold)
from .template import find_best_match, match_template  # noqa: F401
from .warp import perspective_correct  # noqa: F401

__all__ = [
    "BLUR_BOX_KERNEL",
    "BLUR_GAUSSIAN_KERNEL",
    "BRIEF_PATTERN",
    "Contours",
    "EMBOSS_KERNEL",
    "SHARPEN_KERNEL",
    "adaptive_threshold",
    "blob_corners",
    "blobs",
    "blur",
    "blur_box",
    "blur_gaussian",
    "brief_descriptor",
    "compute_orientation",
    "copy",
    "crop",
    "dilate",
    "downsample",
    "emboss",
    "erode",
    "fast",
    "fast_scoremap",
    "filter2d",
    "find_best_match",
    "find_contours",
    "hamming_distance",
    "histogram",
    "integral",
    "integral_sum",
    "label_components",
    "largest_blob_contour",
    "lbp_detect",
    "lbp_warm_start",
    "lbp_window",
    "match_orb",
    "match_template",
    "orb_extract",
    "otsu_from_histogram",
    "otsu_threshold",
    "perspective_correct",
    "resize",
    "resize_nn",
    "scale_ladder",
    "sharpen",
    "sobel",
    "threshold",
    "trace_contour",
]
