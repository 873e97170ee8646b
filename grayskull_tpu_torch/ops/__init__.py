"""Op layer: the ported ``gs_*`` ops on uint8 tensors."""

from .blobs import blob_corners, blobs, label_components  # noqa: F401
from .features import (BRIEF_PATTERN, brief_descriptor, compute_orientation, fast,  # noqa: F401
                       fast_scoremap, hamming_distance, match_orb, orb_extract)
from .histogram import histogram, otsu_from_histogram, otsu_threshold  # noqa: F401
from .integral import integral, integral_sum  # noqa: F401
from .lbp import lbp_detect, lbp_warm_start, lbp_window, scale_ladder  # noqa: F401
from .pixel import blur, downsample, sobel, threshold  # noqa: F401
from .warp import perspective_correct  # noqa: F401

__all__ = [
    "BRIEF_PATTERN",
    "blob_corners",
    "blobs",
    "blur",
    "brief_descriptor",
    "compute_orientation",
    "downsample",
    "fast",
    "fast_scoremap",
    "hamming_distance",
    "histogram",
    "integral",
    "integral_sum",
    "label_components",
    "lbp_detect",
    "lbp_warm_start",
    "lbp_window",
    "match_orb",
    "orb_extract",
    "otsu_from_histogram",
    "otsu_threshold",
    "perspective_correct",
    "scale_ladder",
    "sobel",
    "threshold",
]
