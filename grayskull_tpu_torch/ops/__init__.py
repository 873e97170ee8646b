"""Op layer: the ported ``gs_*`` ops on uint8 tensors."""

from .histogram import histogram, otsu_from_histogram, otsu_threshold  # noqa: F401
from .integral import integral, integral_sum  # noqa: F401
from .lbp import lbp_detect, lbp_warm_start, lbp_window, scale_ladder  # noqa: F401
from .pixel import blur, sobel, threshold  # noqa: F401

__all__ = [
    "blur",
    "histogram",
    "integral",
    "integral_sum",
    "lbp_detect",
    "lbp_warm_start",
    "lbp_window",
    "otsu_from_histogram",
    "otsu_threshold",
    "scale_ladder",
    "sobel",
    "threshold",
]
