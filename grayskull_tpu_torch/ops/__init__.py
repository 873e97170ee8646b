"""Op layer: the main path's ``gs_*`` ops on uint8 tensors."""

from .histogram import histogram, otsu_from_histogram, otsu_threshold  # noqa: F401
from .pixel import blur, sobel, threshold  # noqa: F401

__all__ = ["blur", "histogram", "otsu_from_histogram", "otsu_threshold", "sobel", "threshold"]
