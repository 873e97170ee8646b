"""Pipelines: compositions matching the reference's example applications."""

from .faces import detect_faces, warm_start  # noqa: F401
from .orb import extract_pyramid_orb, pyramid_levels, track  # noqa: F401
from .preproc import preprocess, preprocess_reference  # noqa: F401
from .scan import preprocess_binarize, scan  # noqa: F401

__all__ = ["detect_faces", "extract_pyramid_orb", "preprocess", "preprocess_binarize",
           "preprocess_reference", "pyramid_levels", "scan", "track", "warm_start"]
