"""Pipelines: compositions matching the reference's example applications."""

from .faces import detect_faces, warm_start  # noqa: F401
from .preproc import preprocess, preprocess_reference  # noqa: F401

__all__ = ["detect_faces", "preprocess", "preprocess_reference", "warm_start"]
