"""Pipelines: compositions matching the reference's example applications."""

from .preproc import preprocess, preprocess_reference  # noqa: F401

__all__ = ["preprocess", "preprocess_reference"]
