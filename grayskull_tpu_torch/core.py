"""Core types and array conventions of the PyTorch port.

An image is a ``torch.uint8`` tensor of shape ``(H, W)`` (one frame) or
``(N, H, W)`` (a batch), exactly the convention of ``grayskull_tpu.core``.  Ops
compute on the tensor's own device and never move data on their own: a CUDA
tensor runs the port's kernels, a CPU tensor their plain versions.  There is no
``on_tpu`` gate; ``tensor.is_cuda`` chooses.

Coordinates follow the reference: ``x`` is the column (fast axis), ``y`` the row.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

__all__ = ["Point", "Rect", "as_image", "is_batched"]


class Rect(NamedTuple):
    """``gs_rect`` (grayskull.h:19-22): x, y, w, h."""

    x: Any
    y: Any
    w: Any
    h: Any


class Point(NamedTuple):
    """``gs_point`` (grayskull.h:23-26)."""

    x: Any
    y: Any


def as_image(x) -> torch.Tensor:
    """Coerce input to a uint8 image tensor of shape (H, W) or (N, H, W).

    A numpy array becomes a CPU tensor; a tensor stays on its device.
    """
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    elif not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    if x.dtype != torch.uint8:
        raise TypeError(f"grayskull images are uint8, got {x.dtype}")
    if x.ndim not in (2, 3):
        raise ValueError(f"expected (H, W) or (N, H, W) image, got shape {tuple(x.shape)}")
    return x


def is_batched(img) -> bool:
    return img.ndim == 3
