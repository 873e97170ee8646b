"""Core types and array conventions of the PyTorch port.

An image is a ``torch.uint8`` tensor of shape ``(H, W)`` (one frame) or
``(N, H, W)`` (a batch), exactly the convention of ``grayskull_tpu.core``.  Ops
compute on the tensor's own device: a CUDA tensor runs the port's kernels, a
CPU tensor their plain versions.  There is no ``on_tpu`` gate; ``tensor.is_cuda``
chooses.  A host array (numpy, a list) goes to the CUDA device; with no CUDA
device it raises, unless the caller asked for the CPU with
:func:`host_arrays_to` (or passed a CPU tensor).

Coordinates follow the reference: ``x`` is the column (fast axis), ``y`` the row.
Sparse results are fixed-capacity tables with an explicit valid count, as in
the JAX package: :class:`Rects` holds LBP detections, :class:`Keypoints` ORB
keypoints, :class:`Matches` descriptor matches and :class:`Blobs` connected
components; :class:`Contour` is one traced contour with its visited mask.
:class:`LbpCascade` is the cascade's host-side numpy data, shared with the
JAX package through :func:`lbp_cascade_from_arrays`;
:func:`keypoints_from_arrays` and :func:`blobs_from_arrays` take a keypoint or
blob table across the same way.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

__all__ = ["Blobs", "Contour", "Keypoints", "LbpCascade", "Matches", "Point", "Rect", "Rects",
           "as_image", "as_tensor", "blobs_from_arrays", "host_arrays_to", "host_device", "is_batched",
           "keypoints_from_arrays", "lbp_cascade_from_arrays"]


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


class Rects(NamedTuple):
    """Fixed-capacity rect table of LBP detections (grayskull.h:815-835).

    Every field is a ``torch.int32`` tensor: ``n`` is the valid count (``()`` for
    one frame, ``(N,)`` for a batch); ``x, y, w, h`` are ``(cap,)`` or
    ``(N, cap)``, with rows past ``n`` set to 0.
    """

    n: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor
    h: torch.Tensor


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint table — ``gs_keypoint[]`` (grayskull.h:42-47).

    ``n`` is the int32 valid count (``()`` for one frame, ``(N,)`` for a batch);
    ``x``, ``y`` and ``response`` are int32 and ``angle`` float32, each ``(cap,)``
    or ``(N, cap)``; ``descriptor`` is ``torch.uint32`` of shape ``(cap, 8)`` or
    ``(N, cap, 8)``.  Rows past ``n`` are 0.
    """

    n: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    response: torch.Tensor
    angle: torch.Tensor
    descriptor: torch.Tensor


class Matches(NamedTuple):
    """Fixed-capacity match table — ``gs_match[]`` (grayskull.h:49-52), every field int32."""

    n: torch.Tensor
    idx1: torch.Tensor
    idx2: torch.Tensor
    distance: torch.Tensor


class Blobs(NamedTuple):
    """Fixed-capacity blob table — ``gs_blob[]`` (grayskull.h:29-34) as struct-of-arrays.

    Every field is a ``torch.int32`` tensor: ``n`` is the valid count (``()``
    for one frame, ``(N,)`` for a batch); ``label``, ``area`` and the fields of
    ``box`` (:class:`Rect`) and ``centroid`` (:class:`Point`) are ``(cap,)`` or
    ``(N, cap)``, in the reference's compaction order, with rows past ``n`` set
    to 0.
    """

    n: torch.Tensor
    label: torch.Tensor
    area: torch.Tensor
    box: Rect
    centroid: Point


class Contour(NamedTuple):
    """``gs_contour`` (grayskull.h:36-40) plus the visited mask.

    ``box`` (:class:`Rect`), ``start`` (:class:`Point`) and ``length`` are 0-d
    ``torch.int32`` tensors; ``visited`` is the ``(H, W)`` ``torch.uint8``
    mask, 255 on the pixels the walk visited.
    """

    box: Rect
    start: Point
    length: torch.Tensor
    visited: torch.Tensor


def blobs_from_arrays(obj) -> Blobs:
    """A port :class:`Blobs` from any object with the blob table's fields.

    ``obj`` may be a ``grayskull_tpu.core.Blobs`` (of numpy or JAX arrays);
    each field is copied into an int32 CPU tensor, so the two packages' tables
    compare field by field.
    """
    def t(v):
        return torch.from_numpy(np.array(v, np.int32))

    return Blobs(t(obj.n), t(obj.label), t(obj.area), Rect(*(t(v) for v in obj.box)),
                 Point(*(t(v) for v in obj.centroid)))


_KEYPOINT_DTYPES = {"n": np.int32, "x": np.int32, "y": np.int32, "response": np.int32,
                    "angle": np.float32, "descriptor": np.uint32}


def keypoints_from_arrays(obj) -> Keypoints:
    """A port :class:`Keypoints` from any object with the six keypoint fields.

    ``obj`` may be a ``grayskull_tpu.core.Keypoints`` (of numpy or JAX arrays)
    or a mapping; each field is copied into a CPU tensor of the table's dtype.
    """
    def get(name):
        return obj[name] if isinstance(obj, dict) else getattr(obj, name)

    return Keypoints(**{name: torch.from_numpy(np.array(get(name), dtype))
                        for name, dtype in _KEYPOINT_DTYPES.items()})


_CASCADE_FIELDS = {
    "features": np.int8,
    "weak_feature_idx": np.uint16,
    "weak_left_val": np.float32,
    "weak_right_val": np.float32,
    "weak_subset_offset": np.uint16,
    "weak_num_subsets": np.uint16,
    "subsets": np.int32,
    "stage_weak_start": np.uint16,
    "stage_nweaks": np.uint16,
    "stage_threshold": np.float32,
}


@dataclasses.dataclass(frozen=True, eq=False)
class LbpCascade:
    """``gs_lbp_cascade`` (grayskull.h:54-64) as host-side numpy arrays.

    The layout of ``grayskull_tpu.core.LbpCascade``:

    * ``features``: (nfeatures, 4) int8 — x, y, w, h of the block grid's origin cell
    * ``weak_feature_idx``: (nweaks,) uint16
    * ``weak_left_val`` / ``weak_right_val``: (nweaks,) float32
    * ``weak_subset_offset`` / ``weak_num_subsets``: (nweaks,) uint16
    * ``subsets``: (total_subsets,) int32 bitmasks
    * ``stage_weak_start`` / ``stage_nweaks``: (nstages,) uint16
    * ``stage_threshold``: (nstages,) float32

    Equality is identity, as in the JAX package: the per-scale tables that
    ``ops.lbp`` uploads to the card are cached per cascade object, so callers
    reuse one object (``cascade.load_frontalface`` is memoized).
    """

    window_w: int
    window_h: int
    features: np.ndarray
    weak_feature_idx: np.ndarray
    weak_left_val: np.ndarray
    weak_right_val: np.ndarray
    weak_subset_offset: np.ndarray
    weak_num_subsets: np.ndarray
    subsets: np.ndarray
    stage_weak_start: np.ndarray
    stage_nweaks: np.ndarray
    stage_threshold: np.ndarray

    @property
    def nfeatures(self) -> int:
        return len(self.features)

    @property
    def nweaks(self) -> int:
        return len(self.weak_feature_idx)

    @property
    def nstages(self) -> int:
        return len(self.stage_threshold)

    def __hash__(self):
        return hash((self.window_w, self.window_h, self.nfeatures, self.nweaks, self.nstages))

    def __eq__(self, other):
        return self is other


def lbp_cascade_from_arrays(obj) -> LbpCascade:
    """A port :class:`LbpCascade` from any object with the twelve cascade fields.

    ``obj`` may be a ``grayskull_tpu.core.LbpCascade``, an ``np.load``-ed
    ``.npz`` or a mapping; each field is copied to a numpy array of the
    cascade's dtype.
    """
    def get(name):
        return obj[name] if isinstance(obj, dict) or hasattr(obj, "files") else getattr(obj, name)

    arrays = {name: np.array(get(name), dtype) for name, dtype in _CASCADE_FIELDS.items()}
    return LbpCascade(window_w=int(get("window_w")), window_h=int(get("window_h")), **arrays)


_host_device = contextvars.ContextVar("host_device", default=None)


@contextlib.contextmanager
def host_arrays_to(device):
    """Within the block, host arrays given to the port go to ``device``.

    ``host_arrays_to("cpu")`` runs entry points fed numpy on the CPU (the
    plain versions); ``host_arrays_to(None)`` restores the default, the CUDA
    device.  Tensors are never moved: a CPU tensor always runs on the CPU.
    """
    token = _host_device.set(None if device is None else torch.device(device))
    try:
        yield
    finally:
        _host_device.reset(token)


def host_device() -> torch.device:
    """Where host arrays go: the current CUDA device unless :func:`host_arrays_to` says else."""
    device = _host_device.get()
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "grayskull_tpu_torch sends host arrays to the CUDA device and found none; pass a "
            "CPU tensor, or call inside `with grayskull_tpu_torch.core.host_arrays_to('cpu'):`, "
            "to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def as_tensor(x) -> torch.Tensor:
    """A tensor stays where it is; a host array or scalar goes to :func:`host_device`."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    return torch.as_tensor(x, device=host_device())


def as_image(x) -> torch.Tensor:
    """Coerce input to a uint8 image tensor of shape (H, W) or (N, H, W).

    A tensor stays on its device; a numpy array goes to :func:`host_device`.
    """
    x = as_tensor(x)
    if x.dtype != torch.uint8:
        raise TypeError(f"grayskull images are uint8, got {x.dtype}")
    if x.ndim not in (2, 3):
        raise ValueError(f"expected (H, W) or (N, H, W) image, got shape {tuple(x.shape)}")
    return x


def is_batched(img) -> bool:
    return img.ndim == 3
