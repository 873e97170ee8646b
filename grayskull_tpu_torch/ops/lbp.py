"""Multi-scale LBP cascade detection — ``gs_lbp_window`` / ``gs_lbp_detect``
(grayskull.h:765-835), bit-exact with ``grayskull_tpu.ops.lbp``.

Each ladder scale scores its whole window grid in one call of
``kernels.lbp.lbp_eval_scale`` (K5 on a CUDA tensor, its plain version on a CPU
tensor).  Detections are emitted in the reference's (scale, y, x) order with its
``max_rects`` cap: the set windows' inverse global indices are keys, and
``torch.topk`` takes the ``max_rects`` largest, which are the first set windows
in ladder order.  No step of the path reads a value back to the host.

:func:`lbp_detect` is the span ``gs.ops.lbp_detect``, its emission the child
span ``gs.ops.lbp.emit``; ``counters["windows"]`` counts the windows it
scored (the ladder's windows a frame times the frames, every call).

Float semantics: the scale ladder (``scale *= scale_factor``) and the window
and feature scaling (float32 multiply, C truncation) are computed host-side in
numpy float32, as the JAX package does.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from .. import profiling
from ..core import Rects, as_tensor, host_device
from ..kernels import _build
from ..kernels.lbp import _device_tables, lbp_eval_scale, lbp_eval_scale_plain

__all__ = ["counters", "lbp_detect", "lbp_warm_start", "lbp_window", "scale_ladder"]

counters = {"windows": 0}


def scale_ladder(cascade, iw: int, ih: int, scale_factor, min_scale, max_scale):
    """The reference's float32 scale ladder (grayskull.h:819-821), host-side.

    Returns [(scale, win_w, win_h), ...] for scales whose window fits the image.
    """
    f = np.float32
    out = []
    scale = f(min_scale)
    factor = f(scale_factor)
    maxs = f(max_scale)
    while scale <= maxs:
        win_w = int(f(cascade.window_w) * scale)  # (int)(w * scale), f32 multiply
        win_h = int(f(cascade.window_h) * scale)
        if win_w > iw or win_h > ih:
            break
        out.append((float(scale), win_w, win_h))
        scale = f(scale * factor)
    return out


@functools.lru_cache(maxsize=64)
def _grid_plan(cascade, ih: int, iw: int, scale_factor, min_scale, max_scale, step: int):
    """((scale, win_w, win_h, ny, nx), ...) for every ladder scale with a
    non-empty window grid at stride ``step``."""
    out = []
    for scale, win_w, win_h in scale_ladder(cascade, iw, ih, scale_factor, min_scale, max_scale):
        ny = (ih - win_h) // step + 1
        nx = (iw - win_w) // step + 1
        if ny > 0 and nx > 0:
            out.append((scale, win_w, win_h, ny, nx))
    return tuple(out)


@functools.lru_cache(maxsize=64)
def _plan_tables(plan, device: torch.device):
    """Per ladder scale: its first global window index (S,), and (nx, win_w, win_h) (S, 3).

    Constants of the frame geometry, uploaded once per plan and device.
    """
    sizes = [ny * nx for *_, ny, nx in plan]
    starts = torch.tensor(np.cumsum([0] + sizes[:-1]), dtype=torch.int64, device=device)
    geo = torch.tensor([[nx, win_w, win_h] for _, win_w, win_h, _, nx in plan], dtype=torch.int64,
                       device=device)
    return starts, geo


def _emit_rects(hits, plan, step: int, cap: int) -> Rects:
    """First ``cap`` set windows per frame in ladder order, as a (N, cap) table.

    ``hits`` holds each scale's (N, ny, nx) mask.  A set window's key is its
    inverse global index (``total - index``), an unset one's is 0; the ``cap``
    largest keys, in descending order, are the first set windows.  A window's
    scale is found among the per-scale first indices, its (y, x) by a divmod of
    its index within the scale by that scale's ``nx``.
    """
    mask = torch.cat([h.reshape(h.shape[0], -1) for h in hits], dim=1)
    nb, total = mask.shape
    k = min(cap, total)
    inv = total - torch.arange(total, dtype=torch.int32, device=mask.device)
    key = torch.where(mask, inv, torch.zeros((), dtype=torch.int32, device=mask.device))
    vals = torch.topk(key, k, dim=1, sorted=True).values
    if cap > k:
        vals = torch.nn.functional.pad(vals, (0, cap - k))
    row_ok = vals > 0
    widx = torch.where(row_ok, total - vals, 0).to(torch.int64)
    n = row_ok.sum(dim=1, dtype=torch.int32)
    starts, geo = _plan_tables(plan, mask.device)
    s = torch.bucketize(widx, starts, right=True) - 1
    local = widx - starts[s]
    nx, win_w, win_h = geo[s].unbind(-1)
    fields = (local % nx * step, local // nx * step, win_w, win_h)
    return Rects(n, *(torch.where(row_ok, v, 0).to(torch.int32) for v in fields))


def _as_integral(ii) -> torch.Tensor:
    if isinstance(ii, np.ndarray):
        ii = as_tensor(np.ascontiguousarray(ii))
    if ii.dtype != torch.uint32:
        raise TypeError(f"expected a uint32 integral image, got {ii.dtype}")
    if ii.ndim not in (2, 3):
        raise ValueError(f"expected (H, W) or (N, H, W) integral, got {tuple(ii.shape)}")
    return ii


@profiling.spanned("gs.ops.lbp_detect")
def lbp_detect(cascade, ii, max_rects: int, scale_factor=1.2, min_scale=1.0, max_scale=4.0,
               step: int = 1, force_reference: bool = False) -> Rects:
    """Multi-scale sliding-window cascade detection — ``gs_lbp_detect``
    (grayskull.h:815-835).

    ``ii`` is the uint32 integral image, (H, W) or batched (N, H, W) (a numpy
    array goes to the CUDA device, as :func:`~grayskull_tpu_torch.core.as_image` says).  Detections come back as fixed-capacity
    :class:`Rects` tables (a leading batch dim on every field for batched
    input) in the reference's (scale, y, x) order with its ``max_rects`` cap.
    ``step`` is the window stride, any ``step >= 1``.  ``force_reference=True``
    scores the scales with the plain version on the tensor's device.
    """
    ii = _as_integral(ii)
    step = int(step)
    if step < 1:
        raise ValueError(f"step must be >= 1, got {step}")
    single = ii.ndim == 2
    iib = (ii[None] if single else ii).contiguous()
    nb, ih, iw = iib.shape
    cap = int(max_rects)
    plan = _grid_plan(cascade, ih, iw, scale_factor, min_scale, max_scale, step)
    if not plan:
        z = torch.zeros((nb, cap), dtype=torch.int32, device=iib.device)
        table = Rects(torch.zeros(nb, dtype=torch.int32, device=iib.device), z, z, z, z)
    else:
        evaluate = lbp_eval_scale_plain if force_reference else lbp_eval_scale
        hits = [evaluate(cascade, iib, scale, ny, nx, step) for scale, _, _, ny, nx in plan]
        counters["windows"] += nb * sum(ny * nx for *_, ny, nx in plan)
        with profiling.span("gs.ops.lbp.emit"):
            table = _emit_rects(hits, plan, step, cap)
    return Rects(*(v[0] for v in table)) if single else table


def lbp_warm_start(cascade, ih: int, iw: int, nb: int = 1, max_rects: int = 100,
                   scale_factor=1.2, min_scale=1.0, max_scale=4.0, step: int = 1) -> float:
    """Prepare ``lbp_detect`` for one frame geometry; returns seconds spent.

    On :func:`~grayskull_tpu_torch.core.host_device` (the current CUDA device;
    with none it raises unless the caller asked for the CPU with
    ``host_arrays_to("cpu")``) it builds and loads the kernel library, uploads
    every ladder scale's cascade tables and the plan's tables, and runs one
    detection on an all-zero batch of ``nb`` frames.
    """
    t0 = time.perf_counter()
    device = host_device()
    plan = _grid_plan(cascade, ih, iw, scale_factor, min_scale, max_scale, step)
    if plan:
        if device.type == "cuda":
            _build.library()
            for scale, *_ in plan:
                _device_tables(cascade, float(scale), device)
        ii = torch.zeros((nb, ih, iw), dtype=torch.int32, device=device).view(torch.uint32)
        lbp_detect(cascade, ii, max_rects, scale_factor, min_scale, max_scale, step)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def lbp_window(cascade, ii, x: int, y: int, scale: float) -> torch.Tensor:
    """Single-window cascade evaluation — ``gs_lbp_window`` (grayskull.h:790-813).

    ``ii`` is an (H, W) uint32 integral.  Returns a bool scalar tensor on its
    device; a window that does not fit the image is False like the reference.
    On a CUDA tensor this is K5 over a 1x1 grid at ``(y, x)``.
    """
    ii = _as_integral(ii)
    if ii.ndim != 2:
        raise ValueError(f"lbp_window takes an (H, W) integral, got {tuple(ii.shape)}")
    x, y = int(x), int(y)
    if x < 0 or y < 0:
        raise ValueError(f"window origin must be >= 0, got x={x} y={y}")
    ih, iw = ii.shape
    f = np.float32
    win_w = int(f(cascade.window_w) * f(scale))
    win_h = int(f(cascade.window_h) * f(scale))
    ok = lbp_eval_scale(cascade, ii[None].contiguous(), float(scale), 1, 1, 1, origin=(y, x))
    return ok[0, 0, 0] & (x + win_w <= iw) & (y + win_h <= ih)
