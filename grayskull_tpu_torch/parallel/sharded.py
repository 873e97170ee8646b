"""Sharded pipelines on a :class:`~.mesh.Mesh`: data-parallel batches and
H-sharded frames, bit-identical to the single-device ops.

The mesh is single-controller, as ``grayskull_tpu``'s ``shard_map`` is: this
process scatters the frames over the mesh's devices, runs each shard's body on
its device, moves halo rows and histograms between devices with ``.to``, and
gathers the outputs.  Nothing in a call waits on the host.

* :func:`preprocess_spatial_shardmap` — frames sharded over ``data`` and their
  rows over ``space``: a radius-``r`` halo exchange, K15 ``blur_hist_window``
  per shard (counts at global rows, histogram of the shard's own rows), the
  shards' histograms summed on the row's first device and one K3 ``otsu``
  there, a 1-row halo exchange of the blurred rows, then K16
  ``threshold_sobel_window`` per shard.
* :func:`preprocess_sharded`, :func:`scan_sharded` — data parallelism: each
  data shard runs the single-device pipeline on its device.
* :func:`integral_sharded` — K4 per shard, plus the column totals of the
  shards above it (the exclusive carry), mod 2^32.
* :func:`match_template_sharded` — each shard extended by ``th - 1`` rows
  from the shards below it (:func:`~.halo.bottom_halo`, several hops for a
  template taller than a shard), K19 per extended shard.

Every function returns whole-batch tensors on the mesh's first device (what a
caller of the JAX version gets from ``np.asarray``).  Along the axes a
function does not shard, it runs on each row's first device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import as_image
from ..kernels.integral import from_int64, integral, integral_plain, u32_to_int64
from ..kernels.otsu import otsu, otsu_plain
from ..kernels.preproc import (blur_hist_window, blur_hist_window_plain, threshold_sobel_window,
                               threshold_sobel_window_plain)
from ..kernels.template import MAX_TEMPLATE_PIXELS
from ..ops.template import match_template
from ..pipelines.preproc import preprocess
from ..pipelines.scan import scan
from .halo import bottom_halo, exchange_halo
from .mesh import Mesh

__all__ = ["integral_sharded", "match_template_sharded", "preprocess_sharded",
           "preprocess_spatial_shardmap", "scan_sharded"]


def _grid(mesh: Mesh, *axes: str) -> np.ndarray:
    """The mesh's devices indexed by ``axes`` in that order, at index 0 of every other axis."""
    names = list(mesh.axis_names)
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"mesh axes {mesh.axis_names} lack {missing}")
    order = [names.index(a) for a in axes]
    order += [i for i in range(len(names)) if i not in order]
    devices = np.transpose(mesh.devices, order)
    return devices[(slice(None),) * len(axes) + (0,) * (devices.ndim - len(axes))]


def _frames(imgs) -> torch.Tensor:
    frames = as_image(imgs)
    if frames.ndim != 3:
        raise ValueError(f"expected (N, H, W) frames, got {tuple(frames.shape)}")
    return frames


def _split(size: int, parts: int, what: str) -> int:
    if size % parts:
        raise ValueError(f"{what} {size} does not divide over {parts} shards")
    return size // parts


def _gather(pieces, shape, dtype, device) -> torch.Tensor:
    """A whole-batch tensor on ``device`` filled from ``(index, piece)`` pairs."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for index, piece in pieces:
        out[index].copy_(piece, non_blocking=True)
    return out


def _spatial_shards(frames: torch.Tensor, mesh: Mesh, radius: int, data_axis: str,
                    space_axis: str, kernels: bool):
    """The shard bodies of :func:`preprocess_spatial_shardmap`, without the gather.

    Returns one ``(shards, thresholds)`` pair a data row: ``shards`` holds each
    space shard's ``(blurred, binary, edges)``, ``(n_loc, h_loc, W)`` on its
    device; ``thresholds`` is ``(n_loc,)`` on the row's first device.
    """
    grid = _grid(mesh, data_axis, space_axis)
    nd, ns = grid.shape
    n, h, w = frames.shape
    r = int(radius)
    n_loc = _split(n, nd, f"batch of {n} frames over '{data_axis}':")
    h_loc = _split(h, ns, f"frame height over '{space_axis}':")
    if not 0 <= r <= h_loc:
        raise ValueError(f"radius {r} must be in 0 .. {h_loc}, the shard height")
    blur = blur_hist_window if kernels else blur_hist_window_plain
    sweep = otsu if kernels else otsu_plain
    edge = threshold_sobel_window if kernels else threshold_sobel_window_plain
    rows = []
    for d in range(nd):
        batch = frames[d * n_loc:(d + 1) * n_loc]
        shards = [batch[:, s * h_loc:(s + 1) * h_loc].to(grid[d, s], non_blocking=True)
                  for s in range(ns)]
        blurred_ext = [blur(x.contiguous(), s * h_loc - r, r, h_total=h, row_lo=r,
                            row_hi=r + h_loc)
                       for s, x in enumerate(exchange_halo(shards, r))]
        hist = blurred_ext[0][1]
        for _, part in blurred_ext[1:]:
            hist = hist + part.to(hist.device, non_blocking=True)
        t = sweep(hist, h * w)
        blurred = [b[:, r:r + h_loc] for b, _ in blurred_ext]
        outs = []
        for s, x in enumerate(exchange_halo(blurred, 1)):
            binary, edges = edge(x, t.to(x.device, non_blocking=True), s * h_loc - 1, h_total=h)
            outs.append((blurred[s], binary[:, 1:1 + h_loc], edges[:, 1:1 + h_loc]))
        rows.append((outs, t))
    return rows


def preprocess_spatial_shardmap(imgs, mesh: Mesh, radius: int = 2, data_axis: str = "data",
                                space_axis: str = "space", kernels: bool | None = None):
    """Fused preprocess (blur -> Otsu -> threshold -> Sobel) with the batch
    sharded over ``data`` and each frame's rows over ``space``.

    ``imgs``: (N, H, W) uint8, N divisible by the data axis, H by the space
    axis, ``radius`` at most the shard height H / space; each raises
    ``ValueError`` otherwise.  Returns ``(blurred, binary, edges,
    thresholds)`` on the mesh's first device.

    ``kernels`` (default) runs K15, K3 and K16 on CUDA shards and their plain
    versions on CPU shards; ``kernels=False`` runs the plain versions on the
    shards' devices (the counterpart of the JAX package's XLA body).  The JAX
    version's ``interpret`` runs Pallas in interpret mode and has no
    counterpart here.  Any W and any radius whose window sum fits int32.
    """
    frames = _frames(imgs)
    n, h, w = frames.shape
    rows = _spatial_shards(frames, mesh, radius, data_axis, space_axis, kernels is not False)
    n_loc, h_loc = n // len(rows), h // len(rows[0][0])
    device = mesh.devices.flat[0]
    maps = [_gather([((slice(d * n_loc, (d + 1) * n_loc), slice(s * h_loc, (s + 1) * h_loc)),
                      shard[k])
                     for d, (shards, _) in enumerate(rows) for s, shard in enumerate(shards)],
                    (n, h, w), torch.uint8, device)
            for k in range(3)]
    t = _gather([(slice(d * n_loc, (d + 1) * n_loc), ts) for d, (_, ts) in enumerate(rows)],
                (n,), torch.uint8, device)
    return (*maps, t)


def _data_shards(frames: torch.Tensor, mesh: Mesh, data_axis: str):
    """``(index, frames on their device)`` for each data shard."""
    devices = _grid(mesh, data_axis)
    n_loc = _split(frames.shape[0], len(devices), f"batch of {frames.shape[0]} frames over "
                                                  f"'{data_axis}':")
    return [(slice(d * n_loc, (d + 1) * n_loc),
             frames[d * n_loc:(d + 1) * n_loc].to(dev, non_blocking=True))
            for d, dev in enumerate(devices)]


def preprocess_sharded(imgs, mesh: Mesh, radius: int = 2, data_axis: str = "data"):
    """Data-parallel :func:`~grayskull_tpu_torch.preprocess` over the mesh's
    ``data`` axis: ``(blurred, binary, edges, thresholds)`` on the mesh's first device."""
    frames = _frames(imgs)
    outs = [(index, preprocess(part, radius)) for index, part in _data_shards(frames, mesh,
                                                                               data_axis)]
    device = mesh.devices.flat[0]
    shapes = (frames.shape,) * 3 + ((frames.shape[0],),)
    return tuple(_gather([(index, out[k]) for index, out in outs], shapes[k], torch.uint8, device)
                 for k in range(4))


def integral_sharded(imgs, mesh: Mesh, data_axis: str = "data", space_axis: str = "space",
                     kernels: bool | None = None):
    """Integral images of H-sharded frames, bit-identical to
    :func:`~grayskull_tpu_torch.integral`: (N, H, W) ``torch.uint32`` on the
    mesh's first device.

    Each shard's local prefix sums come from K4 (``kernels=False``: its plain
    version); the column totals of the shards above it are added in int64 and
    wrapped back to uint32.
    """
    frames = _frames(imgs)
    grid = _grid(mesh, data_axis, space_axis)
    nd, ns = grid.shape
    n, h, w = frames.shape
    n_loc = _split(n, nd, f"batch of {n} frames over '{data_axis}':")
    h_loc = _split(h, ns, f"frame height over '{space_axis}':")
    local_scan = integral_plain if kernels is False else integral
    pieces = []
    for d in range(nd):
        rows = slice(d * n_loc, (d + 1) * n_loc)
        carry = None  # int64 column totals of the shards above, (n_loc, W)
        for s in range(ns):
            cols = slice(s * h_loc, (s + 1) * h_loc)
            ii = local_scan(frames[rows, cols].to(grid[d, s], non_blocking=True).contiguous())
            if carry is not None:
                ii = from_int64(u32_to_int64(ii) + carry.to(ii.device, non_blocking=True)[:, None])
            carry = u32_to_int64(ii[:, -1])
            pieces.append(((rows, cols), ii.view(torch.int32)))
    return _gather(pieces, (n, h, w), torch.int32, mesh.devices.flat[0]).view(torch.uint32)


def match_template_sharded(imgs, tmpl, mesh: Mesh, data_axis: str = "data",
                           space_axis: str = "space"):
    """SSD template matching on H-sharded frames, bit-identical to
    :func:`~grayskull_tpu_torch.match_template` on every placement.

    ``imgs``: (N, H, W) uint8, N divisible by the data axis, H by the space
    axis; ``tmpl``: (th, tw) uint8, sent to every shard's device.  Each shard
    takes the placements whose top row it holds: it is extended by ``th - 1``
    rows from the shards below (zeros past the frame's bottom), one K19 launch
    a shard.  Returns the (N, H - th + 1, W - tw + 1) score map on the mesh's
    first device; the rows of placements past the frame's last are dropped.
    """
    frames = _frames(imgs)
    tmpl = as_image(tmpl)
    if tmpl.ndim != 2:
        raise ValueError(f"expected an (th, tw) template, got shape {tuple(tmpl.shape)}")
    n, h, w = frames.shape
    th, tw = tmpl.shape
    if th > h or tw > w:
        raise ValueError(f"template {tuple(tmpl.shape)} larger than image {(h, w)}")
    if th * tw > MAX_TEMPLATE_PIXELS:
        raise ValueError(f"template has {th * tw} pixels; exact uint32 scoring supports up to "
                         f"{MAX_TEMPLATE_PIXELS}")
    grid = _grid(mesh, data_axis, space_axis)
    nd, ns = grid.shape
    n_loc = _split(n, nd, f"batch of {n} frames over '{data_axis}':")
    h_loc = _split(h, ns, f"frame height over '{space_axis}':")
    rh, rw = h - th + 1, w - tw + 1
    pieces = []
    for d in range(nd):
        batch = frames[d * n_loc:(d + 1) * n_loc]
        shards = [batch[:, s * h_loc:(s + 1) * h_loc].to(grid[d, s], non_blocking=True)
                  for s in range(ns)]
        for s, x in enumerate(bottom_halo(shards, th - 1)):
            scores = match_template(x.contiguous(), tmpl.to(x.device, non_blocking=True))
            keep = min(h_loc, rh - s * h_loc)
            if keep > 0:
                pieces.append(((slice(d * n_loc, (d + 1) * n_loc),
                                slice(s * h_loc, s * h_loc + keep)), scores[:, :keep]))
    return _gather(pieces, (n, rh, rw), torch.uint8, mesh.devices.flat[0])


def scan_sharded(imgs, mesh: Mesh, out_size=(1000, 800), max_blobs: int = 1000,
                 data_axis: str = "data"):
    """Data-parallel document scanner: each data shard runs
    :func:`~grayskull_tpu_torch.scan` on its device.

    Returns ``(pages (N, out_h, out_w) uint8, corners (N, 4, 2) int32)`` on the
    mesh's first device.
    """
    frames = _frames(imgs)
    out_size = (int(out_size[0]), int(out_size[1]))
    outs = [(index, scan(part, out_size, max_blobs))
            for index, part in _data_shards(frames, mesh, data_axis)]
    n, device = frames.shape[0], mesh.devices.flat[0]
    pages = _gather([(index, out[0]) for index, out in outs], (n, *out_size), torch.uint8, device)
    corners = _gather([(index, out[1]) for index, out in outs], (n, 4, 2), torch.int32, device)
    return pages, corners
