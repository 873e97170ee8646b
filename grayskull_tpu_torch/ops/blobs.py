"""Connected components and blob analytics — ``gs_blobs`` / ``gs_blob_corners``
(grayskull.h:322-421), bit-exact with ``grayskull_tpu.ops.blobs``.

The labelling is K9 ``ccl`` (a CUDA tensor) or its plain version (a CPU
tensor): each foreground pixel (``>= 128``) gets its component's minimum raster
index.  The reference's creation-order labels follow from it without a second
propagation:

* a *seed* is a foreground pixel with no foreground left or top neighbour,
  where C allocates a fresh label (grayskull.h:347-351), and its label is its
  1-based rank among the frame's seeds in raster order;
* C's union always merges into the smaller root (grayskull.h:363), so a
  component's final label is the rank of its first seed, and that seed is the
  component's minimum-index pixel (a minimum has no foreground left or top
  neighbour).  So ``label = rank[component minimum]``, one gather.

Labels past ``max_blobs`` become 0 and set ``overflowed``; the JAX package
merges components fully there instead of reproducing C's dropped pixels, and
so does the port.  The statistics are K22 ``blob_stats`` (a CUDA tensor: each
block reduces its band of labels in a shared-memory table, then one atomic a
label and field) or its plain version (a CPU tensor, and ``force_reference``:
``scatter_add_`` / ``scatter_reduce_`` over ``frame * (cap + 1) + label``
keys, as the JAX package's CPU path computes them with ``segment_*`` ops).
The coordinate sums wrap mod 2^32 and divide unsigned, like C's ``unsigned
cx[]`` (grayskull.h:334, 395).

Every op takes one ``(H, W)`` frame or an ``(N, H, W)`` batch (a leading batch
dimension on every output) and runs without a host sync.
"""

from __future__ import annotations

import torch

from .. import profiling
from ..core import Blobs, Point, Rect, as_image, as_tensor
from ..kernels.blobs import blob_stats, blob_stats_plain
from ..kernels.ccl import ccl, ccl_plain

__all__ = ["blob_corners", "blobs", "label_components"]

_U32 = 0xFFFFFFFF
_STAT_LANES = 256  # slots per label that its scatter updates spread over
_STAT_SLOTS = 1 << 22  # int64 slots of one statistic's scatter target, at most


def _frames(img) -> tuple[torch.Tensor, bool]:
    img = as_image(img)
    single = img.ndim == 2
    return (img[None] if single else img).contiguous(), single


def _unbatch(t, single: bool):
    return t[0] if single else t


def label_components(img, force_reference: bool = False) -> torch.Tensor:
    """Label 4-connected components of ``img >= 128``: an int32 map, -1 for
    background, else the minimum raster index of the pixel's component.

    ``force_reference=True`` runs the plain version on the tensor's device.
    """
    frames, single = _frames(img)
    out = ccl_plain(frames) if force_reference else ccl(frames)
    return _unbatch(out, single)


class _Segments:
    """Reductions of per-pixel values by (frame, label) over an (N, P) int32
    label map ``seg`` of labels ``0 .. nseg - 1`` for frames ``w`` pixels wide.

    :meth:`stats` is K22 ``blob_stats`` (its plain version on the CPU).
    :meth:`extreme` reduces other values with a scatter whose updates of a
    label spread over up to 256 slots by pixel index and are reduced after:
    the atomics of a label that most pixels share (the background, a page)
    would otherwise serialise.  Its keys are built on its first call.  Both
    leave label 0 (background and dropped pixels) out of the extremes.
    """

    def __init__(self, seg: torch.Tensor, nseg: int, w: int):
        self.seg, self.nseg, self.w = seg, nseg, w
        self._keys = None

    def stats(self, row0: int = 0, plain: bool = False):
        """(area, sum_x, sum_y, min_x, min_y, max_x, max_y), each (N, nseg) int64,
        rows counted from ``row0``; the extremes of an empty label are 2^62 and -1.
        ``plain=True`` reduces with K22's plain version."""
        return (blob_stats_plain if plain else blob_stats)(self.seg, self.nseg, self.w, row0)

    def extreme(self, values: torch.Tensor, reduce: str, empty: int) -> torch.Tensor:
        """(N, nseg) int64 minima (``reduce="amin"``) or maxima (``"amax"``) of the
        int64 ``values`` (one a pixel, flattened), ``empty`` where a label has no pixel."""
        n, npix = self.seg.shape
        dev = self.seg.device
        lanes = max(1, min(_STAT_LANES, _STAT_SLOTS // (n * self.nseg)))
        if self._keys is None:
            pix = torch.arange(npix, device=dev, dtype=torch.int64)
            slot = self.seg.to(torch.int64) + torch.arange(n, device=dev).view(n, 1) * self.nseg
            self._keys = (slot * lanes + pix % lanes).view(-1)
        vals = torch.where((self.seg > 0).view(-1), values, empty)
        out = torch.full((n * self.nseg * lanes,), empty, dtype=torch.int64, device=dev)
        out = out.scatter_reduce_(0, self._keys, vals, reduce).view(n, self.nseg, lanes)
        return out.amin(2) if reduce == "amin" else out.amax(2)


@profiling.spanned("gs.ops.blobs")
def blobs(img, max_blobs: int, force_reference: bool = False):
    """Connected components with stats — ``gs_blobs`` (grayskull.h:330-402).

    Returns ``(table, labels, overflowed)``: ``table`` is a :class:`Blobs` in
    the reference's compaction order (ascending creation label); ``labels`` the
    ``torch.uint16`` creation-order label map (0 = background, labels above
    ``max_blobs`` 0, as the JAX package's uint16 map wraps larger labels mod
    2^16); ``overflowed`` a bool, True when the frame has more seeds than
    ``max_blobs``.  ``max_blobs=0`` gives an empty table, an all-zero map and
    ``overflowed`` wherever a frame has a seed, as in the JAX package.
    ``force_reference=True`` labels and reduces with the plain versions.
    """
    frames, single = _frames(img)
    n, h, w = frames.shape
    cap = int(max_blobs)
    if cap < 0:
        raise ValueError(f"max_blobs must be >= 0, got {cap}")
    dev = frames.device
    fg = frames >= 128
    no_col = torch.zeros((n, h, 1), dtype=torch.bool, device=dev)
    no_row = torch.zeros((n, 1, w), dtype=torch.bool, device=dev)
    seed = fg & ~torch.cat([no_col, fg[:, :, :-1]], 2) & ~torch.cat([no_row, fg[:, :-1]], 1)
    # a cumsum along each row plus the rows' carries (one scan over a whole
    # frame would run on a few blocks)
    row_rank = torch.cumsum(seed, 2, dtype=torch.int32)
    ends = row_rank[:, :, -1]
    carry = torch.cumsum(ends, 1, dtype=torch.int32) - ends
    rank = (row_rank + carry[:, :, None]).view(n, h * w)
    overflowed = rank[:, -1] > cap

    rep = ccl_plain(frames) if force_reference else ccl(frames)
    fg_flat = fg.view(n, h * w)
    label = torch.where(fg_flat, rank.gather(1, rep.view(n, h * w).clamp(min=0).to(torch.int64)),
                        0)
    seg = torch.where(label <= cap, label, 0)

    # per-(frame, label) statistics; label 0 gathers background and dropped pixels
    nseg = cap + 1
    with profiling.span("gs.ops.blobs.stats"):
        stats = blob_stats_plain if force_reference else blob_stats
        area, sum_x, sum_y, min_x, min_y, max_x, max_y = stats(seg, nseg, w)

    # a label survives compaction iff it has pixels; compact in ascending label order
    with profiling.span("gs.ops.blobs.compact"):
        is_rep = area > 0
        is_rep[:, 0] = False
        count = torch.cumsum(is_rep, 1)
        dst = torch.where(is_rep, count - 1, cap)  # column cap is scratch, dropped

        def compact(values):
            out = torch.zeros((n, nseg), dtype=torch.int64, device=dev)
            return out.scatter_(1, dst, values)[:, :cap]

        labels_r = torch.arange(nseg, device=dev, dtype=torch.int64).expand(n, nseg)
        t_area = compact(area)
        safe_area = t_area.clamp(min=1)

        def udiv(s):  # C's unsigned division of the wrapped sum
            return (compact(s) & _U32) // safe_area

        table = Blobs(
            n=count[:, -1].to(torch.int32),
            label=compact(labels_r).to(torch.int32),
            area=t_area.to(torch.int32),
            box=Rect(*(v.to(torch.int32) for v in (
                compact(min_x), compact(min_y), compact(max_x - min_x + 1),
                compact(max_y - min_y + 1)))),
            centroid=Point(udiv(sum_x).to(torch.int32), udiv(sum_y).to(torch.int32)),
        )
    label_map = seg.view(n, h, w).to(torch.uint16)
    if single:
        table = Blobs(table.n[0], table.label[0], table.area[0], Rect(*(v[0] for v in table.box)),
                      Point(*(v[0] for v in table.centroid)))
    return table, _unbatch(label_map, single), _unbatch(overflowed, single)


@profiling.spanned("gs.ops.blob_corners")
def blob_corners(img, labels, label, box: Rect, centroid: Point) -> torch.Tensor:
    """Quad corner finder — ``gs_blob_corners`` (grayskull.h:404-421).

    Returns (4, 2) int32 (x, y) rows, TL, TR, BR, BL: the extremes of ``x+y``
    and ``x-y`` over the blob's pixels inside its box, ties to the first in
    raster order; every corner is the centroid when no pixel matches.  For an
    (N, H, W) batch, ``label`` and the fields of ``box`` and ``centroid`` are
    (N,) (or scalars, shared by every frame) and the result is (N, 4, 2).
    """
    frames, single = _frames(img)
    n, h, w = frames.shape
    dev = frames.device
    lab = as_tensor(labels).to(dev)
    lab = (lab[None] if lab.ndim == 2 else lab).to(torch.int32)

    def per_frame(v):
        return as_tensor(v).to(device=dev, dtype=torch.int32).reshape(-1, 1, 1)

    bx, by, bw, bh = (per_frame(v) for v in box)
    xs = torch.arange(w, device=dev, dtype=torch.int32).view(1, 1, w)
    ys = torch.arange(h, device=dev, dtype=torch.int32).view(1, h, 1)
    mask = ((frames >= 128) & (lab == per_frame(label)) & (xs >= bx) & (xs < bx + bw)
            & (ys >= by) & (ys < by + bh)).view(n, h * w)
    big = 2**30
    s = (xs + ys).expand(n, h, w).reshape(n, h * w)
    d = (xs - ys).expand(n, h, w).reshape(n, h * w)
    any_px = mask.any(1)
    cx, cy = (per_frame(v).view(-1) for v in centroid)

    def pick(i):
        i = i.to(torch.int32)
        return torch.stack([torch.where(any_px, i % w, cx), torch.where(any_px, i // w, cy)], 1)

    tl = pick(torch.where(mask, s, big).argmin(1))
    br = pick(torch.where(mask, s, -big).argmax(1))
    bl = pick(torch.where(mask, d, big).argmin(1))
    tr = pick(torch.where(mask, d, -big).argmax(1))
    return _unbatch(torch.stack([tl, tr, br, bl], 1), single)
