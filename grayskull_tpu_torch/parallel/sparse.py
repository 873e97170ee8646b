"""Sharded sparse stages on a :class:`~.mesh.Mesh`, bit-identical to
``grayskull_tpu.parallel.sparse`` (and so to the single-device ops wherever
the JAX functions are).

As in :mod:`.sharded`, the mesh is single-controller: this process cuts the
frame into H-shards, runs each shard's body on its device with the port's
kernels (``kernels=False``: their plain versions, on the same devices), moves
halo rows and cap-sized tables between devices with ``.to``, and gathers the
outputs on the mesh's first device.

* :func:`label_components_sharded` — K9 ``ccl`` labels each shard's slab; a
  slab-local minimum plus ``row0 * W`` is the global one.  The components
  that meet across shard boundaries are merged by one union-find over the
  labels of the boundary rows (at most ``2 * (shards - 1) * W`` of them),
  copied to the host once, and the merge is applied to each slab by a gather
  on its device.  The JAX version loops on the device until a ``psum``'d flag
  clears, a number of rounds that grows with the image; here the host waits
  once a call, whatever the image (never with one shard).
* :func:`blobs_sharded` — ``gs_blobs``' statistics: each shard reduces its
  slab-components with K22 ``blob_stats`` (``ops.blobs``' statistics; its
  other extremes with ``ops.blobs``' scatter scheme), keyed by their rank
  among the slab's seeds (capped at ``max_blobs + W // 2 + 1``) and tagged
  with the global component and, on the shard that holds the component's
  minimum, its creation label (its rank among the frame's seeds).  The
  shards' rows are merged by global component on the first device and
  compacted in creation order, as the JAX version does.
* :func:`scan_spatial_shardmap` — the document scanner on one H-sharded frame:
  K15 ``blur_hist_window`` (r = 1) on each shard's halo slab, the histograms
  summed and one K3 ``otsu``, the threshold ``(t + 10) % 256``, the labels
  and statistics above, the largest blob, its corners as global first
  extremes of x+y and x-y, and each shard's band of page rows from K10's rows
  entry (``quad_warp_rows``) on the whole frame.
* :func:`orb_extract_spatial` — K6 ``fast`` on slabs cut so that its 3-pixel
  interior is the frame's (the first shard without rows above, the last
  without rows below, 4 halo rows elsewhere), the keys of each shard's own
  rows re-based to the frame's numbering, a local ``torch.topk`` and one over
  the gathered key tables, the replicated selection, then K7 ``orb_moments``
  and K8 ``orb_brief`` on each shard's 28-row halo slab for the keypoints of
  its rows.
* :func:`match_orb_sharded` — the Hamming matrix sharded over query rows,
  best, second best and the ratio test per shard, the emission replayed on
  the first device.
* :func:`lbp_detect_sharded` — K5 ``lbp_eval_scale`` per (scale, data shard,
  band of window rows) on the band's slab of the integral, the hit masks
  gathered for the ladder-ordered emission.
* :func:`detect_faces_sharded` — :func:`~.sharded.integral_sharded` (K4 a
  shard) feeding :func:`lbp_detect_sharded`.

Only the first three wait on the host, once a call (the union-find); the
others wait nowhere (the ORB tables in the ``exact_host`` trig mode wait as
``orb_extract`` does).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cascade import load_frontalface
from ..core import Blobs, Keypoints, Matches, Point, Rect, Rects, as_image, as_tensor
from ..kernels.ccl import ccl, ccl_plain
from ..kernels.fast import fast, fast_plain
from ..kernels.lbp import _scaled_features, lbp_eval_scale, lbp_eval_scale_plain
from ..kernels.otsu import otsu, otsu_plain
from ..kernels.patches import orb_brief, orb_brief_plain, orb_moments, orb_moments_plain
from ..kernels.preproc import blur_hist_window, blur_hist_window_plain
from ..kernels.warp import quad_warp_rows, quad_warp_rows_plain
from ..libm32 import orientation_trig
from ..ops.blobs import _Segments
from ..ops.features import (_MAX_CANDIDATES, ORB_RADIUS, _best_matches, _emit, _rank_scatter,
                            _select_candidates)
from ..ops.lbp import _as_integral, _emit_rects, _grid_plan
from .halo import exchange_halo
from .mesh import Mesh
from .sharded import _gather, _grid, _split, integral_sharded

__all__ = [
    "blobs_sharded",
    "detect_faces_sharded",
    "label_components_sharded",
    "lbp_detect_sharded",
    "match_orb_sharded",
    "orb_extract_spatial",
    "scan_spatial_shardmap",
]

_BIG = 2**31 - 1
_U32 = 0xFFFFFFFF
_FAST_HALO = 4    # FAST's circle radius 3 plus one NMS row
_PATCH_HALO = 28  # the rows a keypoint's 48x48 patch reaches past its own (features.py:599)


def _space_slabs(img, mesh: Mesh, space_axis: str):
    """One (H, W) uint8 frame cut into its H-shards, each on its device:
    ``(frame, devices, slabs)``."""
    frame = as_image(img)
    if frame.ndim != 2:
        raise ValueError(f"expected one (H, W) frame, got {tuple(frame.shape)}")
    devices = list(_grid(mesh, space_axis))
    h_loc = _split(frame.shape[0], len(devices), f"frame height over '{space_axis}':")
    slabs = [frame[s * h_loc:(s + 1) * h_loc].to(dev, non_blocking=True).contiguous()
             for s, dev in enumerate(devices)]
    return frame, devices, slabs


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting: through pinned memory to a card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


# --------------------------------------------------------------------------
# connected components
# --------------------------------------------------------------------------


def _merge_across(upper: np.ndarray, lower: np.ndarray):
    """Union-find over the components that meet across the shard boundaries.

    ``upper[b]`` and ``lower[b]`` are the global labels of the rows just above
    and just below boundary ``b`` (-1 for background); a column where both are
    foreground joins their components.  Returns ``(labels, roots)``, int64, of
    every component whose merged component's minimum is another's.
    """
    both = (upper >= 0) & (lower >= 0)
    a, b = upper[both].astype(np.int64), lower[both].astype(np.int64)
    nodes, inv = np.unique(np.concatenate([a, b]), return_inverse=True)
    ea, eb = inv[:a.size], inv[a.size:]
    parent = np.arange(nodes.size)  # parent[i] <= i: a root is its tree's minimum
    while True:
        ra, rb = parent[ea], parent[eb]
        if np.array_equal(ra, rb):
            break
        lo = np.minimum(ra, rb)  # hook each edge's roots to the smaller
        np.minimum.at(parent, ra, lo)
        np.minimum.at(parent, rb, lo)
        while True:  # every node straight to its root
            up = parent[parent]
            if np.array_equal(up, parent):
                break
            parent = up
    roots = nodes[parent]
    moved = roots != nodes
    return nodes[moved], roots[moved]


def _label_shards(binary, w: int, kernels: bool):
    """K9 on each (h_loc, W) slab, then the merge across the boundaries.

    Returns ``(local, glob)``: each slab's int32 labels, slab-local minimum
    raster indices (``local``) and global component minima (``glob``), -1
    for background, on the slab's device.  The boundary rows go to the host
    once (one wait) for :func:`_merge_across`, unless there is one shard.
    """
    label = ccl if kernels else ccl_plain
    h_loc = binary[0].shape[0]
    local = [label(x[None])[0] for x in binary]
    glob = [torch.where(lab >= 0, lab + s * h_loc * w, -1) for s, lab in enumerate(local)]
    if len(binary) == 1:
        return local, glob
    rows = torch.empty((2, len(binary) - 1, w), dtype=torch.int32, device=binary[0].device)
    for b in range(1, len(binary)):
        rows[0, b - 1].copy_(glob[b - 1][-1], non_blocking=True)
        rows[1, b - 1].copy_(glob[b][0], non_blocking=True)
    host = rows.cpu().numpy()  # the call's one host wait
    moved, roots = _merge_across(host[0], host[1])
    for s, lab in enumerate(local):
        lo = s * h_loc * w
        sel = (moved >= lo) & (moved < lo + h_loc * w)
        if not sel.any():
            continue
        dev = lab.device
        table = torch.arange(lo, lo + h_loc * w, dtype=torch.int32, device=dev)
        table.scatter_(0, _to_device(moved[sel] - lo, dev),
                       _to_device(roots[sel].astype(np.int32), dev))
        glob[s] = torch.where(lab >= 0, table.take(lab.clamp(min=0).to(torch.int64)), -1)
    return local, glob


def label_components_sharded(img, mesh: Mesh, space_axis: str = "space",
                             kernels: bool | None = None) -> torch.Tensor:
    """H-sharded 4-connected labelling, bit-identical to ``label_components``:
    the (H, W) int32 map of each foreground pixel's (``>= 128``) component
    minimum raster index, -1 for background, on the mesh's first device.

    ``img``: (H, W) uint8, H divisible by the space axis (``ValueError``
    otherwise).  K9 per shard (``kernels=False``: its plain version), then one
    union-find over the boundary rows: the host waits once a call, whatever
    the image (never with one shard).
    """
    frame, devices, slabs = _space_slabs(img, mesh, space_axis)
    h, w = frame.shape
    h_loc = h // len(devices)
    _, glob = _label_shards(slabs, w, kernels is not False)
    return _gather([(slice(s * h_loc, (s + 1) * h_loc), g) for s, g in enumerate(glob)], (h, w),
                   torch.int32, mesh.devices.flat[0])


# --------------------------------------------------------------------------
# blob statistics
# --------------------------------------------------------------------------


def _blob_rows(binary, local, glob, w: int, cap: int, kernels: bool):
    """Each shard's statistic rows, gathered on the first shard's device
    (``grayskull_tpu/parallel/sparse.py:211 _shard_blob_rows``).

    A slab-component's row is keyed by the rank of its minimum among the
    slab's seeds (foreground pixels with no foreground left or above inside
    the slab), up to ``cap + W // 2 + 1``: the slab's cut rows add at most
    one seed a run of its first row.  A component past that loses the
    slab's pixels, as in the JAX version.  Each row holds the global
    component minimum (``rep``), area, coordinate sums, box and, on the
    shard holding the component's minimum, its creation label: the
    minimum's rank among the frame's seeds.  ``kernels=False`` reduces with
    K22's plain version.  Returns nine int64 tensors.
    """
    ns = len(binary)
    h_loc = binary[0].shape[0]
    cap_loc = cap + w // 2 + 1
    dev0 = binary[0].device
    offset = torch.zeros((), dtype=torch.int64, device=dev0)  # the frame's seeds above the shard
    parts = []
    for s, x in enumerate(binary):
        dev = x.device
        row0 = s * h_loc
        fg = x >= 128
        no_col = torch.zeros((h_loc, 1), dtype=torch.bool, device=dev)
        fg_left = torch.cat([no_col, fg[:, :-1]], 1)
        above = (binary[s - 1][-1:].to(dev, non_blocking=True) >= 128 if s
                 else torch.zeros((1, w), dtype=torch.bool, device=dev))
        seed_slab = fg & ~fg_left & ~torch.cat([torch.zeros_like(above), fg[:-1]], 0)
        seed_glob = fg & ~fg_left & ~torch.cat([above, fg[:-1]], 0)
        rank_slab = torch.cumsum(seed_slab.view(-1), 0, dtype=torch.int32)  # 1-based
        lab = local[s].view(-1)
        dense = torch.where(fg.view(-1), rank_slab.take(lab.clamp(min=0).to(torch.int64)), 0)
        dense = torch.where(dense <= cap_loc, dense, 0)
        seg = _Segments(dense.view(1, -1), cap_loc + 1, w)
        area, sx, sy, mnx, mny, mxx, mxy = seg.stats(row0, plain=not kernels)
        g = glob[s].view(-1).to(torch.int64)
        rep = seg.extreme(g, "amin", _BIG)
        gidx = torch.arange(h_loc * w, dtype=torch.int64, device=dev) + row0 * w
        shard_offset = offset.to(dev, non_blocking=True)
        rank_glob = torch.cumsum(seed_glob.view(-1), 0) + shard_offset
        creation = seg.extreme(torch.where(g == gidx, rank_glob, 0), "amax", 0)
        offset = (shard_offset + seed_glob.sum()).to(dev0, non_blocking=True)
        has = area > 0
        row = (rep, area, sx, sy, torch.where(has, mnx, _BIG), torch.where(has, mny, _BIG),
               torch.where(has, mxx, -1), torch.where(has, mxy, -1), creation)
        parts.append([v[0, 1:] for v in row])
    return [_gather([(slice(s * cap_loc, (s + 1) * cap_loc), part[k])
                     for s, part in enumerate(parts)], (ns * cap_loc,), torch.int64, dev0)
            for k in range(9)]


def _merge_rows(rows, cap: int):
    """The rows of one global component summed, their extremes reduced
    (``grayskull_tpu/parallel/sparse.py:290 _merge_blob_rows``): sorted by
    rep, grouped, a scatter per field.  Returns ``(rep, area, sum_x, sum_y,
    min_x, min_y, max_x, max_y, label, valid)`` a group."""
    rep, area, sx, sy, mnx, mny, mxx, mxy, lab = rows
    nrows = rep.shape[0]
    r_s, order = torch.sort(rep)
    new = torch.ones_like(r_s, dtype=torch.bool)
    new[1:] = r_s[1:] != r_s[:-1]
    grp = torch.cumsum(new, 0) - 1

    def reduce(v, how, empty):
        out = torch.full((nrows,), empty, dtype=torch.int64, device=v.device)
        return out.scatter_reduce_(0, grp, v[order], how)

    g = (reduce(rep, "amin", _BIG), reduce(area, "sum", 0), reduce(sx, "sum", 0),
         reduce(sy, "sum", 0), reduce(mnx, "amin", _BIG), reduce(mny, "amin", _BIG),
         reduce(mxx, "amax", -1), reduce(mxy, "amax", -1), reduce(lab, "amax", 0))
    valid = (g[0] < _BIG) & (g[1] > 0) & (g[8] >= 1) & (g[8] <= cap)
    return (*g, valid)


def _udiv(s: torch.Tensor, area: torch.Tensor) -> torch.Tensor:
    """C's unsigned division of the coordinate sum, wrapped to 32 bits, by the area."""
    return (s & _U32) // area


def _blob_table(merged, cap: int) -> Blobs:
    """The merged groups compacted in ascending creation label, as ``blobs``' table."""
    _, area, sx, sy, mnx, mny, mxx, mxy, lab, valid = merged
    order = torch.argsort(torch.where(valid, lab, _BIG))[:cap]
    ok = valid[order]

    def take(v):
        return torch.where(ok, v[order], 0)

    t_area = take(area)
    safe = t_area.clamp(min=1)
    fields = (take(lab), t_area, take(mnx), take(mny), take(mxx - mnx + 1), take(mxy - mny + 1),
              _udiv(take(sx), safe), _udiv(take(sy), safe))
    lab_t, area_t, bx, by, bw, bh, cx, cy = (v.to(torch.int32) for v in fields)
    return Blobs(valid.sum().to(torch.int32), lab_t, area_t, Rect(bx, by, bw, bh), Point(cx, cy))


def _check_cap(max_blobs) -> int:
    cap = int(max_blobs)
    if cap < 0:
        raise ValueError(f"max_blobs must be >= 0, got {cap}")
    return cap


def blobs_sharded(img, mesh: Mesh, max_blobs: int, space_axis: str = "space",
                  kernels: bool | None = None) -> Blobs:
    """``gs_blobs`` statistics of one H-sharded frame: the :class:`Blobs` table
    on the mesh's first device (the label map is
    :func:`label_components_sharded`'s).

    Bit-identical to ``ops.blobs.blobs``' table whenever the frame's seeds fit
    ``max_blobs``; past that it is ``grayskull_tpu``'s ``blobs_sharded``'s
    (components past the cap are dropped, and a shard with more seeds than
    ``max_blobs + W // 2 + 1`` drops the pixels of its later
    slab-components), not the single-device table's.  The host waits once a
    call (the union-find of :func:`label_components_sharded`).
    """
    cap = _check_cap(max_blobs)
    frame, _, slabs = _space_slabs(img, mesh, space_axis)
    w = frame.shape[1]
    use = kernels is not False
    local, glob = _label_shards(slabs, w, use)
    return _blob_table(_merge_rows(_blob_rows(slabs, local, glob, w, cap, use), cap), cap)


# --------------------------------------------------------------------------
# the document scanner
# --------------------------------------------------------------------------


def _binarize(slabs, h: int, w: int, kernels: bool):
    """blur(1) -> threshold(otsu + 10) on each shard (nanomagick.c:190-191):
    K15 on the 1-row halo slab, the histograms summed on the first device,
    one K3 there, the threshold wrapped mod 256 as the reference's uint8
    parameter is."""
    blur = blur_hist_window if kernels else blur_hist_window_plain
    h_loc = slabs[0].shape[0]
    outs = [blur(x.contiguous(), s * h_loc - 1, 1, h_total=h, row_lo=1, row_hi=1 + h_loc)
            for s, x in enumerate(exchange_halo([x[None] for x in slabs], 1))]
    hist = outs[0][1]
    for _, part in outs[1:]:
        hist = hist + part.to(hist.device, non_blocking=True)
    t = (otsu if kernels else otsu_plain)(hist, h * w)
    t = ((t.to(torch.int32) + 10) % 256).to(torch.uint8)
    return [(b[0, 1:1 + h_loc] > t.to(b.device, non_blocking=True)).to(torch.uint8) * 255
            for b, _ in outs]


def _largest(merged):
    """The first largest blob in creation order: (its rep, or -2 with none;
    its centroid x, y), device scalars."""
    rep, area, sx, sy, *_, lab, valid = merged
    amax = torch.where(valid, area, -1).max()
    top = valid & (area == amax)
    sel = top & (lab == torch.where(top, lab, _BIG).min())

    def take(v):
        return torch.where(sel, v, 0).sum()  # one selected row

    b_area = take(area).clamp(min=1)
    return (torch.where(sel.any(), take(rep), -2), _udiv(take(sx), b_area),
            _udiv(take(sy), b_area))


def _corners(glob, b_rep, cx, cy, w: int) -> torch.Tensor:
    """``gs_blob_corners`` of the component ``b_rep`` on H-shards: the first
    extremes in raster order of x+y and x-y (TL, TR, BR, BL), each shard's
    own and then the shards' (``_first_extreme_sharded``); the centroid when
    the component has no pixel.  (4, 2) int32 on the first device."""
    far = 2**30
    h_loc = glob[0].shape[0]
    dev0 = glob[0].device
    vals, idxs, has = [], [], []
    for s, g in enumerate(glob):
        dev = g.device
        mask = (g == b_rep.to(dev, non_blocking=True)).view(1, -1)
        xs = torch.arange(w, dtype=torch.int32, device=dev).repeat(h_loc)
        ys = torch.arange(h_loc, dtype=torch.int32, device=dev).repeat_interleave(w) + s * h_loc
        # min x+y, max x+y, min x-y, max x-y, each as a minimum
        keys = torch.where(mask, torch.stack([xs + ys, -(xs + ys), xs - ys, ys - xs]), far)
        val, i = keys.min(1)  # the first of tied minima
        any_px = mask.any()
        vals.append(val.to(dev0, non_blocking=True))
        idxs.append(torch.where(any_px, i + s * h_loc * w, far).to(dev0, non_blocking=True))
        has.append(any_px.to(dev0, non_blocking=True))
    vals, idxs, has = torch.stack(vals), torch.stack(idxs), torch.stack(has)[:, None]
    best = torch.where(has, vals, far).min(0).values
    gsel = torch.where(has & (vals == best), idxs, far).min(0).values
    found = has.any()
    xy = torch.stack([torch.where(found, gsel % w, cx), torch.where(found, gsel // w, cy)], 1)
    return torch.stack([xy[0], xy[3], xy[1], xy[2]]).to(torch.int32)


def scan_spatial_shardmap(img, mesh: Mesh, out_size=(1000, 800), max_blobs: int = 1000,
                          space_axis: str = "space", kernels: bool | None = None):
    """The document scanner on one H-sharded frame: ``(page, corners)``,
    (out_h, out_w) uint8 and (4, 2) int32 on the mesh's first device,
    bit-identical to ``pipelines.scan(img, out_size, max_blobs)`` whenever the
    frame's seeds fit ``max_blobs`` (past that, ``grayskull_tpu``'s
    ``scan_spatial_shardmap``'s).

    ``img``: (H, W) uint8 with H and ``out_size[0]`` divisible by the space
    axis (``ValueError`` otherwise).  Each stage runs on the shards: K15 and
    one K3 (binarize), K9 and the union-find (labels), the blob statistics,
    the corners, and K10's rows entry for each shard's band of page rows,
    sampled from the whole frame.  The host waits once a call (the
    union-find).  ``kernels=False`` runs the plain versions.
    """
    cap = _check_cap(max_blobs)
    out_h, out_w = int(out_size[0]), int(out_size[1])
    frame, devices, slabs = _space_slabs(img, mesh, space_axis)
    h, w = frame.shape
    ns = len(devices)
    if out_h < 1 or out_w < 1:
        raise ValueError(f"page size must be positive, got {(out_h, out_w)}")
    band = _split(out_h, ns, f"page height over '{space_axis}':")
    use = kernels is not False
    binary = _binarize(slabs, h, w, use)
    local, glob = _label_shards(binary, w, use)
    b_rep, cx, cy = _largest(_merge_rows(_blob_rows(binary, local, glob, w, cap, use), cap))
    corners = _corners(glob, b_rep, cx, cy, w)
    warp = quad_warp_rows if use else quad_warp_rows_plain
    pieces = []
    for s, dev in enumerate(devices):
        src = frame.to(dev, non_blocking=True).contiguous()[None]  # the frame, gathered
        c = corners.to(dev, non_blocking=True)[None]
        pieces.append((slice(s * band, (s + 1) * band),
                       warp(src, c, (out_h, out_w), s * band, band)[0]))
    dev0 = mesh.devices.flat[0]
    page = _gather(pieces, (out_h, out_w), torch.uint8, dev0)
    return page, corners.to(dev0, non_blocking=True)


# --------------------------------------------------------------------------
# ORB on one H-sharded frame
# --------------------------------------------------------------------------


def _fast_slab_rows(s: int, ns: int, h_loc: int) -> tuple[int, int]:
    """The frame rows ``[lo, hi)`` of shard ``s``'s FAST slab: its own rows and
    4 halo rows each side, cut at the frame's top and bottom (none above the
    first shard, none below the last), so that K6's 3-pixel interior of the
    slab is the frame's interior there and covers the shard's rows with one
    NMS guard row each side."""
    return max(s * h_loc - _FAST_HALO, 0), min((s + 1) * h_loc + _FAST_HALO, ns * h_loc)


def _frame_keys(slab_key: torch.Tensor, lo: int, row0: int, h_loc: int, h: int,
               w: int) -> torch.Tensor:
    """The (h_loc * W,) keys of frame rows ``row0 .. row0 + h_loc - 1`` in the
    frame's numbering, from K6's key map of a slab of frame rows from ``lo``.

    A slab key is ``(R*W - i) << 8 | score`` for slab index ``i``; the frame's
    is ``(H*W - (i + lo*W)) << 8 | score``, so a nonzero key gains
    ``(H - R - lo) * W << 8``.  Keys are int64 where ``H*W >= 2^23``, as K6
    packs them, even when the slab's fit in int32.
    """
    r = slab_key.shape[0]
    own = slab_key[row0 - lo:row0 - lo + h_loc].reshape(-1)
    if h * w >= 1 << 23:
        own = own.to(torch.int64)
    return torch.where(own > 0, own + (((h - r - lo) * w) << 8), 0)


def orb_extract_spatial(img, mesh: Mesh, max_kps: int, threshold, space_axis: str = "space",
                        kernels: bool | None = None) -> Keypoints:
    """``gs_orb_extract`` on one H-sharded frame: a :class:`Keypoints` table on
    the mesh's first device, bit-identical to ``ops.features.orb_extract(img,
    max_kps, threshold)`` in the same trig mode.

    ``img``: (H, W) uint8 with H divisible by the space axis and
    ``H / shards >= 28`` (the patch halo); ``ValueError`` otherwise.  K6 per
    shard slab, K7 and K8 per shard on the keypoints of its rows (and K21 on
    the first device in the ``freestanding`` trig mode); no host wait outside
    the ``exact_host`` trig mode.  ``kernels=False`` runs the plain versions.
    """
    frame = as_image(img)
    if frame.ndim != 2:
        raise ValueError(f"expected one (H, W) frame, got {tuple(frame.shape)}")
    h, w = frame.shape
    devices = list(_grid(mesh, space_axis))
    ns = len(devices)
    if h % ns or h // ns < _PATCH_HALO:
        raise ValueError(f"H={h} must be divisible by {ns} shards of >= {_PATCH_HALO} rows")
    h_loc = h // ns
    cap = int(max_kps)
    cand = min(cap * 4, _MAX_CANDIDATES)
    use = kernels is not False
    run_fast = fast if use else fast_plain
    moments = orb_moments if use else orb_moments_plain
    brief = orb_brief if use else orb_brief_plain
    dev0 = mesh.devices.flat[0]
    shards = [frame[s * h_loc:(s + 1) * h_loc].to(dev, non_blocking=True)
              for s, dev in enumerate(devices)]
    # each shard's rows with 28 halo rows a side (zeros past the frame): the
    # patches' slab, and the FAST slab cut from it
    halos = exchange_halo(shards, _PATCH_HALO)

    # FAST: each shard's keys, its own top candidates, then the frame's
    tables = []
    for s, x in enumerate(halos):
        lo, hi = _fast_slab_rows(s, ns, h_loc)
        top = s * h_loc - _PATCH_HALO
        _, key = run_fast(x[lo - top:hi - top][None].contiguous(), threshold)
        own = _frame_keys(key[0], lo, s * h_loc, h_loc, h, w)
        tables.append(torch.topk(own, min(cand, own.numel()), sorted=False).values)
    k_loc = tables[0].numel()
    keys = _gather([(slice(s * k_loc, (s + 1) * k_loc), t) for s, t in enumerate(tables)],
                   (ns * k_loc,), tables[0].dtype, dev0)
    n_cand, x, y, r = _emit(keys[None], cand, h, w)
    valid = torch.arange(cand, device=dev0)[None, :] < n_cand[:, None]
    n, x, y, r = _select_candidates(x, y, r, valid, cap, ORB_RADIUS, h, w)

    # orientation and rBRIEF on each shard's 28-row halo slab, keypoints of its rows
    sx = torch.clamp(x, ORB_RADIUS, w - ORB_RADIUS - 1)
    sy = torch.clamp(y, ORB_RADIUS, h - ORB_RADIUS - 1)
    slabs = [x[None].contiguous() for x in halos]
    owned, coords = [], []
    for s, dev in enumerate(devices):
        row0 = s * h_loc
        owned.append((sy >= row0) & (sy < row0 + h_loc))
        ly = torch.clamp(sy - row0 + _PATCH_HALO, 0, h_loc + 2 * _PATCH_HALO - 1)
        coords.append((sx.to(dev, non_blocking=True), ly.to(dev, non_blocking=True)))
    m01 = torch.zeros_like(x)
    m10 = torch.zeros_like(x)
    for slab, own, (xs, ys) in zip(slabs, owned, coords):
        a, b = moments(slab, xs, ys, ORB_RADIUS)
        m01 = torch.where(own, a.to(dev0, non_blocking=True), m01)
        m10 = torch.where(own, b.to(dev0, non_blocking=True), m10)
    angle, sin, cos = orientation_trig(m01, m10, not use)
    desc = torch.zeros((1, cap, 8), dtype=torch.int32, device=dev0)
    for slab, own, (xs, ys) in zip(slabs, owned, coords):
        dev = slab.device
        d = brief(slab, xs, ys, sin.to(dev, non_blocking=True), cos.to(dev, non_blocking=True))
        desc = torch.where(own[..., None], d.view(torch.int32).to(dev0, non_blocking=True), desc)
    ok = torch.arange(cap, device=dev0)[None, :] < n[:, None]
    angle = torch.where(ok, angle, 0.0)
    desc = torch.where(ok[..., None], desc, 0).view(torch.uint32)
    return Keypoints(n[0], x[0], y[0], r[0], angle[0], desc[0])


# --------------------------------------------------------------------------
# descriptor matching
# --------------------------------------------------------------------------


def match_orb_sharded(kps1: Keypoints, kps2: Keypoints, mesh: Mesh, max_matches: int,
                      max_distance, axis: str = "space") -> Matches:
    """``gs_match_orb`` with the Hamming matrix sharded over query rows: the
    :class:`Matches` table on the mesh's first device, equal to
    ``ops.features.match_orb``'s.

    The query table's capacity must divide over the axis (``ValueError``).
    Each shard takes its query rows against the whole target table; the
    accept, index and distance columns are gathered and the emission runs on
    the first device.  No host wait.
    """
    devices = list(_grid(mesh, axis))
    desc1, desc2 = as_tensor(kps1.descriptor), as_tensor(kps2.descriptor)
    cap1 = desc1.shape[0]
    cap_loc = _split(cap1, len(devices), f"query table of {cap1} rows over '{axis}':")
    dev0 = mesh.devices.flat[0]
    cols = []
    for s, dev in enumerate(devices):
        rows = torch.arange(s * cap_loc, (s + 1) * cap_loc, dtype=torch.int32, device=dev)
        part = _best_matches(desc1[s * cap_loc:(s + 1) * cap_loc].to(dev, non_blocking=True), rows,
                             as_tensor(kps1.n).to(dev, non_blocking=True),
                             desc2.to(dev, non_blocking=True),
                             as_tensor(kps2.n).to(dev, non_blocking=True), max_distance)
        cols.append(part)
    mask, best_idx, best = (_gather([(slice(s * cap_loc, (s + 1) * cap_loc), c[k])
                                     for s, c in enumerate(cols)], (cap1,), dtype, dev0)
                            for k, dtype in enumerate((torch.bool, torch.int32, torch.int32)))
    rows = torch.arange(cap1, dtype=torch.int32, device=dev0)
    n, (i1, i2, dist) = _rank_scatter(mask[None], int(max_matches),
                                      (rows[None], best_idx[None], best[None]))
    return Matches(n[0], i1[0], i2[0], dist[0])


# --------------------------------------------------------------------------
# LBP detection and faces
# --------------------------------------------------------------------------


def _band_slab_rows(y0: int, rows: int, reach: int, ih: int) -> tuple[int, int]:
    """The integral rows ``[top, end)`` that K5 reads for window rows ``y0 ..
    y0 + rows - 1`` whose features reach ``reach`` rows (``max(fy + 3*fh)``).

    K5 reads row -1 of its array as zero, the integral's top edge guard.  A
    band below the first window row starts one row above its windows, at
    row ``y0 - 1``, and is launched with origin row 1; the first band starts
    at row 0, origin 0.  Rows past the frame read zero, as they do for the
    whole frame.
    """
    top = max(y0 - 1, 0)
    return top, min(ih, y0 + rows - 1 + reach)


def lbp_detect_sharded(cascade, ii, mesh: Mesh, max_rects: int, scale_factor=1.2,
                       min_scale=1.0, max_scale=4.0, data_axis: str = "data",
                       space_axis: str = "space", kernels: bool | None = None) -> Rects:
    """``gs_lbp_detect`` with each scale's window rows in bands over ``space``
    and the frames over ``data``: bit-identical to ``lbp_detect`` (step 1),
    its (scale, y, x) emission order and ``max_rects`` truncation included.

    ``ii``: the (H, W) or (N, H, W) uint32 integral, N divisible by the data
    axis.  For each ladder scale, each (data shard, band) launches K5 on its
    band's slab of the integral on its device (``kernels=False``: the plain
    version); the hit masks are gathered on the mesh's first device for the
    emission.  No host wait.
    """
    ii = _as_integral(ii)
    single = ii.ndim == 2
    iib = ii[None] if single else ii
    nb, ih, iw = iib.shape
    grid = _grid(mesh, data_axis, space_axis)
    nd, ns = grid.shape
    n_loc = _split(nb, nd, f"batch of {nb} integrals over '{data_axis}':")
    cap = int(max_rects)
    dev0 = mesh.devices.flat[0]
    plan = _grid_plan(cascade, ih, iw, scale_factor, min_scale, max_scale, 1)
    if not plan:
        z = torch.zeros((nb, cap), dtype=torch.int32, device=dev0)
        table = Rects(torch.zeros(nb, dtype=torch.int32, device=dev0), z, z, z, z)
        return Rects(*(v[0] for v in table)) if single else table
    evaluate = lbp_eval_scale_plain if kernels is False else lbp_eval_scale
    wi = cascade.weak_feature_idx.astype(np.int64)
    hits = []
    for scale, _, _, ny, nx in plan:
        _, fy, _, fh = _scaled_features(cascade, scale)
        reach = int((fy[wi] + 3 * fh[wi]).max())
        band = -(-ny // ns)
        pieces = []
        for d in range(nd):
            frames = iib[d * n_loc:(d + 1) * n_loc]
            for s in range(ns):
                y0 = s * band
                rows = min(band, ny - y0)
                if rows <= 0:
                    continue
                top, end = _band_slab_rows(y0, rows, reach, ih)
                slab = frames[:, top:end].to(grid[d, s], non_blocking=True).contiguous()
                pieces.append(((slice(d * n_loc, (d + 1) * n_loc), slice(y0, y0 + rows)),
                               evaluate(cascade, slab, scale, rows, nx, 1, (y0 - top, 0))))
        hits.append(_gather(pieces, (nb, ny, nx), torch.bool, dev0))
    table = _emit_rects(hits, plan, 1, cap)
    return Rects(*(v[0] for v in table)) if single else table


def detect_faces_sharded(imgs, mesh: Mesh, cascade=None, max_rects: int = 100,
                         scale_factor=1.2, min_scale=1.0, max_scale=4.0,
                         data_axis: str = "data", space_axis: str = "space",
                         kernels: bool | None = None) -> Rects:
    """Sharded face detection: :func:`~.sharded.integral_sharded` (K4 a
    shard) feeding :func:`lbp_detect_sharded` (K5 a band), bit-identical to
    ``pipelines.detect_faces`` at step 1.  ``imgs`` is (H, W) or (N, H, W)
    uint8; H divides over ``space`` and N over ``data``.  No host wait."""
    if cascade is None:
        cascade = load_frontalface()
    img = as_image(imgs)
    single = img.ndim == 2
    batch = img[None] if single else img
    ii = integral_sharded(batch, mesh, data_axis=data_axis, space_axis=space_axis,
                          kernels=kernels)
    out = lbp_detect_sharded(cascade, ii, mesh, max_rects, scale_factor, min_scale, max_scale,
                             data_axis, space_axis, kernels)
    return Rects(*(v[0] for v in out)) if single else out
