"""Plain reference of ``document_scan`` (``nanomagick.c:186-210``): blur(1) ->
threshold(otsu + 10) -> blobs -> the largest blob's corners -> quad warp, in
plain PyTorch on the frames' device (``portbench/plain.py``; nothing of the
port).

The blob layer follows ``grayskull.h:330-421`` directly, for the largest
blob alone:

* C gives a fresh label at each *seed*, a foreground pixel (``>= 128``)
  with no foreground left or top neighbour, and merges into the smaller
  label, so a component's label is the raster rank of its first seed, which
  is its least pixel; labels past ``max_blobs`` are dropped;
* the largest blob is the first (smallest label) of the largest areas;
  its box and its centroid (coordinate sums wrapped to uint32, divided
  unsigned) follow from its pixels;
* its corners are the first pixels in raster order at the least and the
  largest ``x + y`` (TL, BR) and ``x - y`` (BL, TR); a frame without a
  blob gives (0, 0) for every corner, as the port's empty table does.

``control=True`` computes the Otsu sweep and the warp in bfloat16, the next
precision below the float32 that the reference states.
"""

from __future__ import annotations

import torch

from portbench import plain

_BLOCK = 8  # pages a step: bounds the labelling's int64 maps
_U32 = 0xFFFFFFFF


def _largest_blob_corners(fg, max_blobs):
    """(N, 4, 2) int32 corners of each frame's largest blob."""
    n, h, w = fg.shape
    hw = h * w
    dev = fg.device
    no_col = torch.zeros((n, h, 1), dtype=torch.bool, device=dev)
    no_row = torch.zeros((n, 1, w), dtype=torch.bool, device=dev)
    seed = fg & ~torch.cat([no_col, fg[:, :, :-1]], 2) & ~torch.cat([no_row, fg[:, :-1]], 1)
    rank = torch.cumsum(seed.view(n, hw).to(torch.int64), 1)
    least = plain.component_minima(fg).view(n, hw)
    fgf = fg.view(n, hw)
    label = torch.where(fgf, rank.gather(1, least.clamp(max=hw - 1)), 0)
    label = torch.where(label <= max_blobs, label, 0)

    nseg = max_blobs + 1
    keys = (label + torch.arange(n, device=dev).view(n, 1) * nseg)[label > 0]
    area = torch.bincount(keys, minlength=n * nseg).view(n, nseg)
    labels = torch.arange(nseg, device=dev)
    best = (area * nseg + (max_blobs - labels)).amax(1)  # the largest area, then the least label
    big = best // nseg
    mask = (label == (max_blobs - best % nseg).view(n, 1)) & (label > 0)

    pix = torch.arange(hw, device=dev)
    xs, ys = pix % w, pix // w
    count = big.clamp(min=1)
    cx = ((torch.where(mask, xs, 0).sum(1) & _U32) // count)
    cy = ((torch.where(mask, ys, 0).sum(1) & _U32) // count)

    def first(key, largest):
        """Pixel of the least (largest) ``key``, the first in raster order on ties."""
        if largest:
            k = torch.where(mask, key * hw + (hw - 1 - pix), -1).amax(1)
            p = hw - 1 - k % hw
        else:
            k = torch.where(mask, key * hw + pix, 2**62).amin(1)
            p = k % hw
        return torch.stack([torch.where(big > 0, p % w, cx), torch.where(big > 0, p // w, cy)], 1)

    s, d = xs + ys, xs - ys + h  # d shifted to stay >= 0
    corners = torch.stack([first(s, False), first(d, True), first(s, True), first(d, False)], 1)
    return corners.to(torch.int32)


def reference(frames, params, control=False):
    """The outputs of ``scan`` for (N, H, W) uint8 pages: ``pages`` and ``corners``."""
    dtype = torch.bfloat16 if control else torch.float32
    n, h, w = frames.shape
    blurred = plain.blur(frames, 1)
    t = plain.otsu(plain.histograms(blurred), h * w, dtype)
    # C passes otsu + 10 through a uint8 parameter (nanomagick.c:191): it wraps
    t = ((t.to(torch.int32) + 10) % 256).to(torch.uint8)
    fg = blurred > t.view(-1, 1, 1)
    corners = torch.cat([_largest_blob_corners(fg[s:s + _BLOCK], int(params["max_blobs"]))
                         for s in range(0, n, _BLOCK)])
    pages = plain.quad_warp(frames, corners, tuple(params["out_size"]), dtype)
    return {"pages": pages, "corners": corners}
