"""Connected-component labelling, with its plain PyTorch version.

:func:`ccl` (K9, ``csrc/ccl.cu:gs_ccl``) replaces the Pallas kernel
``grayskull_tpu/kernels/ccl.py:161 ccl_serpentine``: ``(N, H, W)`` uint8 frames
to ``(N, H, W)`` int32 labels, -1 for background (``< 128``) and, for every
other pixel, the smallest per-frame raster index ``y*W + x`` of its
4-connected component.  That is the fixpoint the TPU kernel's strip sweeps
reach from ``L0 = raster index``; the card computes it by union-find instead
(the source says how), so there is no sweep count.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
:func:`ccl_plain`.  ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from .. import profiling
from . import _build
from .preproc import _check_frames

__all__ = ["ccl", "ccl_plain", "launches"]

launches = {"ccl": 0}


def _reversed_cummax(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cummax(x.flip(dim), dim).values.flip(dim)


def ccl_plain(imgs: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ccl`: the JAX package's CPU algorithm
    (``grayskull_tpu/ops/blobs.py:186-231``) on the whole batch.

    Each round min-propagates labels along every foreground run of every row
    and column, in both directions, with one ``torch.cummax`` per direction
    over the packed key ``run_id << vbits | (vmask - label)``: run ids grow
    along the scan, so a later run's key beats anything leaking across a
    background gap, and within a run the largest key is the smallest label.
    Rounds repeat until one changes nothing.  The keys are int64, so the bit
    budget always holds and the JAX package's pointer-jump fallback is not
    needed.
    """
    n, h, w = imgs.shape
    big = h * w
    vbits = big.bit_length()
    vmask = (1 << vbits) - 1
    fg = imgs >= 128
    bg = ~fg
    idx = torch.arange(big, device=imgs.device, dtype=torch.int64).view(1, h, w)
    labels = torch.where(fg, idx, big)
    no_col = torch.zeros((n, h, 1), dtype=torch.bool, device=imgs.device)
    no_row = torch.zeros((n, 1, w), dtype=torch.bool, device=imgs.device)
    fg_left = torch.cat([no_col, fg[:, :, :-1]], 2)
    fg_right = torch.cat([fg[:, :, 1:], no_col], 2)
    fg_top = torch.cat([no_row, fg[:, :-1]], 1)
    fg_bottom = torch.cat([fg[:, 1:], no_row], 1)

    def run_ids(starts, dim, reverse):
        s = starts.to(torch.int64)
        if reverse:
            return torch.cumsum(s.flip(dim), dim).flip(dim)
        return torch.cumsum(s, dim)

    scans = [(dim, reverse, run_ids(fg & ~before, dim, reverse) << vbits)
             for dim, reverse, before in ((2, False, fg_left), (2, True, fg_right),
                                          (1, False, fg_top), (1, True, fg_bottom))]
    while True:
        out = labels
        for dim, reverse, rid in scans:
            key = rid | (vmask - out)
            m = _reversed_cummax(key, dim) if reverse else torch.cummax(key, dim).values
            out = torch.minimum(out, torch.where(bg, big, vmask - (m & vmask)))
        if torch.equal(out, labels):
            break
        labels = out
    return torch.where(fg, labels, -1).to(torch.int32)


@profiling.spanned("gs.kernels.ccl")
def ccl(imgs: torch.Tensor) -> torch.Tensor:
    """K9: (N, H, W) uint8 -> (N, H, W) int32 component minima, -1 for background."""
    _check_frames(imgs, "ccl")
    n, h, w = imgs.shape
    if h * w >= 2**31:
        raise ValueError(f"ccl: a frame must have fewer than 2^31 pixels, got {h}x{w}")
    if not imgs.is_cuda:
        return ccl_plain(imgs)
    lib = _build.library()
    out = torch.empty((n, h, w), dtype=torch.int32, device=imgs.device)
    with torch.cuda.device(imgs.device):
        code = lib.gs_ccl(imgs.data_ptr(), out.data_ptr(), n, h, w, _build.stream_of(imgs))
    _build.check(code, "ccl")
    launches["ccl"] += 1
    return out
