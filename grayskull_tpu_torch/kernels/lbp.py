"""One ladder scale of the LBP cascade over a window grid, with its plain version.

:func:`lbp_eval_scale` (K5, ``csrc/lbp.cu:gs_lbp_eval_scale``) replaces the Pallas
kernel ``grayskull_tpu/kernels/lbp.py:396 lbp_eval_scale``.  It takes the
**unpadded** ``(N, H, W)`` uint32 integral and returns the ``(N, ny, nx)`` bool
mask of windows that pass every stage, at stride ``step`` from ``origin``.

The scale's tables are built host-side in numpy exactly as
``grayskull_tpu/ops/lbp.py:59-84`` builds them (float32 feature scaling with C
truncation, ``max(., 1)`` on block sizes, zero-padded subset words), packed by
:func:`scale_tables` and uploaded once per (cascade, scale, device).

Reads of the integral follow the JAX package's zero guard: index -1 and
anything past ``H``/``W`` read 0, as ``_eval_windows``' padding gives.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
:func:`lbp_eval_scale_plain`.  ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import profiling
from . import _build
from .integral import u32_to_int64

__all__ = ["launches", "lbp_eval_scale", "lbp_eval_scale_plain", "scale_tables"]

launches = {"lbp_eval_scale": 0}

# block order (bj*3+bi): TL TC TR L C R BL BC BR -> code bit per block
# (grayskull.h:781-782): TL<<7, TC<<6, TR<<5, R<<4, BR<<3, BC<<2, BL<<1, L<<0
_BLOCK_BITS = (7, 6, 5, 0, -1, 4, 1, 2, 3)  # -1 = center
# the kernel keeps the tables, two window queues and the hit bytes of its
# largest tile (64 x 32 windows, 10 KB) and 1,024 float leaves in one block's
# shared memory (227 KB on Hopper): about 3,630 weaks
_MAX_SMEM_BYTES = 227 * 1024
_TILE_BYTES = 64 * 32 * 5 + 1024 * 4


def _scaled_features(cascade, scale: float):
    """Per-feature scaled geometry (grayskull.h:799-804), host-side f32 truncation."""
    s = np.float32(scale)
    feats = cascade.features.astype(np.int32)
    fx = (feats[:, 0].astype(np.float32) * s).astype(np.int32)
    fy = (feats[:, 1].astype(np.float32) * s).astype(np.int32)
    fw = np.maximum((feats[:, 2].astype(np.float32) * s).astype(np.int32), 1)
    fh = np.maximum((feats[:, 3].astype(np.float32) * s).astype(np.int32), 1)
    return fx, fy, fw, fh


def _weak_tables(cascade, scale: float):
    """(geometry (nweaks, 4) [fx, fy, fw, fh], subset words (nweaks, 8), counts)."""
    fx, fy, fw, fh = _scaled_features(cascade, scale)
    wi = cascade.weak_feature_idx.astype(np.int64)
    geo = np.stack([fx[wi], fy[wi], fw[wi], fh[wi]], axis=1).astype(np.int32)
    words = np.zeros((cascade.nweaks, 8), np.int32)
    for k in range(cascade.nweaks):
        off = int(cascade.weak_subset_offset[k])
        num = min(int(cascade.weak_num_subsets[k]), 8)
        words[k, :num] = cascade.subsets[off : off + num]
    return geo, words, cascade.weak_num_subsets.astype(np.int32)


@functools.lru_cache(maxsize=256)
def scale_tables(cascade, scale: float) -> np.ndarray:
    """The scale's packed int32 table words, in ``csrc/lbp.cu``'s layout."""
    geo, words, counts = _weak_tables(cascade, scale)
    leaves = np.stack([cascade.weak_left_val, cascade.weak_right_val], axis=1)
    stages = np.stack([cascade.stage_weak_start, cascade.stage_nweaks], axis=1)
    out = np.concatenate([
        geo.reshape(-1), words.reshape(-1), counts,
        leaves.astype(np.float32).view(np.int32).reshape(-1),
        stages.astype(np.int32).reshape(-1),
        cascade.stage_threshold.astype(np.float32).view(np.int32),
    ])
    if -(-out.nbytes // 16) * 16 + _TILE_BYTES > _MAX_SMEM_BYTES:
        raise ValueError(f"lbp: cascade tables of {out.nbytes} B and a tile's {_TILE_BYTES} B "
                         f"exceed the {_MAX_SMEM_BYTES} B of shared memory")
    return out


@functools.lru_cache(maxsize=256)
def _device_tables(cascade, scale: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(scale_tables(cascade, scale)).to(device)


def _check(cascade, ii: torch.Tensor, ny: int, nx: int, step: int, origin) -> None:
    if cascade.nstages < 1 or np.any(cascade.stage_nweaks < 1):
        raise ValueError("lbp_eval_scale: every cascade stage needs at least one weak classifier")
    if not isinstance(ii, torch.Tensor):
        raise TypeError(f"lbp_eval_scale: expected a torch.Tensor, got {type(ii).__name__}")
    if ii.dtype != torch.uint32:
        raise TypeError(f"lbp_eval_scale: integral must be torch.uint32, got {ii.dtype}")
    if ii.ndim != 3 or min(ii.shape) < 1:
        raise ValueError(f"lbp_eval_scale: expected non-empty (N, H, W), got {tuple(ii.shape)}")
    if not ii.is_contiguous():
        raise ValueError("lbp_eval_scale: integral must be contiguous")
    if ny < 1 or nx < 1 or step < 1 or min(origin) < 0:
        raise ValueError(f"lbp_eval_scale: bad grid ny={ny} nx={nx} step={step} origin={origin}")


def lbp_eval_scale_plain(cascade, ii: torch.Tensor, scale: float, ny: int, nx: int,
                         step: int = 1, origin=(0, 0)) -> torch.Tensor:
    """Plain version of :func:`lbp_eval_scale`, a transcription of ``_eval_windows``.

    The integral is padded with one leading zero row and column (the edge
    guards) and zeros past the frame; one rect-sum map per distinct scaled block
    size is four slices of it; a weak's nine block sums are strided slices of
    its map.  Every window runs every stage, and each stage's sum is
    accumulated weak by weak in float32.
    """
    _check(cascade, ii, ny, nx, step, origin)
    n, h, w = ii.shape
    oy0, ox0 = int(origin[0]), int(origin[1])
    geo, words, counts = _weak_tables(cascade, scale)
    fx, fy, fw, fh = (geo[:, c].tolist() for c in range(4))
    hm = oy0 + (ny - 1) * step + int((geo[:, 1] + 3 * geo[:, 3]).max()) + 1
    wm = ox0 + (nx - 1) * step + int((geo[:, 0] + 3 * geo[:, 2]).max()) + 1
    pad = torch.zeros((n, max(hm + int(geo[:, 3].max()), h + 1),
                       max(wm + int(geo[:, 2].max()), w + 1)), dtype=torch.int64, device=ii.device)
    pad[:, 1 : h + 1, 1 : w + 1] = u32_to_int64(ii)
    maps = {}
    for bw, bh in sorted(set(zip(fw, fh))):
        maps[(bw, bh)] = (pad[:, bh : bh + hm, bw : bw + wm] + pad[:, :hm, :wm]
                          - pad[:, :hm, bw : bw + wm] - pad[:, bh : bh + hm, :wm]) & 0xFFFFFFFF
    weights = torch.tensor([1 << b for b in _BLOCK_BITS if b >= 0], dtype=torch.int32,
                           device=ii.device).view(1, 8, 1, 1)
    words_t = torch.from_numpy(words.astype(np.int64)).to(ii.device)
    left = torch.from_numpy(cascade.weak_left_val.astype(np.float32)).to(ii.device)
    right = torch.from_numpy(cascade.weak_right_val.astype(np.float32)).to(ii.device)

    def leaf(k):
        rs = maps[(fw[k], fh[k])]
        blocks = []
        for bj in range(3):
            for bi in range(3):
                oy = oy0 + fy[k] + bj * fh[k]
                ox = ox0 + fx[k] + bi * fw[k]
                blocks.append(rs[:, oy : oy + (ny - 1) * step + 1 : step,
                                 ox : ox + (nx - 1) * step + 1 : step])
        outer = torch.stack([b for b, bit in zip(blocks, _BLOCK_BITS) if bit >= 0], dim=1)
        code = ((outer >= blocks[4].unsqueeze(1)).to(torch.int32) * weights).sum(1)
        idx = (code >> 5).to(torch.int64)
        match = (idx < int(counts[k])) & (((words_t[k][idx] >> (code & 31)) & 1) == 1)
        return torch.where(match, left[k], right[k])

    thresholds = torch.from_numpy(cascade.stage_threshold.astype(np.float32)).to(ii.device)
    ok = None
    for s in range(cascade.nstages):
        k0 = int(cascade.stage_weak_start[s])
        ssum = leaf(k0)
        for k in range(k0 + 1, k0 + int(cascade.stage_nweaks[s])):
            ssum = ssum + leaf(k)
        passed = ssum >= thresholds[s]
        ok = passed if ok is None else ok & passed
    return ok


@profiling.spanned("gs.kernels.lbp_eval_scale")
def lbp_eval_scale(cascade, ii: torch.Tensor, scale: float, ny: int, nx: int,
                   step: int = 1, origin=(0, 0)) -> torch.Tensor:
    """K5: (N, H, W) uint32 integral -> (N, ny, nx) bool hits of one ladder scale.

    Window ``(i, j)`` sits at ``(y, x) = (origin[0] + i*step, origin[1] + j*step)``.
    """
    _check(cascade, ii, ny, nx, step, origin)
    if not ii.is_cuda:
        return lbp_eval_scale_plain(cascade, ii, scale, ny, nx, step, origin)
    n, h, w = ii.shape
    if n > 65535 or ny > 65535:
        raise ValueError(f"lbp_eval_scale: at most 65535 frames and grid rows, got {n}, {ny}")
    tables = _device_tables(cascade, float(scale), ii.device)
    lib = _build.library()
    hits = torch.empty((n, ny, nx), dtype=torch.uint8, device=ii.device)
    with torch.cuda.device(ii.device):
        code = lib.gs_lbp_eval_scale(ii.data_ptr(), tables.data_ptr(), hits.data_ptr(), n, h, w,
                                     ny, nx, step, int(origin[0]), int(origin[1]),
                                     cascade.nweaks, cascade.nstages, _build.stream_of(ii))
    _build.check(code, "lbp_eval_scale")
    launches["lbp_eval_scale"] += 1
    return hits.view(torch.bool)
