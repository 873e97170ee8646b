#!/usr/bin/env python3
"""Time variants of one ``csrc/*.cu`` file's kernels against each other on one card.

Run from the repository root on a machine with an NVIDIA Hopper card::

    python3 chip_sweep.py [--source {preproc,stencil3,bandwidth,resize,fast,otsu,patches,ccl,
                                     integral,warp,template,contour,freestanding}]
                          [--parent DIR ...] [--only NAME ...]

It builds ``grayskull_tpu_torch/csrc/<source>.cu`` as it is and in variants
that are text edits of it, each into a library of its own under
``grayskull_tpu_torch/_build/sweep/<source>/`` (``nvcc -Xptxas -v`` prints
each kernel's registers), and, with ``--parent``, the same file under each DIR
(for example the parent commit unpacked with ``git archive``; the variant is
named after the directory); ``--only`` keeps the variants named.  Each
library's kernels are held bit for bit to their plain versions at the shapes
of PERF.md's kernel table (a text-edit variant that does not build, or
differs, is reported and dropped; the committed file or a ``--parent`` one
that does stops the sweep), then every variant is
timed in turns, first in order and then in reverse, with ``profiling.timeit``
(median of 3 windows of 20 calls), on the same inputs.

``--source preproc`` (the default): K2/K16's strip of rows a warp sweeps
(``kSobelStrip``: 32, 64, 128), the outputs a K11 thread makes in its row
pass (``kAdaptiveItem``: 16, 32, 64), and two ablations of
``blur_hist_kernel`` that skip its vertical pass or its row pass (their
outputs are wrong and not checked: they split K1's and K11's time between
the stages), on

* K1 ``blur_hist``: 256 frames of lena tiled to 1024x1024, r = 2;
* K2 ``threshold_sobel``: the blurred frames with their Otsu thresholds and
  the binary map, and ``sobel`` (no thresholds) of the frames;
* K16 ``threshold_sobel_window``: the middle shard of a (1, 4) split,
  256 x 258 x 1024;
* K11 ``adaptive``: 256 frames of receipt.pgm (816x612), r = 15, c = 5.

``--source stencil3``: the strip height (``kStrip``: 8, 16, 32, 64, 128), the
4-byte path's lane layout (lane l on words l + 32k of its segment, in place
of the lane's own 16 columns), the byte path in its place, and K13's packed
taps as a rank-1 pass (column sums, then row sums; rank-1 int8 taps only,
others take the multiply-add path), on

* K13 ``filter3``: the 256 lena frames of 1024x1024, Gaussian taps, norm 16;
* K12 ``morph``: config #2's binary frames (``adaptive`` of 256 receipt
  frames, 816x612), dilate and erode.

``--source bandwidth``: K17's aligned path swapped for one that moves 1, 2,
4 or 8 16-byte vectors a thread in blocks of 128 to 1024 threads, every load
issued before the first store (also with 32-bit indices); with streaming
hints (``__ldcs``/``__stcs``)
or ``ld.global.nc.L1::no_allocate`` loads (also asking L2 for 256 bytes); a
persistent grid of 1 or 2 blocks an SM, each block one contiguous span; and
rings of 2 to 4 shared-memory stages of 16 to 64 KiB in one-warp blocks, one
thread filling each stage with a bulk copy (``cp.async.bulk``, ``mbarrier``
completion) and draining it with another (bulk-group commit), the bytes past
the last 16 moved by the last block.  K18's kernel swapped for one that
moves several vectors a thread (1, 2, 4, 8) with every load issued before
the first store, in blocks of 256 or 128 threads, vectors of 16, 8 or 4
bytes, streaming hints on the loads, the stores, both or neither; the
committed kernel without ``__restrict__``; and a ring of shared-memory
stages filled by bulk copies (two persistent blocks an SM, the sum stored by
bulk copies).  On K17 ``copy`` over 256 MiB and over 64 MiB + 197,527 bytes
(a part chunk and a tail) and K18 ``triad`` over 256 MiB;
``Tensor.copy_``, ``torch.add(x, y, out=o)``, ``torch.add(x, y)`` and the
committed entries called into ``o`` without their wrappers are timed in the
same turns, every variant also by the profiler's device time, and every
variant's ``copy`` against ``copy_`` in ``chip_smoke.alternate_windows``
(variants in order, then in reverse); the profiler names what each library
call runs on the device and its device time.

``--source otsu``: K3's lanes a frame (``kLanes``: 8, 16, 32) and frames a
block (``kFrames``), on the histograms K1 makes of the 256 lena frames of
1024x1024 (r = 2) and of scan's 8 frames and one frame of document.pgm (r =
1), timed by events and by the profiler's device time; and a probe of the
card's FADD latency (cycles of a chain of dependent ``__fadd_rn``), the
latency behind K3's bound.

``--source resize``: K14's layout (lane l on columns x0 + l + 32 j with byte
stores, in place of the lane's consecutive columns; also with 1 column a
thread), its columns a thread for downscales (``kColsDown``: 8, 16) and
upscales (``kColsUp``: 4, 8), the frames a block (``kFrames``: 8, 16, 64) and
the grid size below which a block takes fewer (``kMinBlocks``: 0, 512, 8192),
and staged rows against L1 gathers (``kStagePercent``: 0, 360), on 256 frames
of lena tiled to 1024x1024 -> 480x640, of lena at 480x640 -> 768x1024 and of
receipt.pgm (816x612) -> 100x40.

``--source fast``: K6's strip of rows (``kStrip``: 8, 12, 24, 32), its words a
lane (``kWords``: 1, 4), its block size (``kThreads``: 128, 256), and the
score's minimum and the NMS's maximum by ``__vminu4`` / ``__vmaxu4`` in place
of the u16 DPX instructions, on 16 frames of lena at 640x480 (keys; keys and
the score map) and 16 random frames, at threshold 20.  Its kernels are short,
so each variant is timed by the profiler's device events too.

``--source patches``: K7's layout (8 lanes a row on 4-byte words; the
parent's lane a row comes with ``--parent``; lanes along a row's columns, a
byte each), the blocks (``kSmallThreads``: 128, 256; ``kLargeThreads``: 512,
1024; small or large blocks for every call), keypoints a warp (1, 2, 4: the
``KEYS_A_WARP`` kernel), weights from a shared table or computed by each
lane in either block size, dp4a against four multiply-adds, and every keypoint
through the guarded path; K8's split of a keypoint over warps (always,
never, over 2 warps, below 8, 16 or 64 keypoints an SM), its blocks
(``kBriefThreads``: 256), its grid cap (``kBriefBlocksPerSm``: 4, 16, 64),
each keypoint's window staged in shared memory (``STAGED``), and two
ablations (the keypoints' loads and stores alone; with the rotation); on the
16 x 500 keypoints of ``orb_extract`` on lena (clamped as ``orb_extract``
clamps them) and on ``track``'s six calls on aruco (template and scene, 833
or 2,500 keypoints each), K7 and K8 at each.  Device time too.

``--source integral``: K4's band height (``kBand``: 8, 32, 64), block cap
(``kMaxThreads``: 128, 512), at least 4 blocks an SM, and two ablations (the band scan without the
launches before it; those without it); on ``detect_faces``' 32 frames of
640x480, one frame, the 32 x 120 x 640 shard of a (1, 4) mesh, a 4200x4200
frame of 255s and 32 frames of 479x639 at an odd byte offset, with two
``torch.cumsum`` calls as a yardstick.  Device time too.

``--source ccl``: K9's tile (``kTileH`` x ``kTileW``: 32x128, 16x256, 64x64,
16x128, 32x256, 8x256), the flatten of every tile or only of tiles with a
foreground pair across their edge (``FLAGGED_TILES``), labels stored through
shared memory or by each thread, and ablations that skip
the tile pass's unions, pointer jumping or whole labelling or the flatten's
label work (timed, not checked); on scan's 8 document binaries, one of them and 8
random frames of 1024x768 at density 0.55, and the whole 8-frame ``scan``
with each variant's K9.  Device time too.

``--source warp``: K10's page rows a thread walks (``kRows``: 4, 16), its
columns a thread (``kCols``: 1, 2, 8; 2 with 4 rows), the right and lower
neighbours of the last column and row read unchecked in every frame but the
last (``_warp_unguarded``), a thread on kCols adjacent columns with 4-byte
stores in place of columns 32 apart (``_warp_adjacent``), the float
tricks in place of type conversions (a byte as 2^23 + b less 2^23,
``BYTE_TRICK``; a coordinate's truncation by ``__fadd_rz(s, 2^23)``,
``TRUNC_TRICK``; both; and F2I in place of the store's trick,
``NO_STORE_TRICK``), the kernel's first design (adjacent columns, unguarded,
all three tricks), the gathers as the aligned 4-byte words holding x0 and x0
+ 1, funnel-shifted (``WORD_GATHERS``), each block's source footprint staged
in shared memory when it fits (``STAGED_FOOTPRINT``), and three ablations (the
stores alone; the coordinates and the lerp without gathers; the coordinates
and gathers without the lerp); on ``scan``'s call (8 frames of document.pgm
to 1000x800 pages with the corners ``scan`` finds), one of its frames, the
steep and extreme quads of ``chip_smoke.WARP_QUADS`` on the 8 frames, the
(347, 200) page, and 2 frames to a 4000x3000 page.  Device time too.

``--source template``: K19's two designs (every template on the INT32
design, ``int32_all``, or from width 1 on the tensor cores, ``mma_from1``:
the crossover) and the tensor-core design's tiles (``kMmaR``, ``kMmaQ``,
warps a block), staging (``kMmaStageBytes``, ``kStageRows``) and row unroll,
with two ablations (no win(I^2), no products; timed, not checked), at the
templates of ``TEMPLATE_SHAPES``: 1x1, 8x8, 32x32 (``bench_all.py``'s),
64x48 and 16x100 on 64 frames of lena tiled to 480x640, and 24,577x1,
257x257 and 9x7,339 on fewer frames.

``--source contour``: K20 with every frame walked on its bytes
(``kMaxBitmapBytes`` 0) against the shared-memory bitmaps, and with 16 warps
a block (windows of 16 walks), at ``find_contours``' and
``largest_blob_contour``'s calls on the 12-blob frame and a spiral trace that
runs to the step bound, each on a fresh mask; and a
probe of the card's dependent-load latency from shared memory and through L1
(one thread chasing a chain of indices), the latency behind K20's bound
(``chip_smoke.SHARED_LOAD_LATENCY_CYCLES``).

``--source freestanding``: K21's orientation entry (``gs_fs_orient``) with
blocks of 64, 128 and 256 threads (``kOrientThreads``) and 1, 2 or 4
neighbouring elements a thread (``ORIENT_ITEMS`` in place of the committed
kernel's one), with vector loads and stores where aligned or scalar ones
always (``_scalar``), at
``orb_extract``'s call (the 16 x 500 keypoints' int32 moments on lena, as
``chip_smoke.orb_call_moments``) and on 1 M seeded moment pairs
(``chip_smoke.fs_moment_pairs``); each beside the three-launch composition
it replaced (the casts, ``gs_fs_atan2``, ``gs_fs_sin`` twice:
``composition_*``), every variant held bit for bit to ``fs_orient_plain``.
A ``--parent`` tree without ``gs_fs_orient`` runs that composition with its
own kernels in its place.  Device time too, and an empty kernel's (the
launch floor, ``chip_smoke.LAUNCH_FLOOR_SOURCE``) on each grid of the call
(its ``launch_floor`` line).

Each phase prints one JSON line; the last line is ``{"ok": true, ...}``.
"""

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from chip_smoke import (CONTOUR_BLOBS, CONTOUR_CAP, DENSE_C, DENSE_N, DENSE_R, FACES_H, FACES_N,
                        FACES_W, FILTER_TAPS, FS_COS_OFFSET, MAIN_H, MAIN_N, MAIN_R, MAIN_W,
                        ORB_CAP, ORB_H, ORB_N, ORB_THR, ORB_W, SCAN_CAP, SCAN_N, SCAN_PAGE,
                        WARP_QUADS,
                        WithEntries, _aruco, alternate_windows, brief_args, card_line, device_events,
                        device_ms,
                        fs_composition, fs_moment_pairs, launch_floor, older_entries,
                        document_batch, lena_batch, match_batch, orb_call_moments,
                        receipt_batch, spiral, track_levels, twelve_blobs)
import grayskull_tpu_torch as gt
from grayskull_tpu_torch import kernels as K
from grayskull_tpu_torch.kernels import _build
from grayskull_tpu_torch.profiling import timeit


def edit(text, *pairs):
    """``text`` with each ``old`` replaced by ``new``; each ``old`` must occur once."""
    for old, new in zip(pairs[::2], pairs[1::2]):
        if text.count(old) != 1:
            raise AssertionError(f"{old[:80]!r} is not in the source once")
        text = text.replace(old, new)
    return text


def replace_span(text, start, end, new):
    """``text`` with the part from ``start`` up to (not including) ``end`` replaced by ``new``."""
    i = text.index(start)
    return text[:i] + new + text[text.index(end, i):]


def const(name, value):
    """The edit that sets the constant ``name`` (``constexpr <type> name = ...;``) to ``value``."""
    def make(text):
        out, n = re.subn(rf"(constexpr \w+ {name} = )[^;]+;", rf"\g<1>{value};", text)
        if n != 1:
            raise AssertionError(f"{name} is not defined once")
        return out
    return make


def chain(*edits):
    def make(text):
        for e in edits:
            text = e(text)
        return text
    return make


PREPROC_VARIANTS = {
    "committed": lambda s: s,
    "strip32": const("kSobelStrip", 32),
    "strip128": const("kSobelStrip", 128),
    "item16": const("kAdaptiveItem", 16),
    "item64": const("kAdaptiveItem", 64),
}
PREPROC_ABLATIONS = {
    "no_vertical_pass": lambda s: edit(
        s, "    box_columns(StagedBytes{band, pitch, ry0, a0}, colsum, swp, sw, cx0, y0, rows, h, r, ry0,\n"
           "                ry1 - 1);\n", ""),
    "no_row_pass": lambda s: edit(
        s, "for (int item = threadIdx.x; item < total; item += blockDim.x) {",
        "for (int item = threadIdx.x + total; item < total; item += blockDim.x) {"),
}

# K13's packed taps as a rank-1 pass: taps[j][i] = u[j] * v[i] (the JAX kernel's
# _rank1_taps), column sums of u over the three rows, then row sums of v.
RANK1_FILTER_WORDS = r'''// K13's outputs at the lane's 16 columns: a rank-1 pass for factored taps.
template <bool kPacked>
__device__ __forceinline__ void filter_words(const Windows& a, const Windows& m, const Windows& b,
                                             const Taps& t, unsigned out[4]) {
  const Windows* rows[3] = {&a, &m, &b};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[k] = 0u;
    if (kPacked) {
      int c[6] = {0, 0, 0, 0, 0, 0};  // column sums at columns x - 1 .. x + 4 of the word
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const unsigned lo = rows[dy]->at(k, 0), hi = rows[dy]->at(k, 3);
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i] += t.u[dy] * static_cast<int>((lo >> (8 * i)) & 0xffu);
        c[4] += t.u[dy] * static_cast<int>((hi >> 8) & 0xffu);
        c[5] += t.u[dy] * static_cast<int>((hi >> 16) & 0xffu);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned sum = static_cast<unsigned>(t.v[0] * c[j] + t.v[1] * c[j + 1] + t.v[2] * c[j + 2]);
        const int q = static_cast<int>(div_exact(sum, t.norm, t.magic));
        out[k] |= static_cast<unsigned>(min(max(q, 0), 255)) << (8 * j);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned sum = 0u;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const unsigned win = rows[dy]->at(k, j);
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            sum += ((win >> (8 * dx)) & 0xffu) * static_cast<unsigned>(t.k[3 * dy + dx]);
          }
        }
        const int q = static_cast<int>(div_exact(sum, t.norm, t.magic));
        out[k] |= static_cast<unsigned>(min(max(q, 0), 255)) << (8 * j);
      }
    }
  }
}

'''
RANK1_FACTORS = r'''
// taps[j][i] = u[j] * v[i] with integer u, v, or false.
bool rank1(const int k[9], int u[3], int v[3]) {
  int p = 0;
  while (p < 3 && k[3 * p] == 0 && k[3 * p + 1] == 0 && k[3 * p + 2] == 0) ++p;
  if (p == 3) return false;
  int g = 0;
  for (int i = 0; i < 3; ++i) {
    int x = k[3 * p + i] < 0 ? -k[3 * p + i] : k[3 * p + i];
    while (x != 0) { const int r = g % x; g = x; x = r; }
  }
  int i0 = 0;
  for (int i = 0; i < 3; ++i) v[i] = k[3 * p + i] / g;
  while (v[i0] == 0) ++i0;
  for (int j = 0; j < 3; ++j) {
    if (k[3 * j + i0] % v[i0] != 0) return false;
    u[j] = k[3 * j + i0] / v[i0];
    for (int i = 0; i < 3; ++i) if (k[3 * j + i] != u[j] * v[i]) return false;
  }
  return true;
}

int ceil_div('''


def _stencil3_rank1(s):
    s = edit(s, "  unsigned norm, magic;\n", "  unsigned norm, magic;\n  int u[3], v[3];\n",
             "\nint ceil_div(", RANK1_FACTORS,
             "  const auto in = static_cast<const uint8_t*>(src);\n  const auto out = static_cast<uint8_t*>(dst);\n"
             "  switch (access_width(src, dst, w)) {\n    case kVectors: return launch_filter3",
             "  packed = packed && rank1(taps.k, taps.u, taps.v);\n"
             "  const auto in = static_cast<const uint8_t*>(src);\n  const auto out = static_cast<uint8_t*>(dst);\n"
             "  switch (access_width(src, dst, w)) {\n    case kVectors: return launch_filter3")
    return replace_span(s, "// K13's outputs at the lane's 16 columns", "// The warp's (frame, strip",
                        RANK1_FILTER_WORDS)


# The 4-byte path with lane l on words l + 32k of its segment, so that each
# load instruction of the warp reads 128 consecutive bytes; the 16-byte and
# byte paths keep the lane's consecutive columns.
STRIDED_NEIGHBOURS = r"""template <Access A>
__device__ __forceinline__ void neighbours(const unsigned v[4], unsigned left, unsigned right,
                                           int lane, unsigned prev[4], unsigned next[4]) {
  if (A == kWords) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      prev[k] = __shfl_sync(kFull, v[k], (lane + 31) & 31);
      next[k] = __shfl_sync(kFull, v[k], (lane + 1) & 31);
    }
    // lane 0's left neighbour of word k is lane 31's word k - 1, lane 31's right one lane 0's k + 1
    if (lane == 0) {
#pragma unroll
      for (int k = 3; k >= 1; --k) prev[k] = prev[k - 1];
      prev[0] = left << 24;
    }
    if (lane == 31) {
#pragma unroll
      for (int k = 0; k < 3; ++k) next[k] = next[k + 1];
      next[3] = right;
    }
  } else {
    const unsigned up = __shfl_up_sync(kFull, v[3], 1);
    const unsigned down = __shfl_down_sync(kFull, v[0], 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      prev[k] = k == 0 ? (lane == 0 ? left << 24 : up) : v[k - 1];
      next[k] = k == 3 ? (lane == 31 ? right : down) : v[k + 1];
    }
  }
}

"""


def replace_n(text, old, new, n):
    """``text`` with the ``n`` occurrences of ``old`` replaced by ``new``."""
    if text.count(old) != n:
        raise AssertionError(f"{old[:80]!r} is not in the source {n} times")
    return text.replace(old, new)


def _strided_words(s):
    s = replace_span(s, "__device__ __forceinline__ void neighbours(",
                     "template <Access A>\n__device__ __forceinline__ void store_row",
                     STRIDED_NEIGHBOURS)
    # the 4-byte path's loads and stores
    s = replace_n(s, "      const int x = word_col(seg, lane, k);",
                  "      const int x = seg + 128 * k + 4 * lane;", 2)
    s = edit(s, "template <bool kErode>\n__device__ __forceinline__ void morph_words(",
             "template <Access A, bool kErode>\n__device__ __forceinline__ void morph_words(",
             "morph_words<kErode>(", "morph_words<A, kErode>(",
             "__device__ __forceinline__ Windows windows(",
             "template <Access A>\n__device__ __forceinline__ Windows windows(")
    s = replace_n(s, "  neighbours(", "  neighbours<A>(", 2)
    return replace_n(s, "= windows(", "= windows<A>(", 4)


STENCIL3_VARIANTS = {
    "committed": lambda s: s,
    "words_strided": _strided_words,
    "bytes_for_words": lambda s: edit(s, "(a & 3) == 0 ? kWords : kBytes", "kBytes"),
    **{f"strip{h}": const("kStrip", h) for h in (8, 16, 32, 64, 128)},
    "rank1": _stencil3_rank1,
}

# K18 as a ring of kRingStages shared-memory stages, each x and y chunks of
# kRingBytes filled by bulk copies that complete on the stage's mbarrier; the
# block adds in place and stores the stage with a bulk copy.  Aligned operands
# only; the byte path stays the committed kernel's.
BULK_RING = r'''
constexpr int kRingStages = 4;
constexpr int kRingBytes = 8192;  // bytes of each operand a stage holds

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ring_load(uint8_t* stage, unsigned long long* bar, const uint8_t* a,
                                          const uint8_t* b, size_t off, unsigned len) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(2 * len) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(stage)), "l"(a + off), "r"(len), "r"(smem_u32(bar)) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(stage + kRingBytes)), "l"(b + off), "r"(len), "r"(smem_u32(bar)) : "memory");
}

__global__ void __launch_bounds__(kThreads)
    triad_ring_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                      uint8_t* __restrict__ out, size_t n, size_t n_vec) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) unsigned long long full[kRingStages];
  const size_t bytes = n_vec * 16;
  const size_t chunks = (bytes + kRingBytes - 1) / kRingBytes;
  auto len_of = [&](size_t c) {
    return static_cast<unsigned>(bytes - c * kRingBytes < kRingBytes ? bytes - c * kRingBytes
                                                                     : kRingBytes);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&full[s])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kRingStages; ++s) {
      const size_t c = blockIdx.x + static_cast<size_t>(s) * gridDim.x;
      if (c < chunks) ring_load(ring + 2 * s * kRingBytes, &full[s], a, b, c * kRingBytes, len_of(c));
    }
  }
  __syncthreads();
  int i = 0;
  for (size_t c = blockIdx.x; c < chunks; c += gridDim.x, ++i) {
    const int s = i % kRingStages;
    const unsigned parity = (i / kRingStages) & 1;
    unsigned done = 0;
    for (unsigned spins = 0; !done; ++spins) {
      if (spins > (1u << 22)) asm volatile("trap;");  // a lost completion faults, not hangs
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
          : "=r"(done) : "r"(smem_u32(&full[s])), "r"(parity) : "memory");
    }
    uint8_t* stage = ring + 2 * s * kRingBytes;
    uint4* sx = reinterpret_cast<uint4*>(stage);
    const uint4* sy = reinterpret_cast<const uint4*>(stage + kRingBytes);
    const unsigned len = len_of(c);
    for (unsigned v = threadIdx.x; v < len / 16; v += kThreads) {
      const uint4 p = sx[v], q = sy[v];
      sx[v] = make_uint4(__vadd4(p.x, q.x), __vadd4(p.y, q.y), __vadd4(p.z, q.z), __vadd4(p.w, q.w));
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                       out + c * kRingBytes), "r"(smem_u32(stage)), "r"(len) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      const size_t next = c + static_cast<size_t>(kRingStages) * gridDim.x;
      if (next < chunks) {
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        ring_load(stage, &full[s], a, b, next * kRingBytes, len_of(next));
      }
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  const size_t k = n_vec * 16 + threadIdx.x;
  if (blockIdx.x == 0 && k < n) out[k] = static_cast<uint8_t>(a[k] + b[k]);
}

bool aligned16('''
BULK_RING_LAUNCH = r'''  const size_t n_vec = aligned16(a) && aligned16(b) && aligned16(out) ? n / 16 : 0;
  if (n_vec > 0) {
    const int smem = 2 * kRingStages * kRingBytes;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(triad_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const size_t chunks = (n_vec * 16 + kRingBytes - 1) / kRingBytes;
    const unsigned grid = static_cast<unsigned>(chunks < 2u * sms ? chunks : 2u * sms);
    triad_ring_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), static_cast<uint8_t*>(out),
        n, n_vec);
    return cudaGetLastError();
  }
'''


# K18 with several vectors a thread: kTriadVectors vectors of kTriadBytes of
# each operand, all loads issued before the first add or store, in blocks of
# kTriadThreads; {loads} and {store} are the accesses (__ldcs / __stcs stream).
CHUNKED_TRIAD = r"""constexpr int kTriadThreads = {threads};
constexpr int kTriadVectors = {vectors};
using TriadVec = {vec};

__device__ __forceinline__ uint4 add_vec(uint4 x, uint4 y) {{
  return make_uint4(__vadd4(x.x, y.x), __vadd4(x.y, y.y), __vadd4(x.z, y.z), __vadd4(x.w, y.w));
}}

__device__ __forceinline__ uint2 add_vec(uint2 x, uint2 y) {{
  return make_uint2(__vadd4(x.x, y.x), __vadd4(x.y, y.y));
}}

__device__ __forceinline__ unsigned add_vec(unsigned x, unsigned y) {{ return __vadd4(x, y); }}

__global__ void __launch_bounds__(kTriadThreads)
    triad_kernel(const uint8_t* {restrict}a, const uint8_t* {restrict}b,
                 uint8_t* {restrict}out, size_t n, size_t n_vec) {{
  const auto x = reinterpret_cast<const TriadVec*>(a);
  const auto y = reinterpret_cast<const TriadVec*>(b);
  const auto o = reinterpret_cast<TriadVec*>(out);
  const size_t items = n_vec * (16 / sizeof(TriadVec));
  const size_t i0 = static_cast<size_t>(blockIdx.x) * kTriadThreads * kTriadVectors + threadIdx.x;
  TriadVec xv[kTriadVectors], yv[kTriadVectors];
{loads}
#pragma unroll
  for (int j = 0; j < kTriadVectors; ++j) {{
    const size_t i = i0 + static_cast<size_t>(j) * kTriadThreads;
    if (i < items) {store};
  }}
  const size_t k = n_vec * 16 + static_cast<size_t>(blockIdx.x) * kTriadThreads + threadIdx.x;
  if (k < n) out[k] = static_cast<uint8_t>(a[k] + b[k]);
}}

// Blocks for kTriadThreads * kTriadVectors items a block, or a thread per tail byte.
bool triad_blocks(size_t n, size_t n_vec, unsigned* blocks) {{
  const size_t per_block = kTriadThreads * kTriadVectors * sizeof(TriadVec) / 16;
  const size_t want = std::max((n_vec + per_block - 1) / per_block,
                               (n - n_vec * 16 + kTriadThreads - 1) / kTriadThreads);
  if (want > 0x7fffffffULL) return false;
  *blocks = static_cast<unsigned>(want);
  return true;
}}

"""
LOADS_TOGETHER = """#pragma unroll
  for (int j = 0; j < kTriadVectors; ++j) {{
    const size_t i = i0 + static_cast<size_t>(j) * kTriadThreads;
    if (i < items) {{
      xv[j] = {load}(x + i);
      yv[j] = {load}(y + i);
    }}
  }}"""
LOADS_X_THEN_Y = """#pragma unroll
  for (int j = 0; j < kTriadVectors; ++j) {{
    const size_t i = i0 + static_cast<size_t>(j) * kTriadThreads;
    if (i < items) xv[j] = {load}(x + i);
  }}
#pragma unroll
  for (int j = 0; j < kTriadVectors; ++j) {{
    const size_t i = i0 + static_cast<size_t>(j) * kTriadThreads;
    if (i < items) yv[j] = {load}(y + i);
  }}"""


def chunked_triad(threads=256, vectors=1, vec_bytes=16, stream_loads=True, stream_stores=True,
                  x_then_y=False, restrict=True):
    """The edit that swaps K18's kernel and launch for CHUNKED_TRIAD with these
    settings; ``x_then_y`` issues every x load before the first y load, as
    PyTorch's vectorized elementwise policy orders them."""
    load = "__ldcs" if stream_loads else "*"
    loads = (LOADS_X_THEN_Y if x_then_y else LOADS_TOGETHER).format(load=load)
    body = CHUNKED_TRIAD.format(
        threads=threads, vectors=vectors, loads=loads,
        vec={16: "uint4", 8: "uint2", 4: "unsigned"}[vec_bytes],
        restrict="__restrict__ " if restrict else "",
        store=("__stcs(o + i, add_vec(xv[j], yv[j]))" if stream_stores
               else "o[i] = add_vec(xv[j], yv[j])"))

    def make(s):
        s = replace_span(s, "__global__ void triad_kernel(", "bool aligned16(", body)
        return edit(s, "if (!blocks_for(n, n_vec, &blocks)) return cudaErrorInvalidConfiguration;\n"
                       "  triad_kernel<<<blocks, kThreads,",
                    "if (!triad_blocks(n, n_vec, &blocks)) return cudaErrorInvalidConfiguration;\n"
                    "  triad_kernel<<<blocks, kTriadThreads,")
    return make


# K17's aligned path with @VECTORS@ vectors a thread in blocks of @THREADS@,
# every load issued before the first store, indices of type @INDEX@;
# load_vec / store_vec carry the access hints.  Each K17 text below replaces the committed kernel (from "//
# K17's aligned path." up to "// K17's byte path") and its launch in gs_copy.
COPY_VECTORS = r"""// K17's aligned path.
constexpr int kCopyThreads = @THREADS@;
constexpr int kCopyVectors = @VECTORS@;

__device__ __forceinline__ uint4 load_vec(const uint4* p) {
@LOAD@
}

__device__ __forceinline__ void store_vec(uint4* p, uint4 v) {
@STORE@
}

__global__ void __launch_bounds__(kCopyThreads)
    copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, size_t n,
                size_t n_vec) {
  const auto s = reinterpret_cast<const uint4*>(src);
  const auto d = reinterpret_cast<uint4*>(dst);
  using Index = @INDEX@;
  const Index i0 = static_cast<Index>(blockIdx.x) * (kCopyThreads * kCopyVectors) + threadIdx.x;
  uint4 v[kCopyVectors];
#pragma unroll
  for (int j = 0; j < kCopyVectors; ++j) {
    const Index i = i0 + static_cast<Index>(j) * kCopyThreads;
    if (i < n_vec) v[j] = load_vec(s + i);
  }
#pragma unroll
  for (int j = 0; j < kCopyVectors; ++j) {
    const Index i = i0 + static_cast<Index>(j) * kCopyThreads;
    if (i < n_vec) store_vec(d + i, v[j]);
  }
  if (blockIdx.x == gridDim.x - 1) {
    const size_t k = n_vec * 16 + threadIdx.x;
    if (k < n) dst[k] = src[k];
  }
}

bool copy_blocks(size_t n_vec, unsigned* blocks) {
  const size_t per_block = static_cast<size_t>(kCopyThreads) * kCopyVectors;
  const size_t want = std::max<size_t>((n_vec + per_block - 1) / per_block, 1);
  if (want > 0x7fffffffULL) return false;
  *blocks = static_cast<unsigned>(want);
  return true;
}

"""
COPY_LOADS = {
    "plain": "  return *p;",
    "cs": "  return __ldcs(p);",
    # the read-only path, no L1 line allocated; the second also asks L2 to fetch 256 bytes
    **{name: "  uint4 v;\n#if defined(__CUDA_ARCH__)\n  asm volatile(\"ld.global.nc.L1::no_allocate"
                 + hint + ".v4.u32 {%0, %1, %2, %3}, [%4];\"\n"
                 "               : \"=r\"(v.x), \"=r\"(v.y), \"=r\"(v.z), \"=r\"(v.w) : \"l\"(p));\n"
                 "#else\n  v = *p;\n#endif\n  return v;"
       for name, hint in (("no_allocate", ""), ("no_allocate_l2_256", ".L2::256B"))},
}
COPY_STORES = {"plain": "  *p = v;", "cs": "  __stcs(p, v);"}

# K17's aligned path as a persistent grid of @BLOCKS@ blocks an SM, each
# moving one contiguous span of vectors, @VECTORS@ a thread a step.
COPY_PERSISTENT = r"""// K17's aligned path.
constexpr int kCopyThreads = @THREADS@;
constexpr int kCopyVectors = @VECTORS@;
constexpr int kCopyBlocksPerSm = @BLOCKS@;

__global__ void __launch_bounds__(kCopyThreads)
    copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, size_t n,
                size_t n_vec) {
  const auto s = reinterpret_cast<const uint4*>(src);
  const auto d = reinterpret_cast<uint4*>(dst);
  constexpr size_t step = static_cast<size_t>(kCopyThreads) * kCopyVectors;
  const size_t span = ((n_vec + gridDim.x - 1) / gridDim.x + step - 1) / step * step;
  const size_t lo = static_cast<size_t>(blockIdx.x) * span;
  const size_t hi = lo + span < n_vec ? lo + span : n_vec;
  for (size_t base = lo + threadIdx.x; base < hi; base += step) {
    uint4 v[kCopyVectors];
#pragma unroll
    for (int j = 0; j < kCopyVectors; ++j) {
      const size_t i = base + static_cast<size_t>(j) * kCopyThreads;
      if (i < hi) v[j] = s[i];
    }
#pragma unroll
    for (int j = 0; j < kCopyVectors; ++j) {
      const size_t i = base + static_cast<size_t>(j) * kCopyThreads;
      if (i < hi) d[i] = v[j];
    }
  }
  if (blockIdx.x == gridDim.x - 1) {
    const size_t k = n_vec * 16 + threadIdx.x;
    if (k < n) dst[k] = src[k];
  }
}

bool copy_blocks(size_t n_vec, unsigned* blocks) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t per_block = static_cast<size_t>(kCopyThreads) * kCopyVectors;
  const size_t want = std::max<size_t>((n_vec + per_block - 1) / per_block, 1);
  *blocks = static_cast<unsigned>(std::min<size_t>(want, static_cast<size_t>(kCopyBlocksPerSm) * sms));
  return true;
}

"""

# K17's aligned path as a ring of @STAGES@ shared-memory stages of @KIB@ KiB
# in @BLOCKS@ one-warp blocks an SM: one thread fills a stage with a bulk copy
# (cp.async.bulk, completion on the stage's mbarrier) and drains it with
# another (bulk-group commit); the data never enters registers.  Block b takes
# chunks b, b + grid, ...; a stage is refilled one chunk later, once its store
# has read it.
COPY_RING = r"""// K17's aligned path.
constexpr int kCopyThreads = 32;
constexpr int kRingStages = @STAGES@;
constexpr unsigned kRingBytes = @KIB@u * 1024u;
constexpr int kRingBlocksPerSm = @BLOCKS@;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ring_load(uint8_t* stage, unsigned long long* bar,
                                          const uint8_t* from, unsigned len) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(len) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(stage)), "l"(from), "r"(len), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void ring_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned spins = 0; !done; ++spins) {
    if (spins > (1u << 26)) asm volatile("trap;");  // a lost completion faults, not hangs
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

__global__ void __launch_bounds__(kCopyThreads)
    copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, size_t n,
                size_t n_vec) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) unsigned long long full[kRingStages];
  const size_t bytes = n_vec * 16;
  const size_t chunks = (bytes + kRingBytes - 1) / kRingBytes;
  if (threadIdx.x == 0) {
    auto len_of = [&](size_t c) {
      const size_t left = bytes - c * kRingBytes;
      return static_cast<unsigned>(left < kRingBytes ? left : kRingBytes);
    };
    for (int s = 0; s < kRingStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&full[s])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kRingStages; ++s) {
      const size_t c = blockIdx.x + static_cast<size_t>(s) * gridDim.x;
      if (c < chunks) ring_load(ring + s * kRingBytes, &full[s], src + c * kRingBytes, len_of(c));
    }
    int i = 0;
    for (size_t c = blockIdx.x; c < chunks; c += gridDim.x, ++i) {
      const int s = i % kRingStages;
      ring_wait(&full[s], (i / kRingStages) & 1);
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                       dst + c * kRingBytes), "r"(smem_u32(ring + s * kRingBytes)), "r"(len_of(c))
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      const size_t next = c + static_cast<size_t>(kRingStages - 1) * gridDim.x;
      if (i > 0 && next < chunks) {  // the previous chunk's stage, once its store has read it
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        const int p = (i - 1) % kRingStages;
        ring_load(ring + p * kRingBytes, &full[p], src + next * kRingBytes, len_of(next));
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
  if (blockIdx.x == gridDim.x - 1) {
    const size_t k = bytes + threadIdx.x;
    if (k < n) dst[k] = src[k];
  }
}

bool copy_blocks(size_t n_vec, unsigned* blocks) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kRingStages * kRingBytes);
  const size_t chunks = (n_vec * 16 + kRingBytes - 1) / kRingBytes;
  const size_t cap = static_cast<size_t>(kRingBlocksPerSm) * sms;
  *blocks = static_cast<unsigned>(std::max<size_t>(std::min(chunks, cap), 1));
  return true;
}

"""
RING_LAUNCH = "copy_kernel<<<blocks, kCopyThreads, kRingStages * kRingBytes, st>>>("


def fill(template, **values):
    for key, value in values.items():
        template = template.replace(f"@{key.upper()}@", str(value))
    return template


def k17(kernel_text, launch=None):
    """The edit that swaps K17's aligned-path kernel (and, given, its launch) for these."""
    def make(s):
        s = replace_span(s, "// K17's aligned path.", "// K17's byte path", kernel_text)
        if launch:
            s = edit(s, "copy_kernel<<<blocks, kCopyThreads, 0, st>>>(", launch)
        return s
    return make


def copy_vectors(threads=256, vectors=4, load="plain", store="plain", index="size_t"):
    """K17 as COPY_VECTORS; ``index="unsigned"`` holds only below 2^32 vectors."""
    return k17(fill(COPY_VECTORS, threads=threads, vectors=vectors, load=COPY_LOADS[load],
                    store=COPY_STORES[store], index=index))


BANDWIDTH_VARIANTS = {
    "committed": lambda s: s,
    **{f"vectors{v}": chunked_triad(vectors=v) for v in (1, 2, 4, 8)},
    **{f"threads128_vectors{v}": chunked_triad(threads=128, vectors=v) for v in (1, 2, 4)},
    "threads128_bytes8": chunked_triad(threads=128, vec_bytes=8),
    **{f"bytes4_threads128_vectors{v}": chunked_triad(threads=128, vectors=v, vec_bytes=4)
       for v in (4, 8)},
    "x_then_y_vectors4": chunked_triad(vectors=4, x_then_y=True),
    "x_then_y_bytes4_threads128_vectors4": chunked_triad(threads=128, vectors=4, vec_bytes=4,
                                                         x_then_y=True),
    "vectors4_plain": chunked_triad(vectors=4, stream_loads=False, stream_stores=False),
    "vectors4_streaming_loads_only": chunked_triad(vectors=4, stream_stores=False),
    "vectors4_streaming_stores_only": chunked_triad(vectors=4, stream_loads=False),
    # torch.add's own shape for uint8 on this card: 128 threads of two 8-byte vectors
    "torch_twin": chunked_triad(threads=128, vectors=2, vec_bytes=8, stream_loads=False,
                                stream_stores=False),
    "torch_twin_no_restrict": chunked_triad(threads=128, vectors=2, vec_bytes=8,
                                            stream_loads=False, stream_stores=False,
                                            restrict=False),
    # plain ld.global where the restrict-qualified operands let the compiler use ld.global.nc
    "no_restrict": lambda s: edit(
        s, "triad_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,\n"
           "                             uint8_t* __restrict__ out,",
        "triad_kernel(const uint8_t* a, const uint8_t* b,\n"
        "                             uint8_t* out,"),
    "bulk_ring": lambda s: edit(
        s, "\nbool aligned16(", BULK_RING,
        "  const size_t n_vec = aligned16(a) && aligned16(b) && aligned16(out) ? n / 16 : 0;\n",
        BULK_RING_LAUNCH),
    # K17: vectors a thread and block size; access hints; persistent spans; bulk-copy rings
    # (copy_vectors1_threads256 is the committed K17's twin: a check on the spread)
    **{f"copy_vectors{v}_threads{t}": copy_vectors(threads=t, vectors=v)
       for t in (128, 256, 512, 1024) for v in (1, 2, 4, 8)},
    **{f"copy_vectors{v}_threads256_u32": copy_vectors(vectors=v, index="unsigned") for v in (1, 2)},
    **{f"copy_vectors4_{load}_{store}": copy_vectors(load=load, store=store)
       for load, store in (("cs", "cs"), ("cs", "plain"), ("plain", "cs"), ("no_allocate", "plain"),
                           ("no_allocate_l2_256", "plain"), ("no_allocate_l2_256", "cs"))},
    **{f"copy_persistent{b}_vectors{v}": k17(fill(COPY_PERSISTENT, threads=256, vectors=v, blocks=b))
       for b in (1, 2) for v in (4, 8)},
    **{f"copy_ring{st}x{kib}k_blocks{b}": k17(fill(COPY_RING, stages=st, kib=kib, blocks=b),
                                              RING_LAUNCH)
       for st, kib, b in ((2, 16, 4), (4, 16, 2), (4, 16, 3), (2, 32, 2), (4, 32, 1), (2, 64, 1),
                          (3, 64, 1))},
}


# K14 with lane l on output columns x0 + l + 32 j (byte stores) in place of
# the lane's kCols consecutive columns (4-byte stores): each gather
# instruction of a warp then reads 32 neighbouring outputs' corners.
STRIDED_STORE = r"""// The outputs of the strided layout: columns x0 + lane + 32 j, a byte each.
template <int kCols>
__device__ __forceinline__ void store_strided(uint8_t* row, int x0, int lane, int dw,
                                              const unsigned (&v)[kCols]) {
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    if (x0 + lane + 32 * j < dw) row[x0 + lane + 32 * j] = static_cast<uint8_t>(v[j]);
  }
}

// Grid: (dw / kTile"""


def _resize_strided(s):
    s = edit(s, "source_coord(min(x + j, dw - 1), sw, dw)",
             "source_coord(min(x0 + lane + 32 * j, dw - 1), sw, dw)",
             "\n// Grid: (dw / kTile", "\n" + STRIDED_STORE)
    return replace_n(s, "store_outputs(out_row + f * out_plane, x, dw, words != 0, v);",
                     "store_strided(out_row + f * out_plane, x0, lane, dw, v);", 2)


RESIZE_VARIANTS = {
    "committed": lambda s: s,
    "strided": _resize_strided,
    "strided_cols1": chain(_resize_strided, const("kColsDown", 1)),
    **{f"down_cols{c}": const("kColsDown", c) for c in (8, 16)},
    **{f"up_cols{c}": const("kColsUp", c) for c in (4, 8)},
    **{f"frames{f}": const("kFrames", f) for f in (8, 16, 64)},
    **{f"min_blocks{b}": const("kMinBlocks", b) for b in (0, 512, 8192)},
    "l1_only": const("kStagePercent", 0),
    "staged_to_3.6x": const("kStagePercent", 360),
    "strided_l1_only": chain(_resize_strided, const("kStagePercent", 0)),
}

FAST_VARIANTS = {
    "committed": lambda s: s,
    **{f"strip{h}": const("kStrip", h) for h in (8, 12, 24, 32)},
    **{f"words{k}": const("kWords", k) for k in (1, 4)},
    **{f"threads{t}": const("kThreads", t) for t in (128, 256)},
    # the score's minimum and the NMS's maximum by the emulated byte SIMD
    # (__vminu4, __vmaxu4) in place of the u16 DPX instructions
    "byte_min_max": lambda s: edit(
        s, "        min_odd[k] = __vimin3_u16x2(min_odd[k], pend_odd[k], d_odd);",
        "        min_odd[k] = __vminu4(__vminu4(min_odd[k], pend_odd[k]), d_odd);",
        "const unsigned mind = __byte_perm(min_even[k], min_odd[k], 0x7351);",
        "const unsigned mind = min_odd[k];",
        "  const unsigned odd = __vimax3_u16x2(a, b, c);\n"
        "  const unsigned even = __vimax3_u16x2(a * 256u, b * 256u, c * 256u);\n"
        "  return __byte_perm(even, odd, 0x7351);",
        "  return __vmaxu4(__vmaxu4(a, b), c);"),
}

OTSU_VARIANTS = {
    "committed": lambda s: s,
    **{f"lanes{lanes}_frames{frames}": chain(const("kLanes", lanes), const("kFrames", frames))
       for lanes, counts in ((8, (4, 8, 16)), (16, (2, 4, 8, 16)), (32, (2, 4, 8)))
       for frames in counts},
}

# A chain of @ADDS@ dependent __fadd_rn on one thread between two clock64 reads:
# two lengths, so that the difference cancels the reads' own cost.
FADD_PROBE = r"""#include <cuda_runtime.h>

template <int kAdds>
__global__ void fadd_chain(const float* x, float* out, long long* cycles) {
  float a = x[0];
  const float b = x[1];
  const long long t0 = clock64();
#pragma unroll
  for (int i = 0; i < kAdds; ++i) a = __fadd_rn(a, b);
  const long long t1 = clock64();
  out[0] = a;
  cycles[0] = t1 - t0;
}

extern "C" int gs_fadd_chain(const void* x, void* out, void* cycles, int adds) {
  const auto xf = static_cast<const float*>(x);
  const auto of = static_cast<float*>(out);
  const auto c = static_cast<long long*>(cycles);
  if (adds == 512) fadd_chain<512><<<1, 1>>>(xf, of, c);
  else fadd_chain<1536><<<1, 1>>>(xf, of, c);
  return cudaGetLastError();
}
"""


def fadd_latency(dev):
    """Cycles of one dependent ``__fadd_rn`` on the card: (cycles of 1536 adds -
    cycles of 512) / 1024, the least of 5 runs of each."""
    d = _build.BUILD_DIR / "sweep" / "otsu" / "fadd_probe"
    d.mkdir(parents=True, exist_ok=True)
    (d / "fadd_probe.cu").write_text(FADD_PROBE)
    subprocess.run(_build.compile_command(d / "fadd_probe.cu", d / "fadd_probe.o"), check=True)
    subprocess.run(_build.link_command([d / "fadd_probe.o"], d / "libfadd_probe.so"), check=True)
    lib = ctypes.CDLL(str(d / "libfadd_probe.so"))
    lib.gs_fadd_chain.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int)
    x = torch.tensor([1.0, 2.0 ** -30], device=dev)
    out = torch.empty(1, device=dev)
    cycles = torch.empty(1, dtype=torch.int64, device=dev)
    least = {}
    for adds in (512, 1536) * 5:
        if lib.gs_fadd_chain(x.data_ptr(), out.data_ptr(), cycles.data_ptr(), adds) != 0:
            raise RuntimeError("the FADD probe did not launch")
        torch.cuda.synchronize()
        least[adds] = min(least.get(adds, 1 << 62), int(cycles.item()))
    return {"cycles_512": least[512], "cycles_1536": least[1536],
            "cycles_per_add": (least[1536] - least[512]) / 1024}


# One thread follows a chain of 4-byte indices, each load's address the
# previous load's value, between two clock64 reads; two lengths, so that the
# difference cancels the reads' own cost.
LOAD_PROBE = r"""#include <cuda_runtime.h>

// shared: the table in shared memory; else through L1
__global__ void chase(const unsigned* next, unsigned* out, long long* cycles, int hops,
                      int shared) {
  __shared__ unsigned table[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) table[i] = next[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned p = 0;
  for (int i = 0; i < 1024; ++i) p = __ldg(next + p);  // L1 warm
  const long long t0 = clock64();
  if (shared) {
    for (int i = 0; i < hops; ++i) p = table[p];
  } else {
    for (int i = 0; i < hops; ++i) p = __ldg(next + p);
  }
  const long long t1 = clock64();
  out[0] = p;
  cycles[0] = t1 - t0;
}

extern "C" int gs_chase(const void* next, void* out, void* cycles, int hops, int shared) {
  chase<<<1, 32>>>(static_cast<const unsigned*>(next), static_cast<unsigned*>(out),
                   static_cast<long long*>(cycles), hops, shared);
  return cudaGetLastError();
}
"""


def load_latency(dev):
    """Cycles of one dependent load on the card, from shared memory and through
    L1: (cycles of 3,072 hops - cycles of 1,024) / 2,048 along a chain of 1,024
    indices 33 apart, the least of 5 runs of each."""
    d = _build.BUILD_DIR / "sweep" / "contour" / "load_probe"
    d.mkdir(parents=True, exist_ok=True)
    (d / "load_probe.cu").write_text(LOAD_PROBE)
    subprocess.run(_build.compile_command(d / "load_probe.cu", d / "load_probe.o"), check=True)
    subprocess.run(_build.link_command([d / "load_probe.o"], d / "libload_probe.so"), check=True)
    lib = ctypes.CDLL(str(d / "libload_probe.so"))
    lib.gs_chase.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int)
    nxt = ((torch.arange(1024, dtype=torch.int64) + 33) % 1024).to(torch.int32).to(dev)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    cycles = torch.empty(1, dtype=torch.int64, device=dev)
    result = {}
    for shared, name in ((1, "shared"), (0, "l1")):
        least = {}
        for hops in (1024, 3072) * 5:
            if lib.gs_chase(nxt.data_ptr(), out.data_ptr(), cycles.data_ptr(), hops, shared) != 0:
                raise RuntimeError("the load probe did not launch")
            torch.cuda.synchronize()
            least[hops] = min(least.get(hops, 1 << 62), int(cycles.item()))
        result[f"{name}_cycles_per_load"] = (least[3072] - least[1024]) / 2048
    return result


def preproc_cases(dev):
    lena = torch.from_numpy(lena_batch(MAIN_N, MAIN_H, MAIN_W)).to(dev)
    blurred, hist = K.blur_hist(lena, MAIN_R)
    t = K.otsu(hist, MAIN_H * MAIN_W)
    h_loc = MAIN_H // 4
    shard = blurred[:, h_loc - 1:2 * h_loc + 1].contiguous()  # (256, 258, 1024), row0 = h_loc - 1
    receipt = torch.from_numpy(receipt_batch(MAIN_N)).to(dev)
    return {
        "blur_hist": (lena.shape, lambda: K.blur_hist(lena, MAIN_R),
                      lambda: K.blur_hist_plain(lena, MAIN_R)),
        "threshold_sobel": (blurred.shape, lambda: K.threshold_sobel(blurred, t, True),
                            lambda: K.threshold_sobel_plain(blurred, t, True)),
        "sobel": (lena.shape, lambda: K.threshold_sobel(lena),
                  lambda: K.threshold_sobel_plain(lena)),
        "threshold_sobel_window": (
            shard.shape, lambda: K.threshold_sobel_window(shard, t, h_loc - 1, h_total=MAIN_H),
            lambda: K.threshold_sobel_window_plain(shard, t, h_loc - 1, h_total=MAIN_H)),
        "adaptive": (receipt.shape, lambda: K.adaptive(receipt, 15, 5),
                     lambda: K.adaptive_plain(receipt, 15, 5)),
    }, {}


def stencil3_cases(dev):
    lena = torch.from_numpy(lena_batch(MAIN_N, MAIN_H, MAIN_W)).to(dev)
    binary = K.adaptive(torch.from_numpy(receipt_batch(DENSE_N)).to(dev), DENSE_R, DENSE_C)
    gauss, norm = FILTER_TAPS["blur_gaussian"]
    return {
        "filter3": (lena.shape, lambda: K.filter3(lena, gauss, norm),
                    lambda: K.filter3_plain(lena, gauss, norm)),
        "morph_dilate": (binary.shape, lambda: K.morph(binary, "dilate"),
                         lambda: K.morph_plain(binary, "dilate")),
        "morph_erode": (binary.shape, lambda: K.morph(binary, "erode"),
                        lambda: K.morph_plain(binary, "erode")),
    }, {}


def bandwidth_cases(dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    x, y = (torch.randint(0, 256, (512, 512, 1024), dtype=torch.uint8, device=dev, generator=gen)
            for _ in range(2))  # the probe's 256 MiB
    out = torch.empty_like(x)
    ragged = x.view(-1)[:2**26 + 12345 * 16 + 7]  # a part chunk and a tail past the last 16
    cases = {"copy": (x.shape, lambda: K.copy(x), lambda: K.copy_plain(x)),
             "copy_ragged": (ragged.shape, lambda: K.copy(ragged), lambda: K.copy_plain(ragged)),
             "triad": (x.shape, lambda: K.triad(x, y), lambda: K.triad_plain(x, y))}
    lib, stream = _build.library(), _build.stream_of(x)
    # the library calls, and the committed entries called into the library's
    # output without the wrapper: what the wrapper and a new output cost
    library = {
        "copy": {"copy_": lambda: out.copy_(x),
                 "entry_into_out": lambda: lib.gs_copy(x.data_ptr(), out.data_ptr(), x.numel(),
                                                       stream)},
        "triad": {"add_out": lambda: torch.add(x, y, out=out), "add": lambda: torch.add(x, y),
                  "entry_into_out": lambda: lib.gs_triad(x.data_ptr(), y.data_ptr(),
                                                         out.data_ptr(), x.numel(), stream)},
    }
    return cases, library


def resize_cases(dev):
    big = torch.from_numpy(lena_batch(MAIN_N, MAIN_H, MAIN_W)).to(dev)
    vga = torch.from_numpy(lena_batch(MAIN_N, 480, 640)).to(dev)
    receipt = torch.from_numpy(receipt_batch(MAIN_N)).to(dev)
    return {
        f"resize_{tuple(x.shape)}_to_{to}": (x.shape, lambda x=x, to=to: K.resize(x, to),
                                             lambda x=x, to=to: K.resize_plain(x, to))
        for x, to in ((big, (480, 640)), (vga, (768, 1024)), (receipt, (100, 40)))
    }, {}


def fast_cases(dev):
    lena = torch.from_numpy(lena_batch(ORB_N, ORB_H, ORB_W, roll=5)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    noise = torch.randint(0, 256, lena.shape, dtype=torch.uint8, device=dev, generator=gen)
    return {
        "fast_key": (lena.shape, lambda: K.fast(lena, ORB_THR), lambda: K.fast_plain(lena, ORB_THR)),
        "fast_key_score": (lena.shape, lambda: K.fast(lena, ORB_THR, True),
                           lambda: K.fast_plain(lena, ORB_THR, True)),
        "fast_key_random": (noise.shape, lambda: K.fast(noise, ORB_THR),
                            lambda: K.fast_plain(noise, ORB_THR)),
    }, {}


def otsu_hist_cases(dev):
    lena = torch.from_numpy(lena_batch(MAIN_N, MAIN_H, MAIN_W)).to(dev)
    _, lena_hist = K.blur_hist(lena, MAIN_R)
    doc = torch.from_numpy(document_batch(SCAN_N)).to(dev)
    _, doc_hist = K.blur_hist(doc, 1)  # scan's blur(1) and its histograms
    one = doc_hist[:1].contiguous()
    cases = {}
    for label, hist, total in ((f"lena_{MAIN_N}", lena_hist, MAIN_H * MAIN_W),
                               (f"document_{SCAN_N}", doc_hist, doc[0].numel()),
                               ("document_1", one, doc[0].numel())):
        cases[f"otsu_{label}"] = (hist.shape, lambda h=hist, t=total: K.otsu(h, t),
                                  lambda h=hist, t=total: K.otsu_plain(h, t))
    return cases, {}


# K7 with lanes along a row's columns, a byte each: a warp takes a keypoint,
# lane l columns l - r and l + 32 - r, and walks the disc's rows.
COLUMN_BYTES = r"""// Grid ceil(n * k / (kThreads / 32)), block kThreads.
template <int kThreads, int kMinBlocks, bool kWeightTable>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
orb_moments_kernel(const uint8_t* __restrict__ imgs, const int* __restrict__ xs,
                   const int* __restrict__ ys, int* __restrict__ m01, int* __restrict__ m10,
                   int n, int h, int w, int k, int r) {
  const int lane = threadIdx.x % 32;
  const int kp = blockIdx.x * (kThreads / 32) + static_cast<int>(threadIdx.x) / 32;
  if (kp >= n * k) return;
  const uint8_t* f = imgs + static_cast<size_t>(kp / k) * h * w;
  const int x = xs[kp], y = ys[kp];
  const bool inside = x >= r && x + r < w && y >= r && y + r < h;
  int s01 = 0, s10 = 0;
  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = lane - r; dx <= r; dx += 32) {
      if (dx * dx + dy * dy > r * r) continue;
      const int p = inside ? f[static_cast<size_t>(y + dy) * w + x + dx]
                           : pixel(f, x + dx, y + dy, h, w);
      s01 += dy * p;
      s10 += dx * p;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s01 += __shfl_xor_sync(0xffffffffu, s01, off);
    s10 += __shfl_xor_sync(0xffffffffu, s10, off);
  }
  if (lane == 0) {
    m01[kp] = s01;
    m10[kp] = s10;
  }
}

"""

# K7 with @KEYS@ keypoints a warp, 32 / @KEYS@ lanes each (8 lanes a row)
KEYS_A_WARP = r"""constexpr int kKeyLanes = 32 / @KEYS@;
constexpr int kKeyRowsPerStep = kKeyLanes / kRowLanes;
constexpr int kKeySteps = (kDiscRows + kKeyRowsPerStep - 1) / kKeyRowsPerStep;

// Grid ceil(n * k / (kThreads / kKeyLanes)), block kThreads.
template <int kThreads, int kMinBlocks, bool kWeightTable>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
orb_moments_kernel(const uint8_t* __restrict__ imgs, const int* __restrict__ xs,
                   const int* __restrict__ ys, int* __restrict__ m01, int* __restrict__ m10,
                   int n, int h, int w, int k, int r) {
  __shared__ uint2 low[kWeightTable ? kDiscRows : 1][kRowLanes];
  __shared__ uint2 high[kWeightTable ? kDiscRows : 1][kHighWords];
  const int lane = threadIdx.x % 32;
  const int kl = lane % kKeyLanes;  // the lane within its keypoint's lanes
  const int rq = kl / kRowLanes, c = kl % kRowLanes;
  const int kp = blockIdx.x * (kThreads / kKeyLanes) + static_cast<int>(threadIdx.x) / kKeyLanes;
  const bool valid = kp < n * k;
  const int x = valid ? xs[kp] : 0, y = valid ? ys[kp] : 0;
  const int rows = 2 * r + 1;
  const int words = (rows + 3) / 4;
  if (kWeightTable) {
    for (int e = threadIdx.x; e < rows * (kRowLanes + kHighWords); e += kThreads) {
      const int i = e / (kRowLanes + kHighWords), j = e % (kRowLanes + kHighWords);
      const uint2 wt = word_weights(r, r * r - (i - r) * (i - r), j);
      if (j < kRowLanes) {
        low[i][j] = wt;
      } else {
        high[i][j - kRowLanes] = wt;
      }
    }
    __syncthreads();
  }
  if (!valid) return;  // the whole keypoint's lanes leave together
  const uint8_t* f = imgs + static_cast<size_t>(kp / k) * h * w;
  int s01 = 0, s10 = 0;
  if (x >= r && x + r < w && y >= r && y + r < h) {
#pragma unroll
    for (int step = 0; step < kKeySteps; ++step) {
      const int i = rq + step * kKeyRowsPerStep;
      if (i < rows) {
        int sum;
        row_terms<true, kWeightTable>(f, x, y, h, w, r, i, c, words, low, high, sum, s10);
        s01 += (i - r) * sum;
      }
    }
  } else {
    for (int i = rq; i < rows; i += kKeyRowsPerStep) {
      int sum;
      row_terms<false, kWeightTable>(f, x, y, h, w, r, i, c, words, low, high, sum, s10);
      s01 += (i - r) * sum;
    }
  }
  const unsigned mask = (0xffffffffu >> (32 - kKeyLanes)) << (lane - kl);  // the keypoint's lanes
#pragma unroll
  for (int off = kKeyLanes / 2; off > 0; off >>= 1) {
    s01 += __shfl_xor_sync(mask, s01, off);
    s10 += __shfl_xor_sync(mask, s10, off);
  }
  if (kl == 0) {
    m01[kp] = s01;
    m10[kp] = s10;
  }
}

"""
K7_KERNEL_START = "// Grid ceil(n * k / (kThreads / 32)), block kThreads: a warp takes a keypoint,"
K7_KERNEL_END = "// K8's layout: a keypoint's eight words split over kSplit warps"
K7_LARGE = "orb_moments_kernel<kLargeThreads, 2048 / kLargeThreads, true>"
K7_SMALL = "orb_moments_kernel<kSmallThreads, 1, false>"


def keys_a_warp(keys):
    """K7 as KEYS_A_WARP: ``keys`` keypoints a warp, in blocks of as many threads."""
    def make(s):
        s = replace_span(s, K7_KERNEL_START, K7_KERNEL_END, fill(KEYS_A_WARP, keys=keys))
        return edit(s, "large_keys = kLargeThreads / 32, small_keys = kSmallThreads / 32;",
                    "large_keys = kLargeThreads / kKeyLanes, small_keys = kSmallThreads / kKeyLanes;")
    return make


PATCHES_VARIANTS = {
    "committed": lambda s: s,
    "small_blocks_only": lambda s: edit(s, "if (total >= sms * large_keys) {", "if (false) {"),
    "large_blocks_only": lambda s: edit(s, "if (total >= sms * large_keys) {", "if (true) {"),
    "large512": const("kLargeThreads", 512),
    "small128": const("kSmallThreads", 128),
    **{f"keys{k}": keys_a_warp(k) for k in (2, 4)},
    "small_table": lambda s: edit(s, K7_SMALL, K7_SMALL.replace("false", "true")),
    "large_lane_weights": lambda s: edit(s, K7_LARGE, K7_LARGE.replace("true", "false")),
    # the dp4a's plain C++ fallback, four multiply-adds a word, on the card
    "multiply_add": lambda s: replace_n(s, "#if defined(__CUDA_ARCH__)\n  int d;",
                                        "#if 0\n  int d;", 2),
    # every keypoint through the guarded path: a bounds test a byte
    "guarded_only": lambda s: edit(s, "if (x >= r && x + r < w && y >= r && y + r < h) {",
                                   "if (false) {"),
    "column_bytes": lambda s: replace_span(s, K7_KERNEL_START, K7_KERNEL_END, COLUMN_BYTES),
    "brief_split_always": const("kSplitBelow", 1 << 20),
    "brief_split_never": const("kSplitBelow", 0),
    "brief_split2": const("kSmallSplit", 2),
    **{f"brief_split_below{v}": const("kSplitBelow", v) for v in (8, 16, 64)},
    "brief_threads256": const("kBriefThreads", 256),
    **{f"brief_cap{v}": const("kBriefBlocksPerSm", v) for v in (4, 16, 64)},
    # each keypoint's 41 x 41 window staged in shared memory (16-byte chunks,
    # masked at the frame's sides), then sampled with no bounds test
    "brief_staged": lambda s: replace_span(replace_span(s, K8_START, "}  // namespace", STAGED),
                                           K8_ENTRY_START, "  return cudaGetLastError();\n}\n\n}",
                                           K8_ENTRY_START + STAGED_ENTRY),
}
# K8's parts alone (timed, not checked): the keypoints' loads and stores, and
# those with the rotation (the ballots compare offsets in place of samples)
PATCHES_ABLATIONS = {
    "brief_empty": lambda s: edit(
        s, "    int off1[kPairs], off2[kPairs];\n",
        "    if (lane < kPairs) desc[static_cast<size_t>(kp) * 8 + first + lane] = "
        "(x + y) & 0 & __float_as_uint(s + c);\n"
        "    continue;\n    int off1[kPairs], off2[kPairs];\n"),
    "brief_rotation_only": lambda s: edit(
        s, "__ballot_sync(0xffffffffu, centre[off1[j]] > centre[off2[j]]);",
        "__ballot_sync(0xffffffffu, off1[j] > off2[j]);"),
}

K8_START = K7_KERNEL_END
K8_ENTRY_START = ("                 const void* pattern, void* desc, int n, int h, int w, int k, "
                  "void* stream) {\n")
STAGED = r"""// K8's layout: a warp stages a keypoint's window as kChunks 16-byte chunks a
// row at a pitch of kWinPitch bytes, kStageSteps chunks a lane.
constexpr int kReach = 20;            // |dx|, |dy| of a rotated endpoint (PATCH_PAD)
constexpr int kWin = 2 * kReach + 1;  // the window's rows and columns
constexpr int kPatch = 48;            // the plain version's patch: offsets -20 .. 27
constexpr int kChunks = 4;            // 16-byte chunks that hold 41 bytes from any misalignment
constexpr int kWinPitch = 80;         // bytes between staged rows (a multiple of 16)
constexpr int kStageSteps = (kWin * kChunks + 31) / 32;
constexpr int kBriefWarps = 4;        // keypoints a block holds at once, a warp each
constexpr int kBriefBlocksPerSm = 8;  // the grid's cap: blocks a card's SM, then loop

// Chunk q of window row i (frame row y - kReach + i) of the keypoint at (x, y):
// the 16 bytes at 16q past the aligned 16 bytes that hold column x - kReach.
// A chunk is read only when it holds a column of x - kReach .. x + kReach
// inside the frame (so it lies in the frame's storage); kMasked: the columns
// outside the frame are masked to 0 (the keypoint is within kReach of a side).
template <bool kMasked>
__device__ __forceinline__ uint4 window_chunk(const uint8_t* __restrict__ f, int x, int y, int h,
                                              int w, int i, int q) {
  const int yy = y - kReach + i;
  const uintptr_t start = reinterpret_cast<uintptr_t>(f) + static_cast<size_t>(yy) * w +
                          static_cast<uintptr_t>(static_cast<intptr_t>(x - kReach));
  const int mis = static_cast<int>(start & 15u);
  const int c0 = x - kReach - mis + 16 * q;  // the frame column of the chunk's first byte
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  const int first = max(max(c0, x - kReach), 0), last = min(min(c0 + 15, x + kReach), w - 1);
  if (yy < 0 || yy >= h || first > last) return v;
  v = *reinterpret_cast<const uint4*>(start - mis + 16 * q);
  if (kMasked) {
    unsigned* word = &v.x;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int lo = min(max(-(c0 + 4 * k), 0), 4), hi = min(max(c0 + 4 * k + 4 - w, 0), 4);
      word[k] &= lo + hi >= 4 ? 0u : (0xffffffffu << (8 * lo)) & (0xffffffffu >> (8 * hi));
    }
  }
  return v;
}

// The sample at offset (dx, dy) of the keypoint's 48 x 48 patch: 0 outside
// the patch or the frame.
__device__ __forceinline__ int patch_pixel(const uint8_t* __restrict__ f, int x, int y, int h,
                                           int w, int dx, int dy) {
  const bool in_patch = static_cast<unsigned>(dx) + kReach < static_cast<unsigned>(kPatch) &&
                        static_cast<unsigned>(dy) + kReach < static_cast<unsigned>(kPatch);
  return in_patch ? pixel(f, x + dx, y + dy, h, w) : 0;
}

// The endpoint (px, py) rotated by (s, c), each product and sum rounded on its
// own and truncated toward zero.
__device__ __forceinline__ void rotate(float px, float py, float s, float c, int& dx, int& dy) {
  dx = __float2int_rz(__fsub_rn(__fmul_rn(px, c), __fmul_rn(py, s)));
  dy = __float2int_rz(__fadd_rn(__fmul_rn(px, s), __fmul_rn(py, c)));
}

// Stage the keypoint's window: chunk e = step * 32 + lane is row e / kChunks.
template <bool kMasked>
__device__ __forceinline__ void stage_window(uint8_t* win, const uint8_t* __restrict__ f, int x,
                                             int y, int h, int w, int lane) {
#pragma unroll
  for (int step = 0; step < kStageSteps; ++step) {
    const int e = step * 32 + lane;
    if (e < kWin * kChunks) {
      const int i = e / kChunks, q = e % kChunks;
      *reinterpret_cast<uint4*>(win + i * kWinPitch + 16 * q) =
          window_chunk<kMasked>(f, x, y, h, w, i, q);
    }
  }
}

// Grid min(ceil(n * k / kBriefWarps), kBriefBlocksPerSm * SMs), block
// 32 * kBriefWarps; each warp walks over keypoints kp = warp, warp + all warps, ...
__global__ void __launch_bounds__(32 * kBriefWarps)
orb_brief_kernel(const uint8_t* __restrict__ imgs, const int* __restrict__ xs,
                 const int* __restrict__ ys, const float* __restrict__ sins,
                 const float* __restrict__ coss, const float* __restrict__ pattern,
                 uint32_t* __restrict__ desc, int n, int h, int w, int k) {
  __shared__ __align__(16) uint8_t window[kBriefWarps][kWin * kWinPitch];
  const int lane = threadIdx.x % 32;
  uint8_t* win = window[threadIdx.x / 32];
  float px1[8], py1[8], px2[8], py2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float* p = pattern + 4 * (32 * j + lane);
    px1[j] = p[0];
    py1[j] = p[1];
    px2[j] = p[2];
    py2[j] = p[3];
  }
  const int total = n * k;
  const int stride = gridDim.x * kBriefWarps;
  for (int kp = blockIdx.x * kBriefWarps + static_cast<int>(threadIdx.x) / 32; kp < total;
       kp += stride) {
    const uint8_t* f = imgs + static_cast<size_t>(kp / k) * h * w;
    const int x = xs[kp], y = ys[kp];
    const float s = sins[kp], c = coss[kp];
    __syncwarp();  // the previous keypoint's samples are read
    if (x >= kReach && x + kReach < w) {
      stage_window<false>(win, f, x, y, h, w, lane);
    } else {
      stage_window<true>(win, f, x, y, h, w, lane);
    }
    // row i's misalignment is (m0 + i * w) & 15
    const unsigned m0 = static_cast<unsigned>(
        (reinterpret_cast<uintptr_t>(f) + static_cast<size_t>(static_cast<intptr_t>(y - kReach)) * w +
         static_cast<uintptr_t>(static_cast<intptr_t>(x - kReach))) & 15u);
    int off1[8], off2[8];
    bool outside = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int dx1, dy1, dx2, dy2;
      rotate(px1[j], py1[j], s, c, dx1, dy1);
      rotate(px2[j], py2[j], s, c, dx2, dy2);
      const unsigned i1 = static_cast<unsigned>(dy1) + kReach, i2 = static_cast<unsigned>(dy2) + kReach;
      const unsigned j1 = static_cast<unsigned>(dx1) + kReach, j2 = static_cast<unsigned>(dx2) + kReach;
      outside |= i1 >= static_cast<unsigned>(kWin) || i2 >= static_cast<unsigned>(kWin) ||
                 j1 >= static_cast<unsigned>(kWin) || j2 >= static_cast<unsigned>(kWin);
      off1[j] = static_cast<int>(i1 * kWinPitch + ((m0 + i1 * w) & 15u) + j1);
      off2[j] = static_cast<int>(i2 * kWinPitch + ((m0 + i2 * w) & 15u) + j2);
    }
    __syncwarp();  // the window is staged
    uint32_t mine = 0;
    if (!__any_sync(0xffffffffu, outside)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t word = __ballot_sync(0xffffffffu, win[off1[j]] > win[off2[j]]);
        if (lane == j) mine = word;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int dx1, dy1, dx2, dy2;
        rotate(px1[j], py1[j], s, c, dx1, dy1);
        rotate(px2[j], py2[j], s, c, dx2, dy2);
        const uint32_t word = __ballot_sync(0xffffffffu, patch_pixel(f, x, y, h, w, dx1, dy1) >
                                                             patch_pixel(f, x, y, h, w, dx2, dy2));
        if (lane == j) mine = word;
      }
    }
    if (lane < 8) desc[static_cast<size_t>(kp) * 8 + lane] = mine;
  }
}

"""
STAGED_ENTRY = r"""  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int blocks = (n * k + kBriefWarps - 1) / kBriefWarps;
  if (blocks > kBriefBlocksPerSm * sms) blocks = kBriefBlocksPerSm * sms;
  orb_brief_kernel<<<blocks, 32 * kBriefWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(imgs), static_cast<const int*>(x), static_cast<const int*>(y),
      static_cast<const float*>(sin), static_cast<const float*>(cos),
      static_cast<const float*>(pattern), static_cast<uint32_t*>(desc), n, h, w, k);
"""


INTEGRAL_VARIANTS = {
    "committed": lambda s: s,
    **{f"band{b}": const("kBand", b) for b in (8, 32, 64)},
    **{f"threads{t}": const("kMaxThreads", t) for t in (128, 512)},
    # the band scan at 4 blocks of kMaxThreads an SM at least (64 registers)
    "min_blocks4": lambda s: edit(s, "__launch_bounds__(kMaxThreads)\nband_scan_kernel",
                                  "__launch_bounds__(kMaxThreads, 4)\nband_scan_kernel"),
}
# K4's launches alone (timed, not checked): the band scan without the launches
# before it (its carries are whatever the output held), and those two without it
INTEGRAL_ABLATIONS = {
    "band_scan_only": lambda s: edit(s, "  if (nb > 1) {\n    band_totals_kernel",
                                     "  if (false) {\n    band_totals_kernel"),
    "totals_and_scan_only": lambda s: edit(
        s, "  band_scan_kernel<kVec><<<dim3(nb, n), threads, 0, st>>>(src, dst, h, w);\n  return",
        "  return"),
}

# K9's flatten of only the tiles with a foreground pair across their edge
FLAGGED_TILES = r"""// Whether a foreground pixel of this thread's 16 has a foreground neighbour in
// another tile.
__device__ bool crosses(const uint8_t* __restrict__ frame, unsigned m, const Tile& t, int r,
                        int q, int h, int w, bool vec) {
  const int y = t.ty + r, x = t.tx + q * kChunk;
  bool any = false;
  if (r == 0) any |= (m & load_mask(frame, y - 1, x, h, w, vec)) != 0u;
  if (r == kTileH - 1) any |= (m & load_mask(frame, y + 1, x, h, w, vec)) != 0u;
  if (q == 0 && (m & 1u) && x > 0) any |= frame[static_cast<size_t>(y) * w + x - 1] >= 128;
  if (q == kChunks - 1 && (m >> (kChunk - 1)) && x + kChunk < w) {
    any |= frame[static_cast<size_t>(y) * w + x + kChunk] >= 128;
  }
  return any;
}

"""
K9_FLATTEN = "// Grid (tiles, min(n, kMaxFrameBlocks)), block kTileThreads, as tile_kernel."
K9_PIECES = "    // The pixels of a run piece link to one tile root T;"


def _flagged(s):
    s = edit(s, K9_FLATTEN, FLAGGED_TILES + K9_FLATTEN)
    return edit(s, K9_PIECES, "    if (!__syncthreads_or(crosses(src + offset, m, t, r, q, h, w, vec_in))) "
                              "continue;\n" + K9_PIECES)


# K9's labels stored by each thread, 16 at a time, in place of through shared memory
def _direct_stores(s):
    return replace_span(
        s, "    __syncthreads();  // every find is done: the labels go through parent",
        "    __syncthreads();  // bits and parent are reused by the next frame",
        "    if (y < h && x < w) {\n"
        "      store_chunk(label + offset + static_cast<size_t>(y) * w + x, w - x, vec_out, out);\n"
        "    }\n")


CCL_VARIANTS = {
    "committed": lambda s: s,
    "flagged": _flagged,
    "direct_stores": _direct_stores,
    **{f"tile{th}x{tw}": chain(const("kTileH", th), const("kTileW", tw))
       for th, tw in ((16, 256), (64, 64), (16, 128), (32, 256), (8, 256))},
    "tile16x128_flagged": chain(const("kTileH", 16), _flagged),
    # phase 3's loop over a thread's 16 pixels not unrolled (its finds inlined once)
    "labels_loop_rolled": lambda s: edit(
        s, "#pragma unroll\n    for (int i = 0; i < kChunk; ++i) {\n      if ((m >> i) & 1u) {",
        "#pragma unroll 1\n    for (int i = 0; i < kChunk; ++i) {\n      if ((m >> i) & 1u) {"),
    "tile16x128_direct_stores": chain(const("kTileH", 16), _direct_stores),
}
# stages of tile_kernel and flatten_kernel skipped (wrong labels that still
# point at smaller or equal indices, timed only): where their time goes
CCL_ABLATIONS = {
    "load_store_only": lambda s: edit(
        s, "    const unsigned left = q > 0 ? bits[r][q - 1] >> (kChunk - 1) : 0u;  // pixel c0 - 1\n",
        "    for (int i = 0; i < kChunk; ++i) out[i] = (m >> i) & 1u ? y * w + x + i : -1;\n"
        "    if (y < h && x < w) {\n"
        "      store_chunk(label + offset + static_cast<size_t>(y) * w + x, w - x, vec_out, out);\n"
        "    }\n"
        "    continue;\n"
        "    const unsigned left = q > 0 ? bits[r][q - 1] >> (kChunk - 1) : 0u;  // pixel c0 - 1\n"),
    "flatten_masks_only": lambda s: edit(s, "    int* parent = label + offset;\n    for (unsigned pieces",
                                         "    continue;\n    int* parent = label + offset;\n"
                                         "    for (unsigned pieces"),
    "no_unions": lambda s: edit(s, "    if (r > 0) {  // unite with the runs above",
                                "    if (false) {  // unite with the runs above"),
    "no_jumps": lambda s: edit(s, "    } while (__syncthreads_or(jumped));",
                               "    } while (false && __syncthreads_or(jumped));"),
}


def patches_cases(dev):
    """K7 and K8 at the main path's shapes (16 x 500 keypoints of orb_extract on
    lena, clamped as orb_extract clamps them) and at track's six calls (aruco's
    template and scene, 3 levels each)."""
    batch = torch.from_numpy(lena_batch(ORB_N, ORB_H, ORB_W, roll=5)).to(dev)
    cases = {}
    aruco = _aruco()
    tmpl = torch.from_numpy(aruco[100:350, 150:450].copy()).to(dev)
    scene = torch.from_numpy(aruco).to(dev)
    calls = [(f"{ORB_N}x{ORB_CAP}", batch, gt.orb_extract(batch, ORB_CAP, ORB_THR))]
    calls += [(f"track_{label}", cur, table) for label, cur, table in track_levels(tmpl, scene)]
    for label, frames, table in calls:
        a = brief_args(frames, table)
        cases[f"orb_moments_{label}"] = (a[1].shape, lambda a=a: K.orb_moments(*a[:3]),
                                         lambda a=a: K.orb_moments_plain(*a[:3]))
        cases[f"orb_brief_{label}"] = (a[1].shape, lambda a=a: K.orb_brief(*a),
                                       lambda a=a: K.orb_brief_plain(*a))
    return cases, {}


def ccl_cases(dev):
    """K9 on scan's 8 document binaries, on one of them, and on 8 random frames
    of 1024x768 at density 0.55 (near percolation: unions matter there); and the
    whole 8-frame ``scan`` with each variant's K9 (its other kernels committed)."""
    frames = torch.from_numpy(document_batch(SCAN_N)).to(dev)
    binary = gt.preprocess_binarize(frames)
    one = binary[:1].contiguous()
    gen = torch.Generator(device=dev).manual_seed(13)
    noise = ((torch.rand(binary.shape, generator=gen, device=dev) < 0.55) * 255).to(torch.uint8)
    cases = {f"ccl_{label}": (x.shape, lambda x=x: K.ccl(x), lambda x=x: K.ccl_plain(x))
             for label, x in ((f"document_{SCAN_N}", binary), ("document_1", one),
                              (f"density_0.55_{SCAN_N}", noise))}
    cases[f"scan_document_{SCAN_N}"] = (
        frames.shape, lambda: gt.scan(frames, SCAN_PAGE, SCAN_CAP),
        lambda: gt.scan(frames, SCAN_PAGE, SCAN_CAP, force_reference=True))
    return cases, {}


def integral_cases(dev):
    """K4 on detect_faces' 32 frames of 640x480 (lena rolled 7*i columns), on one
    of them, on integral_sharded's shard of a (1, 4) mesh (32 x 120 x 640), on a
    4200x4200 frame of 255s (its sums wrap past 2^32) and on 32 frames of
    479x639 that start an odd number of bytes into their batch ([1:] of 33: the
    byte path); beside the faces batch, two ``torch.cumsum`` calls as a yardstick."""
    faces = torch.from_numpy(lena_batch(FACES_N, FACES_H, FACES_W, roll=7)).to(dev)
    odd = torch.from_numpy(lena_batch(FACES_N + 1, FACES_H - 1, FACES_W - 1, roll=7)).to(dev)[1:]
    frames = {f"faces_{FACES_N}x{FACES_H}x{FACES_W}": faces,
              f"one_{FACES_H}x{FACES_W}": faces[:1],
              f"shard_{FACES_N}x{FACES_H // 4}x{FACES_W}": faces[:, :FACES_H // 4].contiguous(),
              "wrap_1x4200x4200": torch.full((1, 4200, 4200), 255, dtype=torch.uint8, device=dev),
              f"unaligned_{FACES_N}x{FACES_H - 1}x{FACES_W - 1}": odd}
    cases = {f"integral_{label}": (x.shape, lambda x=x: K.integral(x),
                                   lambda x=x: K.integral_plain(x))
             for label, x in frames.items()}
    library = {f"integral_faces_{FACES_N}x{FACES_H}x{FACES_W}": {
        "cumsum_cumsum_int32":
            lambda: torch.cumsum(torch.cumsum(faces, -1, dtype=torch.int32), -2)}}
    return cases, library


WARP_PIXEL_CALL_START = "      const uint8_t b = warp_pixel<kWide>("
WARP_GATHERS_START = "  const uint32_t b00 = p[0];"
WARP_LERP_START = "  // lerp\n"
WARP_PIXEL_END = "}\n\n// A thread's columns"
WARP_WALK_START = "// A thread's columns x_first + 32 j"
WARP_KERNEL_START = "// grid (n * tiles_y, min(tiles_x, 65535)), block (gx, ry)"

# K10's gathers as the aligned words that hold x0 and x0 + 1 of rows y0 and y1,
# funnel-shifted; the next word is read only when x0 is its word's last byte
# and x0 + 1 is read (a word that holds a byte of the frame lies in the
# frame's aligned storage)
WORD_GATHERS = r"""  const uintptr_t a0 = reinterpret_cast<uintptr_t>(p);
  const uintptr_t a1 = a0 + sw;
  const uint32_t* w0 = reinterpret_cast<const uint32_t*>(a0 & ~uintptr_t{3});
  const uint32_t* w1 = reinterpret_cast<const uint32_t*>(a1 & ~uintptr_t{3});
  const uint32_t top = __funnelshift_r(w0[0], right && (a0 & 3) == 3 ? w0[1] : 0u,
                                       static_cast<unsigned>(a0 & 3) * 8);
  const uint32_t bot = below ? __funnelshift_r(w1[0], right && (a1 & 3) == 3 ? w1[1] : 0u,
                                               static_cast<unsigned>(a1 & 3) * 8)
                             : 0u;
  const uint32_t b00 = top & 255u, b01 = (top >> 8) & 255u;
  const uint32_t b10 = bot & 255u, b11 = (bot >> 8) & 255u;
"""

# K10 with a thread on kCols adjacent columns (in place of columns 32 apart),
# its bytes of a row stored as one 4-byte word where they lie in the row and
# the word is aligned, else a byte each
ADJACENT_STORE = r"""// the low bytes of b[0 .. 3] as one little-endian word
__device__ __forceinline__ uint32_t pack4(const uint32_t* b) {
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

__device__ __forceinline__ void store_cols(uint8_t* p, const uint32_t (&b)[kCols], int left) {
  static_assert(kCols == 4, "one 4-byte store");
  if (left >= kCols && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(p) = pack4(b);
    return;
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    if (j < left) p[j] = static_cast<uint8_t>(b[j]);
  }
}

"""


def _warp_adjacent(s):
    s = edit(s, "    const unsigned x_first = (tile_x * blockDim.x + threadIdx.x - lane) * kCols"
                " + lane;",
             "    const unsigned x_first = (tile_x * blockDim.x + threadIdx.x) * kCols;",
             "      const float u = __fdiv_rn(static_cast<float>(x_first + 32 * j), dwm1);",
             "      const float u = __fdiv_rn(static_cast<float>(x_first + j), dwm1);",
             "      const uint8_t b = warp_pixel<kWide>(",
             "      out[j] = warp_pixel<kWide>(",
             "      if (32 * j < left) row[32 * j] = b;\n    }\n",
             "    }\n    store_cols(row, out, left);\n",
             "    uint8_t* row = page + static_cast<size_t>(y) * dw + x_first;\n",
             "    uint8_t* row = page + static_cast<size_t>(y) * dw + x_first;\n"
             "    uint32_t out[kCols];\n")
    return edit(s, WARP_WALK_START, ADJACENT_STORE + WARP_WALK_START)


# K10's three float tricks in place of type conversions: a byte as 2^23 + b
# less 2^23 (exact), a clamped coordinate's truncation as __fadd_rz(s, 2^23)
# (exact for 0 <= s < 2^23, so a committed version would need F2I for wider
# frames), the stored sum's by F2I
BYTE_TRICK = lambda s: edit(  # noqa: E731
    s, "  return static_cast<float>(b);\n",
    "  return __fsub_rn(__uint_as_float(0x4B000000u | b), kTwo23);  // exact: b < 2^23\n")
TRUNC_TRICK = lambda s: edit(  # noqa: E731
    s, "  const int i = __float2int_rz(s);\n  whole = static_cast<float>(i);\n  return i;\n",
    "  const float t = __fadd_rz(s, kTwo23);  // 2^23 + trunc(s) for 0 <= s < 2^23\n"
    "  whole = __fsub_rn(t, kTwo23);\n"
    "  return static_cast<int>(__float_as_uint(t) - 0x4B000000u);\n")
NO_STORE_TRICK = lambda s: edit(  # noqa: E731
    s, "  return static_cast<uint8_t>(__float_as_uint(__fadd_rz(sum, kTwo23)));\n",
    "  return static_cast<uint8_t>(__float2uint_rz(sum));\n")


# K10 reading the right (lower) neighbour of the last column (row) unchecked in
# every frame but the last (and for one-row frames the one before): it lies in
# the next frame, and its weight is 0
def _warp_unguarded(s):
    walk = ("walk_rows<kWide{}>(s, page, row_terms, sh, sw, rows, dw, y_first, x_first, top_x,"
            " top_y,\n{}bot_x, bot_y);")
    s = edit(s, "template <bool kWide>\n__device__ __forceinline__ uint8_t warp_pixel(",
             "template <bool kWide, bool kGuard>\n__device__ __forceinline__ uint8_t warp_pixel(",
             "  const bool right = x0 < swm1, below = y0 < shm1;",
             "  const bool right = !kGuard || x0 < swm1, below = !kGuard || y0 < shm1;",
             "in the rows of its tile.\ntemplate <bool kWide>",
             "in the rows of its tile.\ntemplate <bool kWide, bool kGuard>",
             "warp_pixel<kWide>(s, sw,", "warp_pixel<kWide, kGuard>(s, sw,",
             "uint8_t* __restrict__ dst, int sh, int sw,",
             "uint8_t* __restrict__ dst, int n, int sh, int sw,",
             "    walk_rows<kWide>(s, page, row_terms, sh, sw, rows, dw, y_first, x_first, top_x, "
             "top_y,\n                     bot_x, bot_y);",
             "    if (f + (sh > 1 ? 1 : 2) >= n) {\n      " + walk.format(", true", " " * 29)
             + "\n    } else {\n      " + walk.format(", false", " " * 30) + "\n    }")
    return replace_n(s, "<<<grid, block, 0, st>>>(s, c, d, sh,",
                     "<<<grid, block, 0, st>>>(s, c, d, n, sh,", 2)

# K10 with each block's source footprint staged in shared memory: the box around
# the coordinates of the tile's four corners (the map is bilinear in u and v, so
# its extremes lie there), 2 pixels wider each side for rounding, clamped to the
# frame; a tile whose box holds more than kStageBytes takes the gathers
STAGED_FOOTPRINT = r"""constexpr int kStageBytes = 24576;

template <bool kWide>
__device__ __forceinline__ uint8_t staged_pixel(const uint8_t* stage, int bx0, int by0, int bw,
                                                int swm1, int shm1, float swm1f, float shm1f,
                                                float top_x, float top_y, float bot_x,
                                                float bot_y, float v, float omv) {
  const float sx = clamp_coord(edge(top_x, bot_x, v, omv), swm1f);
  const float sy = clamp_coord(edge(top_y, bot_y, v, omv), shm1f);
  float fx0, fy0;
  const int x0 = truncate(sx, fx0);
  const int y0 = truncate(sy, fy0);
  const float dx = __fsub_rn(sx, fx0);
  const float dy = __fsub_rn(sy, fy0);
  const float omdx = __fsub_rn(1.0f, dx);
  const float omdy = __fsub_rn(1.0f, dy);
  const int o = (y0 - by0) * bw + (x0 - bx0);
  const bool right = x0 < swm1, below = y0 < shm1;
  const uint32_t b00 = stage[o];
  const uint32_t b01 = right ? stage[o + 1] : 0u;
  const uint32_t b10 = below ? stage[o + bw] : 0u;
  const uint32_t b11 = right && below ? stage[o + bw + 1] : 0u;
  const float t1 = __fmul_rn(__fmul_rn(byte_to_float(b00), omdx), omdy);
  const float t2 = __fmul_rn(__fmul_rn(byte_to_float(b01), dx), omdy);
  const float t3 = __fmul_rn(__fmul_rn(byte_to_float(b10), omdx), dy);
  const float t4 = __fmul_rn(__fmul_rn(byte_to_float(b11), dx), dy);
  return store_byte(__fadd_rn(__fadd_rn(__fadd_rn(t1, t2), t3), t4));
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
quad_warp_kernel(const uint8_t* __restrict__ src, const int* __restrict__ corners,
                 uint8_t* __restrict__ dst, int sh, int sw, int dh, int dw, int y0, int rows,
                 int tiles_y, int tiles_x) {
  __shared__ float quad[8];
  __shared__ float2 row_terms[kThreads / 32 * kRows];
  __shared__ uint8_t stage[kStageBytes];
  const int f = blockIdx.x / tiles_y;
  const unsigned span = blockDim.y * kRows;
  const unsigned y_first = (blockIdx.x - f * tiles_y) * span;
  const unsigned tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < 8) quad[tid] = static_cast<float>(corners[static_cast<long long>(f) * 8 + tid]);
  const float dhm1 = static_cast<float>(dh - 1);
  for (unsigned i = tid; i < span; i += blockDim.x * blockDim.y) {
    const float v = __fdiv_rn(static_cast<float>(y0 + y_first + i), dhm1);
    row_terms[i] = make_float2(v, __fsub_rn(1.0f, v));
  }
  __syncthreads();
  const uint8_t* s = src + static_cast<long long>(f) * sh * sw;
  uint8_t* page = dst + static_cast<long long>(f) * rows * dw;
  const float dwm1 = static_cast<float>(dw - 1);
  const float swm1f = static_cast<float>(sw) - 1.0f, shm1f = static_cast<float>(sh) - 1.0f;
  const float tl_x = quad[0], tl_y = quad[1], tr_x = quad[2], tr_y = quad[3];
  const float br_x = quad[4], br_y = quad[5], bl_x = quad[6], bl_y = quad[7];
  const unsigned y_last = min(y_first + span, static_cast<unsigned>(rows)) - 1;
  const unsigned lane = threadIdx.x & 31u;
  for (unsigned tile_x = blockIdx.y; tile_x < static_cast<unsigned>(tiles_x);
       tile_x += gridDim.y) {
    const unsigned xt0 = tile_x * blockDim.x * kCols;
    const unsigned xt1 = min(xt0 + blockDim.x * kCols, static_cast<unsigned>(dw)) - 1;
    float lo_x = 3.0e38f, hi_x = 0.0f, lo_y = 3.0e38f, hi_y = 0.0f;
    for (int ci = 0; ci < 4; ++ci) {
      const float u = __fdiv_rn(static_cast<float>(ci & 1 ? xt1 : xt0), dwm1);
      const float v = __fdiv_rn(static_cast<float>(y0 + (ci & 2 ? y_last : y_first)), dhm1);
      const float omu = __fsub_rn(1.0f, u), omv = __fsub_rn(1.0f, v);
      const float cx = clamp_coord(edge(edge(tl_x, tr_x, u, omu), edge(bl_x, br_x, u, omu), v, omv),
                                   swm1f);
      const float cy = clamp_coord(edge(edge(tl_y, tr_y, u, omu), edge(bl_y, br_y, u, omu), v, omv),
                                   shm1f);
      lo_x = fminf(lo_x, cx);
      hi_x = fmaxf(hi_x, cx);
      lo_y = fminf(lo_y, cy);
      hi_y = fmaxf(hi_y, cy);
    }
    const int bx0 = max(0, static_cast<int>(lo_x) - 2), by0 = max(0, static_cast<int>(lo_y) - 2);
    const int bx1 = min(sw - 1, static_cast<int>(hi_x) + 2);
    const int by1 = min(sh - 1, static_cast<int>(hi_y) + 2);
    const int bw = bx1 - bx0 + 1, bh = by1 - by0 + 1;
    const bool staged = static_cast<long long>(bw) * bh <= kStageBytes;
    if (staged) {
      __syncthreads();  // the last tile's reads of the stage are done
      for (int r = threadIdx.y; r < bh; r += blockDim.y) {
        const uint8_t* row = s + static_cast<size_t>(by0 + r) * sw + bx0;
        for (int c = threadIdx.x; c < bw; c += blockDim.x) stage[r * bw + c] = row[c];
      }
      __syncthreads();
    }
    const unsigned x_first = (tile_x * blockDim.x + threadIdx.x - lane) * kCols + lane;
    if (x_first >= static_cast<unsigned>(dw)) continue;
    float top_x[kCols], top_y[kCols], bot_x[kCols], bot_y[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float u = __fdiv_rn(static_cast<float>(x_first + 32 * j), dwm1);
      const float omu = __fsub_rn(1.0f, u);
      top_x[j] = edge(tl_x, tr_x, u, omu);
      top_y[j] = edge(tl_y, tr_y, u, omu);
      bot_x[j] = edge(bl_x, br_x, u, omu);
      bot_y[j] = edge(bl_y, br_y, u, omu);
    }
    if (!staged) {
      walk_rows<kWide>(s, page, row_terms, sh, sw, rows, dw, y_first, x_first, top_x, top_y,
                       bot_x, bot_y);
      continue;
    }
    const int left = dw - static_cast<int>(x_first);
    for (int k = 0; k < kRows; ++k) {
      const unsigned r = threadIdx.y + k * blockDim.y;
      const unsigned y = y_first + r;
      if (y >= static_cast<unsigned>(rows)) break;
      const float2 t = row_terms[r];
      uint8_t* row = page + static_cast<size_t>(y) * dw + x_first;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const uint8_t b = staged_pixel<kWide>(stage, bx0, by0, bw, sw - 1, sh - 1, swm1f, shm1f,
                                              top_x[j], top_y[j], bot_x[j], bot_y[j], t.x, t.y);
        if (32 * j < left) row[32 * j] = b;
      }
    }
  }
}

"""

WARP_VARIANTS = {
    "committed": lambda s: s,
    **{f"rows{r}": const("kRows", r) for r in (4, 16)},
    **{f"cols{c}": const("kCols", c) for c in (1, 2, 8)},
    "cols2_rows4": chain(const("kCols", 2), const("kRows", 4)),
    "unguarded": _warp_unguarded,
    "adjacent": _warp_adjacent,
    "byte_trick": BYTE_TRICK,
    "trunc_trick": TRUNC_TRICK,
    "no_store_trick": NO_STORE_TRICK,
    "all_tricks": chain(BYTE_TRICK, TRUNC_TRICK),
    # the first design of this kernel: adjacent columns, unguarded, all three tricks
    "adjacent_unguarded_all_tricks": chain(_warp_adjacent, _warp_unguarded, BYTE_TRICK,
                                           TRUNC_TRICK),
    "word_gathers": lambda s: replace_span(s, WARP_GATHERS_START, WARP_LERP_START, WORD_GATHERS),
    "staged_footprint": lambda s: replace_span(s, WARP_KERNEL_START, "}  // namespace",
                                               STAGED_FOOTPRINT),
}
# K10's stages alone (timed, not checked): the stores of a value made from the
# pixel's place; the coordinates and lerp on samples made from (x0, y0) with
# no gathers; the coordinates and gathers with the samples' sum stored, no lerp
WARP_ABLATIONS = {
    "ablate_stores_only": lambda s: replace_span(
        s, WARP_PIXEL_CALL_START, "      if (32 * j < left)",
        "      const uint8_t b = static_cast<uint8_t>(x_first + 32 * j + y);\n"),
    "ablate_no_gathers": lambda s: replace_span(
        s, WARP_GATHERS_START, WARP_LERP_START,
        "  const uint32_t b00 = x0 & 255, b01 = y0 & 255, b10 = (x0 ^ y0) & 255;\n"
        "  const uint32_t b11 = (x0 + y0) & 255;\n  (void)p, (void)right, (void)below;\n"),
    "ablate_no_lerp": lambda s: replace_span(
        s, WARP_LERP_START, WARP_PIXEL_END,
        "  return b00 + b01 + b10 + b11 + (__float_as_uint(omdx) ^ __float_as_uint(omdy));\n"),
}


def warp_cases(dev):
    """K10 at scan's call (the 8 document frames and the corners scan finds, to
    1000x800 pages), on one of its frames, the steep and extreme quads of
    chip_smoke.WARP_QUADS on the 8 frames, the (347, 200) page, and 2 frames to
    a 4000x3000 page."""
    frames = torch.from_numpy(document_batch(SCAN_N)).to(dev)
    corners = gt.scan(frames, SCAN_PAGE, SCAN_CAP)[1]
    calls = {f"scan_{SCAN_N}": (frames, corners, SCAN_PAGE),
             "scan_1": (frames[:1], corners[:1], SCAN_PAGE)}
    for name in ("steep", "extreme"):
        quad = torch.tensor(WARP_QUADS[name], dtype=torch.int32, device=dev)
        calls[f"{name}_{SCAN_N}"] = (frames, quad.expand(SCAN_N, 4, 2).contiguous(), SCAN_PAGE)
    calls[f"page_347x200_{SCAN_N}"] = (frames, corners, (347, 200))
    calls["page_4000x3000_2"] = (frames[:2], corners[:2], (4000, 3000))
    cases = {f"quad_warp_{label}": (x.shape, lambda a=(x, c, p): K.quad_warp(*a),
                                    lambda a=(x, c, p): K.quad_warp_plain(*a))
             for label, (x, c, p) in calls.items()}
    return cases, {}


TEMPLATE_VARIANTS = {
    "committed": lambda s: s,
    # every template on the INT32 design (PR 15's kernel), or every one up to
    # kMmaMaxWidth on the tensor cores: the crossover
    "int32_all": const("kMmaMinWidth", 1 << 20),
    "mma_from1": const("kMmaMinWidth", 1),
    # the tensor-core design's tiles: rows and columns a warp, warps a block
    **{f"r{r}": const("kMmaR", r) for r in (1, 4)},
    "r4_warps2x1": chain(const("kMmaR", 4), const("kMmaWarpsY", 1)),
    "q2": const("kMmaQ", 2),
    "warps1x4": chain(const("kMmaWarpsX", 1), const("kMmaWarpsY", 4)),
    "warps4x1": chain(const("kMmaWarpsX", 4), const("kMmaWarpsY", 1)),
    "stage32k": const("kMmaStageBytes", "32 * 1024"),
    "stage_rows2": const("kStageRows", 2),
    "stage_rows8": const("kStageRows", 8),
    "unroll_i4": lambda s: edit(s, "#pragma unroll 2\n  for (int i = c0; i < c1; ++i) {",
                                "#pragma unroll 4\n  for (int i = c0; i < c1; ++i) {"),
}
# the tensor-core design without its win(I^2) sums, or with each product tile
# replaced by an XOR of its registers into the sums (timed, not checked)
TEMPLATE_ABLATIONS = {
    "no_win": lambda s: edit(
        s, "      column_squares(fs, fp, c0, c1, rows, cols, vp, vs);\n", "",
        "    row_squares(vs, vp, tw, rows, min(kBandCols, rw - x0), ws);\n", ""),
    "no_mma": lambda s: replace_span(
        s, '  asm volatile(\n      "mma.sync', "#else\n  // the same product",
        "  c[0] += a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ b[1];\n"),
}

# (frames, template): bench_all.py's 64 frames of lena tiled to 480x640 with
# its 32x32 template and four more; fewer frames for the largest templates,
# whose plain version is a loop of th * tw steps
TEMPLATE_SHAPES = (((64, 480, 640), (1, 1)), ((64, 480, 640), (8, 8)),
                   ((64, 480, 640), (32, 32)), ((64, 480, 640), (64, 48)),
                   ((64, 480, 640), (16, 100)), ((2, 24600, 640), (24577, 1)),
                   ((4, 480, 640), (257, 257)), ((4, 16, 8000), (9, 7339)))


def template_cases(dev):
    """K19 at every shape of TEMPLATE_SHAPES: lena tiled to the frame shape,
    the template cut from frame 0."""
    cases = {}
    for (n, h, w), (th, tw) in TEMPLATE_SHAPES:
        frames = torch.from_numpy(lena_batch(n, h, w, roll=11)).to(dev)
        y, x = min(200, h - th), min(300, w - tw)
        tmpl = frames[0, y:y + th, x:x + tw].contiguous()
        cases[f"match_template_{th}x{tw}"] = (
            frames.shape, lambda a=(frames, tmpl): K.match_template(*a),
            lambda a=(frames, tmpl): K.match_template_plain(*a))
    return cases, {}


CONTOUR_VARIANTS = {
    "committed": lambda s: s,
    # every frame walked on its bytes, as frames past 0.93 MP are
    "bytes_always": const("kMaxBitmapBytes", 0),
    # 16 warps a block: find's windows of 16 walks
    "threads512": const("kStageThreads", 512),
}


def contour_cases(dev):
    """K20 at ``find_contours``' and ``largest_blob_contour``'s calls on the
    12-blob frame of ``bench_all.py``, and a trace of the 40x128 spiral that
    runs to the step bound; each call on a fresh mask (the memset is timed too)."""
    cim = torch.from_numpy(twelve_blobs()).to(dev)
    table, label_map, _ = gt.blobs(cim, CONTOUR_BLOBS)
    sp = torch.from_numpy(spiral(40, 128)).to(dev)
    calls = {"find_12_blobs": (cim, {"table": table, "label_map": label_map,
                                     "max_contours": CONTOUR_CAP}),
             "largest_12_blobs": (cim, {"table": table, "label_map": label_map, "largest": True}),
             "trace_spiral_40x128_step_bound": (sp, {"start": (0, 39)})}

    def call(kernel, img, kw):
        return kernel(img, torch.zeros_like(img), **kw)

    cases = {f"contour_{label}": (img.shape, lambda a=(img, kw): call(K.contour, *a),
                                  lambda a=(img, kw): call(K.contour_plain, *a))
             for label, (img, kw) in calls.items()}
    return cases, {}


# K21's orientation with kOrientItems neighbouring elements a thread, in place
# of the committed kernel (a thread an element) and its entry's launch
ORIENT_ITEMS = r"""// kOrientItems neighbouring elements a thread; one vector load or store an
// array where vector is set (every pointer aligned to kOrientItems elements).
constexpr int kOrientItems = @ITEMS@;

__device__ __forceinline__ void load_items(const int* __restrict__ p, size_t first, size_t n,
                                           bool vector, int (&v)[kOrientItems]) {
  if (vector && first + kOrientItems <= n) {
    if constexpr (kOrientItems == 4) {
      const int4 t = *reinterpret_cast<const int4*>(p + first);
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
      return;
    } else if constexpr (kOrientItems == 2) {
      const int2 t = *reinterpret_cast<const int2*>(p + first);
      v[0] = t.x;
      v[1] = t.y;
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < kOrientItems; ++k) v[k] = first + k < n ? p[first + k] : 0;
}

__device__ __forceinline__ void store_items(float* __restrict__ p, size_t first, size_t n,
                                            bool vector, const float (&v)[kOrientItems]) {
  if (vector && first + kOrientItems <= n) {
    if constexpr (kOrientItems == 4) {
      *reinterpret_cast<float4*>(p + first) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    } else if constexpr (kOrientItems == 2) {
      *reinterpret_cast<float2*>(p + first) = make_float2(v[0], v[1]);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < kOrientItems; ++k) {
    if (first + k < n) p[first + k] = v[k];
  }
}

__global__ void __launch_bounds__(kOrientThreads)
    fs_orient_kernel(const int* __restrict__ m01, const int* __restrict__ m10,
                     float* __restrict__ angle, float* __restrict__ sin_out,
                     float* __restrict__ cos_out, size_t n, bool vector) {
  const size_t first =
      (static_cast<size_t>(blockIdx.x) * kOrientThreads + threadIdx.x) * kOrientItems;
  if (first >= n) return;
  int y[kOrientItems], x[kOrientItems];
  load_items(m01, first, n, vector, y);
  load_items(m10, first, n, vector, x);
  float a[kOrientItems], s[kOrientItems], c[kOrientItems];
#pragma unroll
  for (int k = 0; k < kOrientItems; ++k) {
    a[k] = fs_atan2(__int2float_rn(y[k]), __int2float_rn(x[k]));
    s[k] = fs_sin(a[k]);
    c[k] = fs_sin(__fadd_rn(a[k], kCosOffset));
  }
  store_items(angle, first, n, vector, a);
  store_items(sin_out, first, n, vector, s);
  store_items(cos_out, first, n, vector, c);
}

"""
ORIENT_ITEMS_ENTRY = r"""int gs_fs_orient(const void* m01, const void* m10, void* angle, void* sin_out,
                 void* cos_out, size_t n, void* stream) {
  unsigned blocks;
  if (!blocks_for(n, static_cast<size_t>(kOrientThreads) * kOrientItems, &blocks)) {
    return cudaErrorInvalidConfiguration;
  }
  const uintptr_t all = reinterpret_cast<uintptr_t>(m01) | reinterpret_cast<uintptr_t>(m10) |
                        reinterpret_cast<uintptr_t>(angle) | reinterpret_cast<uintptr_t>(sin_out) |
                        reinterpret_cast<uintptr_t>(cos_out);
  const bool vector = @VECTOR@;
  fs_orient_kernel<<<blocks, kOrientThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(m01), static_cast<const int*>(m10), static_cast<float*>(angle),
      static_cast<float*>(sin_out), static_cast<float*>(cos_out), n, vector);
  return cudaGetLastError();
}

"""


def orient_items(items, vector=True):
    """The edit that gives each gs_fs_orient thread ``items`` elements, with
    vector loads and stores where aligned (``vector``) or scalar ones always."""
    def make(text):
        text = replace_span(text, "// A thread an element: angle", "bool blocks_for(",
                            ORIENT_ITEMS.replace("@ITEMS@", str(items)))
        return replace_span(text, "int gs_fs_orient(", "// y, x, out: n float32 each",
                            ORIENT_ITEMS_ENTRY.replace(
                                "@VECTOR@", "all % (sizeof(float) * kOrientItems) == 0"
                                if vector else "false"))
    return make


FREESTANDING_VARIANTS = {"committed": lambda s: s}  # 128 threads, an element each
for _threads in (64, 128, 256):
    _block = const("kOrientThreads", _threads)
    if _threads != 128:
        FREESTANDING_VARIANTS[f"t{_threads}_i1"] = _block
    for _items in (2, 4):
        FREESTANDING_VARIANTS[f"t{_threads}_i{_items}"] = chain(_block, orient_items(_items))
        FREESTANDING_VARIANTS[f"t{_threads}_i{_items}_scalar"] = chain(
            _block, orient_items(_items, vector=False))


class _Int32s:
    """``n`` int32 on the card at ``ptr``, for ``torch.as_tensor``."""

    def __init__(self, ptr, n):
        self.__cuda_array_interface__ = {"shape": (n,), "typestr": "<i4", "data": (ptr, False),
                                         "strides": None, "version": 2}


def three_launch_orient(lib):
    """A stand-in ``gs_fs_orient`` for a tree without it: the two casts of the
    moments, then its ``gs_fs_atan2`` and ``gs_fs_sin`` twice, as its
    ``orb_extract`` ran them."""
    offset = float(np.float32(FS_COS_OFFSET))

    def orient(m01, m10, angle, sin_out, cos_out, n, stream):
        y, x = (torch.as_tensor(_Int32s(p, n), device="cuda").to(torch.float32) for p in (m01, m10))
        codes = (lib.gs_fs_atan2(y.data_ptr(), x.data_ptr(), angle, n, stream),
                 lib.gs_fs_sin(angle, sin_out, n, -0.0, stream),
                 lib.gs_fs_sin(angle, cos_out, n, offset, stream))
        return next((c for c in codes if c), 0)
    return orient


def freestanding_cases(dev):
    """K21's orientation at ``orb_extract``'s call (16 x 500 keypoints on lena)
    and on 1 M seeded moment pairs, and the three-launch composition on each;
    outputs as int32 bits."""
    F = K.freestanding
    batch = torch.from_numpy(lena_batch(ORB_N, ORB_H, ORB_W, roll=5)).to(dev)
    bits = lambda ts: tuple(t.view(torch.int32) for t in ts)  # noqa: E731
    cases = {}
    for label, (m01, m10) in (("call", orb_call_moments(batch)),
                              ("1M", tuple(t.to(dev) for t in fs_moment_pairs(
                                  np.random.default_rng(9))))):
        plain = lambda a=(m01, m10): bits(F.fs_orient_plain(*a))  # noqa: E731
        cases[f"orient_{label}"] = (m01.shape, lambda a=(m01, m10): bits(F.fs_orient(*a)), plain)
        cases[f"composition_{label}"] = (m01.shape, lambda a=(m01, m10): bits(fs_composition(*a)),
                                         plain)
    return cases, {}


def launch_floors(dev):
    """Device ms of an empty kernel (``chip_smoke.LAUNCH_FLOOR_SOURCE``) on each
    grid ``gs_fs_orient`` could take at ``orb_extract``'s 8,000 elements."""
    launch = launch_floor(dev)
    floors = {}
    for threads in (64, 128, 256):
        for items in (1, 2, 4):
            blocks = -(-ORB_N * ORB_CAP // (threads * items))
            floors[f"t{threads}_i{items}"] = {
                "grid": [blocks, threads],
                "device_ms": device_ms(lambda: launch(blocks, threads), kernel="launch_floor")}
    return {"elements": ORB_N * ORB_CAP, "floors": floors}


# sources whose kernels are short enough that back-to-back calls may time the
# host: their variants are also timed by the profiler's device events
DEVICE_TIMED = ("fast", "otsu", "bandwidth", "patches", "ccl", "integral", "warp", "template",
                "contour", "freestanding")

SOURCES = {
    "preproc": ("preproc.cu", ("gs_blur_hist", "gs_blur_hist_window", "gs_threshold_sobel",
                               "gs_threshold_sobel_window", "gs_adaptive"),
                PREPROC_VARIANTS, PREPROC_ABLATIONS, preproc_cases, r"threshold_sobel|blur_hist|Used"),
    "stencil3": ("stencil3.cu", ("gs_morph", "gs_filter3"), STENCIL3_VARIANTS, {},
                 stencil3_cases, r"morph|filter3|Used"),
    "bandwidth": ("bandwidth.cu", ("gs_copy", "gs_triad"), BANDWIDTH_VARIANTS, {},
                  bandwidth_cases, r"triad|copy|Used"),
    "resize": ("resize.cu", ("gs_resize",), RESIZE_VARIANTS, {}, resize_cases, r"resize|Used"),
    "fast": ("fast.cu", ("gs_fast",), FAST_VARIANTS, {}, fast_cases, r"fast|Used"),
    "otsu": ("otsu.cu", ("gs_otsu",), OTSU_VARIANTS, {}, otsu_hist_cases, r"otsu|Used"),
    "patches": ("patches.cu", ("gs_orb_moments", "gs_orb_brief"), PATCHES_VARIANTS,
                PATCHES_ABLATIONS, patches_cases, r"orb_moments|orb_brief|Used"),
    "integral": ("integral.cu", ("gs_integral",), INTEGRAL_VARIANTS, INTEGRAL_ABLATIONS,
                 integral_cases, r"band|carry|Used"),
    "ccl": ("ccl.cu", ("gs_ccl",), CCL_VARIANTS, CCL_ABLATIONS, ccl_cases, r"tile|border|flatten|merge|init|Used"),
    "warp": ("warp.cu", ("gs_quad_warp",), WARP_VARIANTS, WARP_ABLATIONS, warp_cases,
             r"quad_warp|Used"),
    "template": ("template.cu", ("gs_match_template",), TEMPLATE_VARIANTS, TEMPLATE_ABLATIONS,
                 template_cases,
                 r"match_template|Used"),
    "contour": ("contour.cu", ("gs_contour",), CONTOUR_VARIANTS, {}, contour_cases,
                r"contour|Used"),
    "freestanding": ("freestanding.cu", ("gs_fs_orient", "gs_fs_atan2", "gs_fs_sin"),
                     FREESTANDING_VARIANTS, {}, freestanding_cases, r"fs_|Used"),
}
# (kernel, library call) pairs that every variant is also timed against in
# chip_smoke.alternate_windows, variants in order and then in reverse
ALTERNATING = {"bandwidth": (("copy", "copy_"),)}


def emit(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def device_ms_or_none(fn):
    """``device_ms(fn)``, tried twice; None where the profiler saw no device time."""
    for _ in range(2):
        try:
            return device_ms(fn)
        except AssertionError:
            pass
    return None


def mean_or_none(values):
    values = [v for v in values if v is not None]
    return statistics.fmean(values) if values else None


def build_variants(source, entries, variants, parent):
    """Compile every variant of ``source`` at once; return ({name: loaded library},
    {name: ptxas lines}, {name: why it was dropped}, {name: stand-ins for entries
    whose C arguments differ from the committed ones})."""
    text = (_build.CSRC_DIR / source).read_text()
    sources, failed = {}, {}
    for name, make in variants.items():
        try:
            sources[name] = make(text)
        except AssertionError as e:
            failed[name] = f"edit: {e}"
    for path in parent:
        with open(os.path.join(path, "grayskull_tpu_torch", "csrc", source)) as f:
            sources[os.path.basename(os.path.normpath(path))] = f.read()
    jobs = {}
    stem = source.removesuffix(".cu")
    for name, body in sources.items():
        d = _build.BUILD_DIR / "sweep" / stem / name
        d.mkdir(parents=True, exist_ok=True)
        (d / source).write_text(body)
        cmd = _build.compile_command(d / source, d / f"{stem}.o") + ["-Xptxas", "-v"]
        jobs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
    libs, regs, overrides = {}, {}, {}
    for name, (d, proc) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            failed[name] = f"nvcc failed:\n{out[-3000:]}"
            continue
        regs[name] = [line.split("ptxas info    : ")[-1] for line in out.splitlines()
                      if "registers" in line or "spill" in line]
        subprocess.run(_build.link_command([d / f"{stem}.o"], d / f"lib{stem}.so"), check=True)
        lib = ctypes.CDLL(str(d / f"lib{stem}.so"))
        for entry in entries:
            fn = getattr(lib, entry, None)
            if fn is None and entry == "gs_fs_orient":  # a tree before it: three_launch_orient
                continue
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        if source == "contour.cu":
            overrides[name] = older_entries(lib, sources[name])
        if source == "freestanding.cu" and not hasattr(lib, "gs_fs_orient"):
            overrides[name] = {"gs_fs_orient": three_launch_orient(lib)}
        libs[name] = lib
    return libs, regs, failed, overrides


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", choices=sorted(SOURCES), default="preproc",
                    help="the csrc file whose variants are timed")
    ap.add_argument("--parent", action="append", default=[],
                    help="a checkout whose file of the same name is timed too (repeatable)")
    ap.add_argument("--only", action="append", default=[],
                    help="build only this variant (repeatable; default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_sweep: no CUDA device", file=sys.stderr)
        return 1
    source, entries, variants, ablations, make_cases, reg_pattern = SOURCES[args.source]
    if args.only:
        variants = {k: v for k, v in variants.items() if k in args.only}
        ablations = {k: v for k, v in ablations.items() if k in args.only}
    dev = torch.device("cuda", 0)
    card = card_line()
    t0 = time.perf_counter()
    committed = _build.library()  # the inputs come from the committed build
    libs, regs, failed, overrides = build_variants(source, entries, {**variants, **ablations},
                                                   args.parent)
    # the committed file and the --parent trees are held, not dropped: only a text edit may fail
    held = {"committed", *(os.path.basename(os.path.normpath(p)) for p in args.parent)}
    if held & set(failed):
        raise AssertionError(f"a committed or parent build failed: "
                             f"{ {k: v for k, v in failed.items() if k in held} }")
    libs = {name: WithEntries(lib, committed, overrides.get(name)) for name, lib in libs.items()}
    emit("sweep_build", card=card, source=source, seconds=time.perf_counter() - t0,
         variants=list(libs), failed=failed,
         ptxas={name: [r for r in lines if re.search(reg_pattern, r)]
                for name, lines in regs.items()})

    cases, library = make_cases(dev)
    refs = {kernel: plain() for kernel, (_, _, plain) in cases.items()}
    for name, lib in list(libs.items()):
        if name in ablations:
            continue
        _build._lib = lib
        try:
            for kernel, (_, fn, _) in cases.items():
                got, ref = fn(), refs[kernel]
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                for a, b in zip(got, ref):
                    if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
                        raise AssertionError(f"{kernel} differs from the plain version")
            torch.cuda.synchronize()
        except (AssertionError, RuntimeError) as e:
            if "CUDA error" in str(e) or name in held:
                # a fault on the card, or a committed or parent kernel that is wrong
                raise RuntimeError(f"variant {name}: {e}") from e
            failed[name] = f"check: {e}"
            del libs[name]
    _build._lib = committed
    emit("sweep_checks", ok=True, variants=[v for v in libs if v not in ablations],
         unchecked_ablations=list(ablations), failed=failed, kernels=list(cases), max_abs_err=0)

    order = list(libs)
    times = {name: {kernel: [] for kernel in cases} for name in order}
    device = {name: {kernel: [] for kernel in cases} for name in order}
    lib_times = {(kernel, label): [] for kernel, fns in library.items() for label in fns}
    lib_device = {(kernel, label): [] for kernel, fns in library.items() for label in fns}
    timed_on_device = args.source in DEVICE_TIMED
    for turn in (order, order[::-1]):
        for name in turn:
            _build._lib = libs[name]
            try:  # each timing synchronizes, so a fault shows within its variant
                for kernel, (_, fn, _) in cases.items():
                    times[name][kernel].append(timeit(fn) * 1e3)
                    if timed_on_device:
                        device[name][kernel].append(device_ms_or_none(fn))
            except RuntimeError as e:  # a fault on the card (an ablation is not checked)
                raise RuntimeError(f"variant {name}: {e}") from e
        for kernel, fns in library.items():
            for label, fn in fns.items():
                lib_times[kernel, label].append(timeit(fn) * 1e3)
                if timed_on_device:
                    lib_device[kernel, label].append(device_ms_or_none(fn))
    for kernel, label in ALTERNATING.get(args.source, ()):
        alt = {name: [] for name in order}
        for turn in (order, order[::-1]):
            for name in turn:
                _build._lib = libs[name]
                alt[name].append(alternate_windows(cases[kernel][1], library[kernel][label]))
        gaps = {name: [w["median_gap_ms"] for w in ws] for name, ws in alt.items()}
        emit("alternating", card=card, source=source, kernel=kernel, library=label,
             median_gap_ms=gaps, mean_gap_ms={name: statistics.fmean(g) for name, g in gaps.items()},
             kernel_median_ms={name: [w["kernel"]["median_ms"] for w in ws]
                               for name, ws in alt.items()},
             library_median_ms={name: [w["library"]["median_ms"] for w in ws]
                                for name, ws in alt.items()},
             fastest=min(gaps, key=lambda name: statistics.fmean(gaps[name])),
             windows="chip_smoke.alternate_windows (9 windows of 20 calls, kernel and library "
                     "call in turns) for each variant, variants in order then in reverse")
    _build._lib = committed
    for kernel, (shape, _, _) in cases.items():
        ms = {name: times[name][kernel] for name in order}
        for label in library.get(kernel, ()):
            ms[f"library:{label}"] = lib_times[kernel, label]
        dev_ms = {}
        if timed_on_device:
            dev_ms = {"device_ms": {name: device[name][kernel] for name in order},
                      "mean_device_ms": {name: mean_or_none(device[name][kernel])
                                         for name in order}}
            for label in library.get(kernel, ()):
                dev_ms["device_ms"][f"library:{label}"] = lib_device[kernel, label]
                dev_ms["mean_device_ms"][f"library:{label}"] = mean_or_none(
                    lib_device[kernel, label])
        emit("sweep", card=card, source=source, kernel=kernel, shape=list(shape), ms=ms,
             mean_ms={name: sum(v) / len(v) for name, v in ms.items()}, **dev_ms,
             windows="profiling.timeit (median of 3 windows of 20 calls), variants in order "
                     "then in reverse" + (", the library call after each turn" if library else ""))
    if library:  # what each library call runs on the device, by name, from the profiler
        from torch.profiler import ProfilerActivity, profile

        on_device = {}
        for kernel, fns in library.items():
            for label, fn in fns.items():
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        fn()
                    torch.cuda.synchronize()
                names = {}
                for e in device_events(prof):
                    names[e.name] = names.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e4
                on_device[f"{kernel}:{label}"] = names
        emit("library_kernels", card=card, device_ms_a_call_by_name=on_device,
             source="torch.profiler device events over 10 calls after a warm-up call")
    probes = {"otsu": ("fadd_latency", fadd_latency), "contour": ("load_latency", load_latency),
              "freestanding": ("launch_floor", launch_floors)}
    if args.source in probes:
        phase, probe = probes[args.source]
        emit(phase, card=card, **probe(dev),
             clock_mhz=subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                       "--format=csv,noheader,nounits"], capture_output=True,
                                      text=True, check=True).stdout.strip())
    emit("elapsed", seconds=time.perf_counter() - t0)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
