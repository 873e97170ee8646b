#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``grayskull_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py [--parent DIR]

It builds the port's CUDA kernels from ``grayskull_tpu_torch/csrc`` with
``nvcc``, holds each kernel bit for bit to its plain PyTorch version on the
card, and drives the port's four paths, each entry point with the launch
counts set to 0 just before it and read just after:

* preprocess (``grayskull_tpu_torch.preprocess``: blur(2) -> Otsu -> threshold
  -> Sobel on 256 frames of 1024x1024), checked against the plain path and the
  numpy goldens;
* faces (``grayskull_tpu_torch.detect_faces``: integral -> LBP cascade over
  the full scale ladder -> the first 100 rects per frame, on 32 frames of
  640x480 at step 1), checked against the plain path on the card (every
  ladder scale's hit mask of the 32 frames, and the rect tables) and, for two
  frames, on the CPU;
* ORB (``grayskull_tpu_torch.orb_extract(frames, 500, 20)`` on 16 frames of
  640x480; ``grayskull_tpu_torch.track`` on the aruco template and scene with
  2,500 keypoints; and the same-shape pair of aruco and aruco rolled 9
  columns through ``orb_extract`` + ``match_orb``), checked against the plain
  path on the card, in the ``exact_host`` trig mode against the plain path on
  the CPU, and against the FAST and matching goldens;
* the document scanner (``grayskull_tpu_torch.scan``: blur(1) -> Otsu+10 ->
  blobs -> the largest blob's corners -> a 1000x800 page, on 8 frames of
  ``document.pgm`` rolled 3*i columns and on one frame), checked against the
  plain path on the card, the plain path on the CPU for two frames, and the
  goldens ``blobs_*``, ``multiblob_*`` and ``persp``;
* the dense ops (BASELINE config #2, ``erode(dilate(adaptive_threshold(x,
  15, 5)))`` on 256 frames of ``receipt.pgm`` rolled 5*i columns, and the
  ten dense goldens through ``adaptive_threshold``, ``erode``, ``dilate``, the
  four filter presets, ``resize``, ``resize_nn`` and ``crop``), checked
  against the plain path on the card, the CPU for frames 0 and 255, and the
  goldens;
* the nanomagick CLI (``grayskull_tpu_torch.cli.main``), each of its 14
  commands on the card, byte for byte against the same command on the CPU;
* the sharded paths (``grayskull_tpu_torch.parallel``) on meshes that name
  ``cuda:0`` several times: ``preprocess_spatial_shardmap`` on the 256 lena
  frames of 1024x1024 over a (1, 4) mesh (K15 4 times, K3 once, K16 4 times)
  and 16 of them over (2, 4) at r = 1 and 5, ``preprocess_sharded``,
  ``integral_sharded`` and ``scan_sharded``, each against its single-device
  entry point, and two frames against the plain path on the CPU;
* the bandwidth probe (``grayskull_tpu_torch.profiling.hbm_bandwidth_gbps``,
  K17 ``copy`` and K18 ``triad`` over 256 MiB);
* template matching and contours: ``match_template`` + ``find_best_match`` on
  64 frames of lena tiled to 480x640 (frame i rolled 11*i columns) with a
  32x32 template, ``parallel.match_template_sharded`` over (1, 4) and (2, 4)
  meshes with templates shorter than, as tall as and taller than a shard,
  ``find_contours``, ``largest_blob_contour`` and ``trace_contour`` (with and
  without a carried mask) on ``benchmarks/bench_all.py``'s 12-rectangle frame,
  each against the plain path on the CPU, and the goldens ``match_template``,
  ``contour1``, ``contour2``, ``contour_visited`` and ``largest_contour``;
* the sparse sharded paths (``grayskull_tpu_torch.parallel.sparse``) on
  meshes of ``cuda:0``: ``label_components_sharded`` and ``blobs_sharded`` on
  the binarized ``document.pgm`` over (1, 4) with cap 1000 (and the labels of
  seeded noise at density 0.55), ``scan_spatial_shardmap`` on ``document.pgm``
  and ``receipt.pgm`` to 1000x800 pages, ``orb_extract_spatial`` on aruco at
  2,500 keypoints and a 480x640 lena frame at 500, ``match_orb_sharded`` on
  ``track``'s aruco tables, and ``detect_faces_sharded`` on the faces path's 32
  frames over (2, 4), each against its single-device entry point on the card,
  with its launches and host waits counted (the sync debug mode "warn": the
  labelling's union-find waits once a call, the others never), the scanner
  and ORB (``exact_host`` trig) against the plain path on a CPU mesh; K10's
  rows entry (``quad_warp_rows``) against its plain version on bands at the
  top, the middle and the bottom, one-row bands and pages of one row or
  column;
* the ``freestanding`` trig mode (``libm32.use_freestanding``, the reference's
  ``GS_NO_STDLIB`` polynomials): K21's orientation entry (``fs_orient``)
  against its plain version on 1 M int32 moment pairs (0/0, +-1, int32's
  ends, odd values past 2^24, angles near +-pi and cosine inputs past pi
  among them) and at ``orb_extract``'s call, its atan2 and sine entries on
  1 M (y, x) pairs and 1 M sine inputs, ORB's range with and without the
  cosine's offset, the loop-end inputs (NaN) and the largest inside the
  bound; then the ORB frames' ``orb_extract``, ``track`` on aruco and
  ``orb_extract_spatial`` over a (1, 4) mesh of ``cuda:0`` in that mode,
  each with its K21 launches (1, 6 and 1) and host waits (none) counted,
  against the plain path on the card (the plain trig) and on the CPU, bit
  for bit, and the device launches of an ``orb_extract`` call in both modes
  from the profiler;
* ``debug``: ``dump`` of a card batch and a card float frame against the
  CPU's files, ``draw_rects`` and ``draw_crosses`` of card ``detect_faces``
  and ``orb_extract`` tables against the CPU tables', ``nan_guard`` on the card;
* the demos: ``examples/stream_demo_torch.py``'s ``main`` on 32 synthetic
  frames of 480x640 through ``blur:1,threshold:otsu,blobs,keypoints,faces,
  contours`` (its last two frames and overlay against the same run on the
  CPU), and ``examples/live_demo_torch.py``'s ``Demo`` on the card behind a
  local server at 240x320 (every endpoint, ``capture=1`` and the 400s, each
  JSON body against a CPU ``Demo``'s).

Then it times the paths with CUDA events, profiles preprocess, detect_faces,
orb_extract, track, the scanner, config #2, the resize, the sharded
preprocess, the template and contour entry points and the sparse sharded
calls (each beside its single-device call, ``sparse_timing``) (``torch.profiler``:
device time by kernel and op, idle share, host enqueue time), takes K4's, K6's, K7's, K8's,
K9's and K22's (``blob_stats`` on the label maps of 32 document pages, after
K22 is held to its plain version there, on a slab's rows from 700, a
2100x2100 blob and 7000 labels) device time from the profiler (K8 also at
each of ``track``'s six calls; with ``--parent DIR``, K4, K8, K10, K19 and
K20 of DIR's ``csrc/`` in turns with the committed ones),
K10's at ``scan``'s call, K20's at ``find_contours``' and
``largest_blob_contour``'s calls and on a spiral trace, and
measures K5's real work: each window's exit stage on two faces frames (the
plain version with the cascade cut to its first s stages), the weaks a window
runs and the divergence of 32 neighbouring windows, from which K5's bound is
counted; K20's bound is its longest walk's steps (the walks of a call run
side by side) times one dependent shared-memory load
(``SHARED_LOAD_LATENCY_CYCLES``, which ``chip_sweep.py --source contour``
measures).  K19's is its correlation's byte products at the int8 tensor rate,
and its design's own ceiling the products its tensor-core tiles issue.
K21's ``fs_orient`` is timed at ``orb_extract``'s call and on 1 M moment
pairs (L2-warm, and cold after 128 MiB written), in turns with the
three-launch composition it replaced, beside an empty kernel on the same
grid (``LAUNCH_FLOOR_SOURCE``: the launch floor) and ``torch.atan2`` (a
yardstick, not the same function); its operations are the FP32-pipe and
conversion-rate instructions of its kernels' SASS (``cuobjdump -sass``,
every instruction once) and two a range-reduction step the data takes.
Each phase prints one JSON line; then come the per-kernel summary line (each
kernel's launches on its path, largest error, time, plain version's time,
bound and, where one PyTorch call computes the same function, that call's
time, and its bound again at the measured copy rate, ``bound_ms_at_copy``;
operations are counted by kind, FP32 or INT32, at the issue rate of their
kind from the card's SM count and top clock, or int8 products at the tensor
cores' rate, where a row has restated them)
and the card's ``nvidia-smi`` name and power limit (also on the ``build`` line, with
whether the native PGM loader, ``csrc/gsio.c``, built and where), and the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and the exit code is
non-zero; without a CUDA device it exits 1 and prints no result.
"""

import argparse
import contextlib
import ctypes
import dataclasses
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

import grayskull_tpu_torch as gt
from grayskull_tpu_torch import kernels as K
from grayskull_tpu_torch import libm32, native
from grayskull_tpu_torch.io import read_pgm
from grayskull_tpu_torch.core import LbpCascade, host_arrays_to
from grayskull_tpu_torch.kernels import _build
from grayskull_tpu_torch.kernels.integral import u32_to_int64
from grayskull_tpu_torch.kernels.warp import warp_grid
from grayskull_tpu_torch.ops.lbp import _grid_plan
from grayskull_tpu_torch.ops.pixel import downsample
from grayskull_tpu_torch.pipelines.orb import pyramid_levels
from grayskull_tpu_torch.profiling import timeit

HERE = os.path.dirname(os.path.abspath(__file__))
METRIC = "fused_blur_otsu_threshold_sobel_1MP_frames_per_sec"
SHAPES = [(2, 24, 128), (1, 97, 200), (1, 7, 8), (1, 17, 129), (2, 816, 612), (4, 1024, 1024),
          (2, 64, 7), (1, 70, 1000)]  # widths 7, 129, 612 and 1000 are no multiples of 16
# widths around one 16-byte word, and frames of one row, one pixel, one column
EDGE_SHAPES = [(1, 9, 1), (1, 9, 15), (1, 9, 16), (1, 9, 17), (1, 9, 31), (1, 9, 33), (1, 1, 1),
               (1, 1, 9), (2, 5, 1)]
UNALIGNED = (3, 7, 9)  # its [1:] is contiguous and starts 63 bytes in: the byte paths
RADII = (1, 2, 6, 7, 16, 40)
MAIN_N, MAIN_H, MAIN_W, MAIN_R = 256, 1024, 1024, 2
FACES_METRIC = "lbp_windows_per_sec"
FACES_N, FACES_H, FACES_W, FACES_STEP, FACES_CAP = 32, 480, 640, 1, 100
LADDER = (1.2, 1.0, 4.0)  # scale_factor, min_scale, max_scale
INTEGRAL_SHAPES = [(1, 7, 8), (2, 97, 200), (3, 1, 40), (1, 17, 129), (32, 480, 640),
                   (1, 4200, 4200)]  # the last is all 255s: its sums pass 2^32
# K4's bands of 16 rows and threads of 4 columns in blocks of up to 1024:
# heights one short of, at and past one and two bands, widths around a
# thread's 4 columns and a block's 1024, one row, one column, the shard of a
# (1, 4) mesh; and frames that start 1 .. 4 bytes into their buffer (the byte path)
INTEGRAL_EDGE_SHAPES = [(2, 15, 64), (2, 16, 64), (2, 17, 64), (1, 31, 8), (1, 32, 8), (1, 33, 3),
                        (3, 1, 1), (1, 1, 1025), (1, 40, 1), (1, 9, 2), (1, 9, 5), (1, 9, 15),
                        (1, 9, 17), (2, 70, 1024), (1, 70, 1028), (1, 33, 2049), (32, 120, 640)]
INTEGRAL_UNALIGNED = ((2, 65, 640), (3, 33, 129))
KERNELS = {
    "blur_hist": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/preproc.cu",
                  "replaces": "grayskull_tpu/kernels/preproc.py:273",
                  "also_replaces": "grayskull_tpu/kernels/preproc.py:485"},
    "otsu": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/otsu.cu",
             "replaces": "grayskull_tpu/ops/histogram.py:55"},
    "threshold_sobel": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/preproc.cu",
                        "replaces": "grayskull_tpu/kernels/preproc.py:794",
                        "also_replaces": "grayskull_tpu/kernels/preproc.py:569"},
    "integral": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/integral.cu",
                 "replaces": "grayskull_tpu/kernels/integral.py:111"},
    "lbp_eval_scale": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/lbp.cu",
                       "replaces": "grayskull_tpu/kernels/lbp.py:396"},
    "fast": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/fast.cu",
             "replaces": "grayskull_tpu/kernels/fast.py:207"},
    "orb_moments": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/patches.cu",
                    "replaces": "grayskull_tpu/kernels/patches.py:99"},
    "orb_brief": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/patches.cu",
                  "replaces": "grayskull_tpu/kernels/patches.py:99"},
    "ccl": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/ccl.cu",
            "replaces": "grayskull_tpu/kernels/ccl.py:161"},
    "quad_warp": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/warp.cu",
                  "replaces": "grayskull_tpu/kernels/warp.py:163",
                  "also_replaces": "grayskull_tpu/kernels/warp.py:98"},
    "adaptive": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/preproc.cu",
                 "replaces": "grayskull_tpu/kernels/preproc.py:515"},
    "morph": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/stencil3.cu",
              "replaces": "grayskull_tpu/kernels/preproc.py:616"},
    "filter3": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/stencil3.cu",
                "replaces": "grayskull_tpu/kernels/preproc.py:723"},
    "resize": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/resize.cu",
               "replaces": "grayskull_tpu/kernels/resize.py:217"},
    "blur_hist_window": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/preproc.cu",
                         "replaces": "grayskull_tpu/kernels/preproc.py:351"},
    "threshold_sobel_window": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/preproc.cu",
                               "replaces": "grayskull_tpu/kernels/preproc.py:865"},
    "copy": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/bandwidth.cu",
             "replaces": "grayskull_tpu/profiling.py:56"},
    "triad": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/bandwidth.cu",
              "replaces": "grayskull_tpu/profiling.py:61"},
    "match_template": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/template.cu",
                       "replaces": "grayskull_tpu/ops/template.py:30"},
    "contour": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/contour.cu",
                "replaces": "grayskull_tpu/ops/contour.py:36"},
    "quad_warp_rows": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/warp.cu",
                       "replaces": "grayskull_tpu/ops/warp.py:68"},
    "freestanding": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/freestanding.cu",
                     "replaces": "grayskull_tpu/libm32.py:110",
                     "also_replaces": "grayskull_tpu/libm32.py:126"},
    "blob_stats": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/blobs.cu",
                   "replaces": "grayskull_tpu/ops/blobs.py:112 _aggregate_stats"},
}

PREPROCESS_KERNELS = ("blur_hist", "otsu", "threshold_sobel")
FACES_KERNELS = ("integral", "lbp_eval_scale")
ORB_KERNELS = ("fast", "orb_moments", "orb_brief")
ORB_N, ORB_H, ORB_W, ORB_CAP, ORB_THR = 16, 480, 640, 500, 20
TRACK_KPS, PAIR_CAP, PAIR_DIST = 2500, 500, 64
FAST_SHAPES = [(2, 24, 128), (1, 97, 200), (1, 7, 8), (1, 17, 129), (16, 480, 640),
               (1, 2900, 2900)]  # the last is past 2^23 pixels: int64 keys
FAST_THRESHOLDS = (0, 5, 20, 60, 200)
# K6's edges: widths 7 .. 40 and 641 (its segments write 240 columns), frames
# under 7 rows, 65,537 frames, and frames at byte offsets 1 .. 15 of a buffer
# (the byte path)
FAST_EDGE_SHAPES = [(1, 20, w) for w in range(7, 41)] + [(2, 30, 641), (2, 6, 50), (1, 3, 9),
                                                          (65537, 7, 9)]
FAST_UNALIGNED = (2, 33, 100)
FAST_EDGE_THRESHOLDS = (0, 20, 256)
SCAN_KERNELS = ("blur_hist", "otsu", "ccl", "blob_stats", "quad_warp")
STATS_PAGES = 32  # K22 is timed on the label maps of 32 document pages (the bulk cell's batch)
SCAN_N, SCAN_PAGE, SCAN_CAP = 8, (1000, 800), 1000
CCL_SHAPES = [(1, 1, 4096), (1, 4096, 1), (1, 7, 8), (1, 17, 129), (1, 768, 1024),
              (8, 768, 1024)]
CCL_DENSITIES = (0.3, 0.55, 0.6)
CCL_WIDTHS = (129, 257, 1023)  # one past one and two of K9's 128-wide tiles, and odd
CCL_MANY_FRAMES = (65537, 4, 8)  # past grid.y's 65,535 frames
WARP_PAGES = [(1000, 800), (347, 200), (1, 10), (10, 1), (4000, 3000)]
WARP_QUADS = {  # on document.pgm (768 wide, 1024 high), tests/test_integral_template_warp.py:193
    "mild": [[50, 40], [700, 60], [690, 1000], [40, 980]],
    "steep": [[0, 400], [760, 0], [767, 600], [10, 1010]],
    "extreme": [[10, 700], [1000, 10], [1020, 760], [3, 10]],
    "identity": [[0, 0], [767, 0], [767, 1023], [0, 1023]],
    "outside": [[-60, -45], [900, -10], [820, 1200], [-30, 1100]],
}
# K10's edges: 65,537 frames (past grid.y's 65,535), sources of one row and of
# one column, page widths 1 .. 17 and 4k +- 1 on 37 rows (row starts on every
# byte offset mod 16, tails of a warp's 128 columns), a frame wider than 2^23
# (floats there are 1 apart), frames of 2^24 + 4 columns and rows
# (the clamp's float32 bound rounds past the last one: the template with
# clamped reads) and one of 2^31 + 1 bytes (64-bit offsets)
WARP_MANY_FRAMES = ((65537, 7, 9), (3, 5))
WARP_THIN_SOURCES = ((2, 1, 300), (2, 300, 1))
WARP_EDGE_WIDTHS = tuple(range(1, 18)) + tuple(4 * k + d for k in (8, 50, 200) for d in (-1, 1))
WARP_WIDE = ((1, 3, 2**23 + 5), (1, 2, 2**24 + 4), (1, 2**24 + 4, 2), (1, 3, 715827883))
DENSE_KERNELS = ("adaptive", "morph")
DENSE_N, DENSE_R, DENSE_C = 256, 15, 5
ADAPTIVE_RADII = (0, 1, 2, 6, 7, 15, 16, 40, 300)
# both ends of int32 and where (int)(mean - c) starts and stops wrapping
ADAPTIVE_CS = (-2**31, -2**31 + 255, -2**31 + 256, -3, 0, 5, 40, 2**31 - 1)
FILTER_TAPS = {  # name: (taps, norm): the presets, negative sums, taps past int8
    "sharpen": (((0, -1, 0), (-1, 5, -1), (0, -1, 0)), 1),
    "emboss": (((-2, -1, 0), (-1, 1, 1), (0, 1, 2)), 1),
    "blur_box": (((1, 1, 1), (1, 1, 1), (1, 1, 1)), 9),
    "blur_gaussian": (((1, 2, 1), (2, 4, 2), (1, 2, 1)), 16),
    "sobel_y norm 1": (((-1, -2, -1), (0, 0, 0), (1, 2, 1)), 1),
    "sobel_y norm 7": (((-1, -2, -1), (0, 0, 0), (1, 2, 1)), 7),
    "wide": (((300, -1000, 5), (0, 70000, 0), (1, 2, -99999)), 3),
    # the int8 edge (K13's dp4a path) and just past it (its multiply-add path)
    "int8 edge": (((127, -128, 127), (-128, 127, -128), (127, -128, 127)), 2),
    "past int8": (((128, -129, 0), (1, 2, 3), (-129, 0, 128)), 5),
}
RESIZE_CASES = [((1024, 1024), (480, 640)), ((480, 640), (768, 1024)), ((480, 640), (347, 200)),
                ((200, 256), (200, 256)), ((816, 612), (100, 40)), ((1, 1), (5, 7)),
                ((7, 1), (3, 9))]
RESIZE_N, RESIZE_TO = 256, (480, 640)
# K14's edges: output widths no multiple of 4 or 16, outputs wider than a
# block's tile and sources wider than a staged segment, 65,537 frames (past the
# grid's z); sources and (through the C entry) outputs at byte offsets 1 .. 15
RESIZE_EDGE_CASES = [((2, 97, 200), (35, w)) for w in (1, 2, 3, 5, 17, 33, 639, 641, 1001)] + [
    ((1, 4, 16000), (3, 9000)), ((1, 4, 16384), (3, 2000)), ((1, 3, 5000), (2, 20000)),
    ((65537, 3, 5), (2, 7)), ((65537, 2, 16), (3, 32))]
RESIZE_UNALIGNED = ((2, 64, 1008), ((30, 630), (40, 1000), (13, 7), (70, 1501)))
SHARDED_KERNELS = ("blur_hist_window", "otsu", "threshold_sobel_window")
BANDWIDTH_KERNELS = ("copy", "triad")
WINDOW_RADII = (1, 2, 6, 16, 40)
# bytes: tails past whole 16-byte words (one thread's vector), one 256-thread
# block's 4096 (K17's and K18's span a block; 12295 is three and a 7-byte
# tail), and the 64, 2048 and 16384 of chip_sweep.py's chunked K18 variants,
# each side
BANDWIDTH_SIZES = (1, 15, 16, 17, 63, 64, 65, 2047, 2048, 2049, 4095, 4096, 4097, 12295, 16383,
                   16384, 16385, 2**20 + 3, 2**28)
BANDWIDTH_OFFSETS = (0, 1, 4, 8)  # bytes the operands start past a 16-byte boundary
BANDWIDTH_WINDOWS = 9  # alternating windows of K17 against copy_ and K18 against torch.add
SPACE = 4  # shards a frame's rows split into on the main sharded mesh
PREPROCESS_OUTPUTS = ("blurred", "binary", "edges", "thresholds")
CLI_COMMANDS = [  # (argv, input, kernels the command must launch on the card)
    (["identify"], "lena", ()), (["view"], "lena", ()),
    (["resize", "300", "170"], "lena", ("resize",)), (["crop", "20", "10", "40", "30"], "lena", ()),
    (["blur", "2"], "lena", ("blur_hist",)), (["threshold", "otsu"], "lena", ("otsu",)),
    (["adaptive", "15", "5"], "receipt", ("adaptive",)), (["sobel"], "lena", ("threshold_sobel",)),
    (["morph", "dilate", "2"], "receipt", ("morph",)),
    (["blobs", "50"], "lena", ("ccl", "blob_stats")), (["scan"], "document", SCAN_KERNELS),
    (["keypoints", "50", "20"], "lena", ("fast",)),
    (["orb", "aruco"], "aruco", ORB_KERNELS), (["faces", "2"], "lena", FACES_KERNELS),
]
# the least time of a kernel: bytes over the memory rate (NVIDIA's H100 SXM data
# sheet, 700 W) or operations over the issue rate of their kind, whichever is
# larger.  The issue rates are lanes x SMs x the card's top SM clock
# (nvidia-smi clocks.max.sm): 128 FP32 lanes an SM, with no FMA (the kernels
# that round as C does build with -fmad=false), 64 INT32 lanes, and 16 type
# conversions (F2I, I2F) a clock an SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0).  Rows whose
# operation count is not restated by kind keep the data sheet's FP32 rate, an
# FMA counted as two ("datasheet").
# "int8_tensor" is the data sheet's dense int8 tensor-core rate (a multiply-add
# counted as two), the peak for products of bytes summed into int32.
# K3's and K20's serial chains are latencies, not rates: "fadd_chain" counts
# dependent __fadd_rn, each FADD_LATENCY_CYCLES at the top clock, and
# "shared_load_chain" dependent shared-memory loads, each
# SHARED_LOAD_LATENCY_CYCLES (chip_sweep.py measures both: the fadd_latency
# line of --source otsu and the load_latency line of --source contour).
HBM_BYTES_PER_S = 3.35e12
OP_RATES = {"datasheet": 67e12, "int8_tensor": 1979e12}  # the others: set_op_rates()
FP32_LANES, INT32_LANES, CONVERSION_LANES = 128, 64, 16
FADD_LATENCY_CYCLES = 4  # chip_sweep.py --source otsu: 4.0048828125 on the H100
SHARED_LOAD_LATENCY_CYCLES = 28.625  # chip_sweep.py --source contour on the H100


def emit(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def _wide(t):
    return u32_to_int64(t) if t.dtype == torch.uint32 else t.to(torch.int64)


def set_op_rates():
    """Fill ``OP_RATES["fp32"]``, ``["int32"]``, ``["conversion"]`` and the chains'
    rates from the card's SMs and top SM clock."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    hz = float(out.strip().splitlines()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    OP_RATES.update(fp32=FP32_LANES * sms * hz, int32=INT32_LANES * sms * hz,
                    conversion=CONVERSION_LANES * sms * hz, fadd_chain=hz / FADD_LATENCY_CYCLES,
                    shared_load_chain=hz / SHARED_LOAD_LATENCY_CYCLES)
    return {"sms": sms, "max_sm_clock_mhz": hz / 1e6, **OP_RATES}


def ops_ms(ops):
    """The least time of ``ops``: a count at the data sheet's rate, or {kind: count},
    each kind at its own issue rate (the kinds issue side by side)."""
    kinds = ops if isinstance(ops, dict) else {"datasheet": ops}
    return max(count / OP_RATES[kind] * 1e3 for kind, count in kinds.items())


def kernel_entry(ms, plain_ms, nbytes, ops, library_ms=None, library=None):
    """A kernel's times beside its bound: the larger of ``nbytes`` (each input
    read once, each output written once) over the memory rate and ``ops`` (see
    ``ops_ms``) over the operation rates, in ms."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops_ms(ops)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": library_ms, "library": library, "bytes": nbytes, "operations": ops,
            "operations_ms": by_ops}


def bound_at(entry, bytes_per_s):
    """``entry``'s bound with the memory rate ``bytes_per_s`` in place of the data sheet's."""
    return max(entry["bytes"] / bytes_per_s * 1e3, entry["operations_ms"])


class Checker:
    """Largest |kernel - plain| seen per kernel; any difference fails the run."""

    def __init__(self):
        self.max_err = {name: 0 for name in KERNELS}
        self.checks = {name: 0 for name in KERNELS}

    def same(self, name, got, ref, what):
        if (got is None) != (ref is None):
            raise AssertionError(f"{name} {what}: one output is None")
        if got is None:
            return
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"{name} {what}: {tuple(got.shape)} {got.dtype} vs "
                                 f"{tuple(ref.shape)} {ref.dtype}")
        err = int((_wide(got) - _wide(ref)).abs().max()) if got.numel() else 0
        self.max_err[name] = max(self.max_err[name], err)
        self.checks[name] += 1
        if err != 0:
            raise AssertionError(f"{name} {what}: max |kernel - plain| = {err}")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
                         check=True).stdout
    return out.strip().splitlines()[0].strip()


class WithEntries:
    """Stands in for the committed library while another library is loaded: the
    other library's entries (or their stand-ins in ``overrides``), and the
    committed library's ``gs_error_string`` and every entry the other library
    does not define (a case that runs a whole entry point, such as ``scan``,
    calls those)."""

    def __init__(self, lib, committed, overrides=None):
        self._lib, self._committed = lib, committed
        self._overrides = overrides or {}
        self.gs_error_string = committed.gs_error_string

    def __getattr__(self, name):
        if name in self._overrides:
            return self._overrides[name]
        try:
            return getattr(self._lib, name)
        except AttributeError:
            return getattr(self._committed, name)


def older_entries(lib, contour_source):
    """Stand-ins for the entries of ``lib``, built from an earlier tree, whose C
    arguments differ from the committed ones: a ``gs_contour`` without the
    scratch ``path`` argument (before the side-by-side walks) is called with
    the committed arguments less that one."""
    if "void* path" in contour_source:
        return {}
    fn = lib.gs_contour
    sig = _build._SIGNATURES["gs_contour"]
    fn.argtypes = (*sig[:-2], sig[-1])
    fn.restype = ctypes.c_int
    return {"gs_contour": lambda *args: fn(*args[:-2], args[-1])}


# K4's, K8's, K10's, K19's and K20's files (K7 shares the second)
PARENT_SOURCES = ("integral.cu", "patches.cu", "warp.cu", "template.cu", "contour.cu")


def parent_library(parent):
    """The kernels of PARENT_SOURCES from ``parent``, an earlier commit's tree (for
    example ``git archive`` of it unpacked under ``build/``), built like the
    committed ones into ``_build/parent/`` and loaded beside them; None without one."""
    if parent is None:
        return None
    out = _build.BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    srcs = [os.path.join(parent, "grayskull_tpu_torch", "csrc", f) for f in PARENT_SOURCES]
    objs = [out / f.replace(".cu", ".o") for f in PARENT_SOURCES]
    _build._run_all([_build.compile_command(s, o) for s, o in zip(srcs, objs)])
    path = out / "libparent.so"
    _build._run_all([_build.link_command(objs, path)])
    lib = ctypes.CDLL(str(path))
    for name in ("gs_integral", "gs_orb_moments", "gs_orb_brief", "gs_quad_warp",
                 "gs_match_template", "gs_contour"):
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    with open(srcs[PARENT_SOURCES.index("contour.cu")]) as f:
        overrides = older_entries(lib, f.read())
    return WithEntries(lib, _build.library(), overrides)


def device_turns(fn, parent, kernel=None):
    """``fn``'s device ms (``device_ms``, over the kernels whose name holds
    ``kernel``) with the committed kernels and, given a ``parent`` library, with
    its kernels too, in turns (parent, committed, committed, parent, twice):
    (the committed median, the parent's median or None).  Now and then one
    session reads far below the others; a median of four leaves such a reading
    out."""
    if parent is None:
        return device_ms(fn, kernel=kernel), None
    committed = _build.library()
    ours, theirs = [], []
    try:
        for lib in (parent, committed, committed, parent) * 2:
            _build._lib = lib
            (theirs if lib is parent else ours).append(device_ms(fn, kernel=kernel))
    finally:
        _build._lib = committed
    return statistics.median(ours), statistics.median(theirs)


def lena_batch(n, h, w, roll=13):
    """``bench.py``'s frames: lena tiled to h x w, rolled ``roll``*i columns per frame."""
    tile = read_pgm(os.path.join(HERE, "tests", "golden", "testdata", "lena.pgm"))
    if tile is None:
        raise FileNotFoundError("tests/golden/testdata/lena.pgm")
    reps = (-(-h // tile.shape[0]), -(-w // tile.shape[1]))
    frame = np.tile(tile, reps)[:h, :w]
    return np.stack([np.roll(frame, roll * i, axis=1) for i in range(n)])


def otsu_cases(rng):
    """(name, (N, 256) int32 counts, total): random and edge-case histograms."""
    total = 1 << 20
    pvals = rng.dirichlet(np.full(256, 0.3), size=512)
    cases = [("random", rng.multinomial(total, pvals).astype(np.int32), total)]
    one = np.zeros((3, 256), np.int32)
    one[0, 0], one[1, 77], one[2, 255] = 1000, 1000, 1000  # wf == 0 break
    cases.append(("one_bin", one, 1000))
    lead = np.zeros((2, 256), np.int32)
    lead[0, 200:] = 9  # empty leading bins
    lead[1, 120:140] = 7
    lead[1, 250] = 364  # 504 pixels in both rows
    cases.append(("leading_empty", lead, 504))
    tie = np.zeros((2, 256), np.int32)
    tie[0, [10, 20, 30]] = 5  # symmetric: tied variances, first max wins
    tie[1, [0, 255, 128]] = [5, 5, 5]
    cases.append(("ties", tie, 15))
    cases.append(("total_mismatch", cases[0][1][:64], total - 1))  # counts do not sum to total
    for t in (1000, 9, 0):
        cases.append((f"wrap_total_{t}", wrap_histograms(), t))
    cases.append(("all_zero", np.zeros((2, 256), np.int32), 0))
    for n in (1, 8, 33, 65537):  # part of a block, whole blocks and a part, many blocks
        cases.append((f"frames_{n}", np.resize(cases[0][1], (n, 256)), total))
    return cases


def wrap_histograms():
    """Counts whose running weight wraps past 2^32: the bin where it reaches 0
    is skipped though its term is not 0, and the sweep goes on after it."""
    hists = np.zeros((4, 256), np.int64)
    big = 2**31 - 1
    hists[0, [0, 1, 2]] = [big, big, 2]
    hists[1, [0, 1, 2, 100]] = [big, big, 2, 5]
    hists[2, [5, 9, 30, 31, 200]] = [big, big, 1, 1, 7]
    hists[3, [10, 11, 12, 13]] = [big, big, 2, 9]
    return hists.astype(np.int32)


def unaligned(shape, offset, rng, dev):
    """Random frames of ``shape`` that start ``offset`` bytes into a larger buffer."""
    size = int(np.prod(shape))
    flat = torch.from_numpy(rng.integers(0, 256, size + 16, dtype=np.uint8)).to(dev)
    return flat[offset:offset + size].view(shape)


def stencil_frames(rng, dev):
    """(label, frames): SHAPES, EDGE_SHAPES and the unaligned ``[1:]`` of UNALIGNED."""
    for shape in SHAPES + EDGE_SHAPES:
        yield shape, torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    x = torch.from_numpy(rng.integers(0, 256, UNALIGNED, dtype=np.uint8)).to(dev)[1:]
    if not x.is_contiguous() or x.data_ptr() % 16 == 0:
        raise AssertionError("the unaligned batch is aligned or not contiguous")
    yield f"{list(UNALIGNED)}[1:]", x


def phase_kernels(chk, rng, dev):
    for shape, imgs in stencil_frames(rng, dev):
        n, h, w = imgs.shape
        for r in RADII:
            for with_hist in (True, False):
                got = K.blur_hist(imgs, r, with_hist)
                ref = K.blur_hist_plain(imgs, r, with_hist)
                chk.same("blur_hist", got[0], ref[0], f"{shape} r={r} blurred")
                chk.same("blur_hist", got[1], ref[1], f"{shape} r={r} hist")
        blurred, hist = K.blur_hist(imgs, 2)
        t = K.otsu(hist, h * w)
        chk.same("otsu", t, K.otsu_plain(hist, h * w), f"{shape}")
        for thr, want_binary in ((None, True), (t, True), (t, False)):
            got = K.threshold_sobel(blurred, thr, want_binary)
            ref = K.threshold_sobel_plain(blurred, thr, want_binary)
            what = f"{shape} thresholds={thr is not None} want_binary={want_binary}"
            chk.same("threshold_sobel", got[0], ref[0], what + " binary")
            chk.same("threshold_sobel", got[1], ref[1], what + " edges")
        torch.cuda.synchronize()
    for name, hists, total in otsu_cases(rng):
        h = torch.from_numpy(hists).to(dev)
        chk.same("otsu", K.otsu(h, total), K.otsu_plain(h, total), name)
        flat = torch.zeros(h.numel() + 1, dtype=torch.int32, device=dev)
        off = flat[1:].view(h.shape)  # rows 4 bytes past a 16-byte boundary: the 4-byte loads
        off.copy_(h)
        chk.same("otsu", K.otsu(off, total), K.otsu_plain(off, total), f"{name} 4 bytes off")
    torch.cuda.synchronize()
    emit("kernels_vs_plain", ok=True, shapes=[list(s) for s in SHAPES + EDGE_SHAPES],
         unaligned=f"{list(UNALIGNED)}[1:]", radii=list(RADII), checks=chk.checks,
         max_abs_err=chk.max_err)


def phase_main_path(chk, dev):
    lena = torch.from_numpy(lena_batch(MAIN_N, MAIN_H, MAIN_W)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = torch.randint(0, 256, (MAIN_N, MAIN_H, MAIN_W), dtype=torch.uint8, device=dev,
                          generator=gen)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    outs = [gt.preprocess(batch, MAIN_R) for batch in (lena, noise)]
    torch.cuda.synchronize()
    launches = K.launch_counts()
    missing = [name for name in PREPROCESS_KERNELS if launches.get(name, 0) < 1]
    if missing:
        raise AssertionError(f"main path did not launch {missing}: {launches}")
    for batch, out, label in zip((lena, noise), outs, ("lena", "random")):
        ref = gt.preprocess(batch, MAIN_R, force_reference=True)
        for name, a, b in zip(("blurred", "binary", "edges", "thresholds"), out, ref):
            kernel = {"blurred": "blur_hist", "thresholds": "otsu"}.get(name, "threshold_sobel")
            chk.same(kernel, a, b, f"main path {label} {name}")
        if tuple(out[0].shape) != (MAIN_N, MAIN_H, MAIN_W) or tuple(out[3].shape) != (MAIN_N,):
            raise AssertionError(f"main path {label}: wrong output shapes")
    t_lena = outs[0][3]
    emit("main_path", ok=True, frames=MAIN_N, height=MAIN_H, width=MAIN_W, radius=MAIN_R,
         launches=launches, lena_thresholds=sorted(set(t_lena.tolist()))[:8],
         random_thresholds=sorted(set(outs[1][3].tolist()))[:8])

    g = np.load(os.path.join(HERE, "tests", "golden", "goldens.npz"))
    img = torch.from_numpy(g["input"]).to(dev)
    got = {
        "blur2": gt.blur(img, 2), "blur9": gt.blur(img, 9), "sobel": gt.sobel(img),
        "histogram": gt.histogram(img), "otsu": gt.otsu_threshold(img),
        "threshold_100": gt.threshold(img, 100),
    }
    for name, value in got.items():
        want = g[name].astype(np.int64)
        if not np.array_equal(value.cpu().numpy().astype(np.int64), want):
            raise AssertionError(f"golden {name} differs on the card")
    tdir = os.path.join(HERE, "tests", "golden", "testdata")
    pgms = sorted(f for f in os.listdir(tdir) if f.endswith(".pgm"))
    for fn in pgms:
        frame = read_pgm(os.path.join(tdir, fn))
        on_card = gt.preprocess(gt.as_image(frame))  # a host array goes to the card
        on_cpu = gt.preprocess_reference(torch.from_numpy(frame.copy()))
        for name, a, b in zip(("blurred", "binary", "edges", "thresholds"), on_card, on_cpu):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"{fn} {name}: card differs from the plain path on the CPU")
    emit("goldens", ok=True, goldens=sorted(got), pgms=pgms)
    return lena, launches


def phase_timing(batch, card):
    h, w = batch.shape[-2:]
    t_path = timeit(gt.preprocess, batch, MAIN_R)
    t_ref = timeit(gt.preprocess, batch, MAIN_R, force_reference=True, iters=3)
    emit("timing", card=card, metric=METRIC, value=MAIN_N / t_path, unit="frames/sec/card",
         frames=MAIN_N, ms_per_batch=t_path * 1e3,
         plain_path_frames_per_sec=MAIN_N / t_ref, plain_path_ms_per_batch=t_ref * 1e3,
         windows="median of 3 windows of 20 calls (plain path: 3 calls) after 2 warm-up calls")
    blurred, hist = K.blur_hist(batch, MAIN_R)
    t = K.otsu(hist, h * w)
    pairs = {
        "blur_hist": (lambda: K.blur_hist(batch, MAIN_R),
                      lambda: K.blur_hist_plain(batch, MAIN_R)),
        "otsu": (lambda: K.otsu(hist, h * w), lambda: K.otsu_plain(hist, h * w)),
        "threshold_sobel": (lambda: K.threshold_sobel(blurred, t, True),
                            lambda: K.threshold_sobel_plain(blurred, t, True)),
    }
    n, px = batch.shape[0], batch.numel()
    xf = batch.to(torch.float32)[:, None]
    k = 2 * MAIN_R + 1
    pool_ms = timeit(torch.nn.functional.avg_pool2d, xf, k, 1, MAIN_R,
                     count_include_pad=False) * 1e3
    del xf
    # per pixel: K1 4 + 4 running-sum adds, a division, a histogram add; K2 a
    # compare, 11 stencil adds, 2 abs, a shift, a min; K3 about 14 float ops a
    # bin, and a frame's 256 dependent adds of C's order
    cost = {"blur_hist": (2 * px + n * 1024, 10 * px,
                          pool_ms, "avg_pool2d(count_include_pad=False) of the float frames: "
                                   "float mean, no truncation, no histogram"),
            "otsu": (n * 1024 + n, {"fp32": n * 256 * 14, "fadd_chain": 256}, None,
                     "none: no PyTorch call computes Otsu"),
            "threshold_sobel": (3 * px + n, 16 * px, None,
                                "none: no one call gives (|gx|+|gy|)/2 of the binarized frame")}
    times = {}
    for name, (kernel, plain) in pairs.items():
        times[name] = kernel_entry(timeit(kernel) * 1e3, timeit(plain, iters=3) * 1e3,
                                   *cost[name])
        emit("kernel_time", card=card, kernel=name, shape=list(batch.shape), **times[name])
    # K3 is a few microseconds: back-to-back calls can time the host
    one = hist[:1].contiguous()
    k3 = {"device_ms": device_ms(lambda: K.otsu(hist, h * w)),
          "one_frame_device_ms": device_ms(lambda: K.otsu(one, h * w)),
          "one_frame_ms": timeit(K.otsu, one, h * w) * 1e3}
    times["otsu"].update(k3)
    emit("otsu_device_time", card=card, frames=n, event_ms=times["otsu"]["ms"], **k3,
         source="torch.profiler device events over 20 calls after a warm-up call")
    # the standalone ops (blur, sobel) take the same kernels without the histogram or thresholds
    for name, kernel, plain, ops in (
            ("blur_hist without histogram", lambda: K.blur_hist(batch, MAIN_R, False),
             lambda: K.blur_hist_plain(batch, MAIN_R, False), 9 * px),
            ("threshold_sobel without thresholds", lambda: K.threshold_sobel(batch),
             lambda: K.threshold_sobel_plain(batch), 15 * px)):
        emit("kernel_time", card=card, kernel=name, shape=list(batch.shape),
             **kernel_entry(timeit(kernel) * 1e3, timeit(plain, iters=3) * 1e3, 2 * px, ops))
    emit("preprocess_profile", card=card, entry=f"preprocess, {MAIN_N} x 1 MP, r = {MAIN_R}",
         **profile_calls(gt.preprocess, batch, MAIN_R))
    emit("memory", card=card, peak_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    return times


def synthetic_cascade():
    """``tests/test_lbp.py``'s 8x8 cascade: 3 features, 4 weaks, a back-loaded stage split."""
    rng = np.random.default_rng(5)
    nweaks = 4
    return LbpCascade(
        window_w=8, window_h=8,
        features=np.array([[0, 0, 2, 2], [1, 1, 2, 2], [2, 0, 1, 2]], np.int8),
        weak_feature_idx=np.array([0, 2, 1, 0], np.uint16),
        weak_left_val=rng.uniform(-1, 0, nweaks).astype(np.float32),
        weak_right_val=rng.uniform(0, 1, nweaks).astype(np.float32),
        weak_subset_offset=np.arange(0, 8 * nweaks, 8, dtype=np.uint16),
        weak_num_subsets=np.full(nweaks, 8, np.uint16),
        subsets=rng.integers(-2**31, 2**31, 8 * nweaks, dtype=np.int64).astype(np.int32),
        stage_weak_start=np.array([0, 1], np.uint16),
        stage_nweaks=np.array([1, 3], np.uint16),
        stage_threshold=np.array([-0.2, 0.1], np.float32),
    )


def uniform_cascade(cascade, threshold):
    """``cascade`` with every stage threshold set to ``threshold``."""
    return dataclasses.replace(cascade, stage_threshold=np.full(cascade.nstages, threshold,
                                                                np.float32))


def first_stages(cascade, s):
    """``cascade`` cut to its first ``s`` stages."""
    return dataclasses.replace(cascade, stage_weak_start=cascade.stage_weak_start[:s],
                               stage_nweaks=cascade.stage_nweaks[:s],
                               stage_threshold=cascade.stage_threshold[:s])


def faces_args(cascade):
    return (cascade, FACES_CAP, *LADDER, FACES_STEP)


def phase_faces_kernels(chk, rng, dev):
    for shape in INTEGRAL_SHAPES:
        if shape == INTEGRAL_SHAPES[-1]:
            imgs = torch.full(shape, 255, dtype=torch.uint8, device=dev)
        else:
            imgs = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        got = K.integral(imgs)
        chk.same("integral", got, K.integral_plain(imgs), f"{shape}")
    wrap_corner = int(u32_to_int64(got[0, -1, -1]))
    if wrap_corner != (255 * 4200 * 4200) % 2**32:
        raise AssertionError(f"integral of the 255 frame ends in {wrap_corner}")
    for shape in INTEGRAL_EDGE_SHAPES:
        imgs = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        chk.same("integral", K.integral(imgs), K.integral_plain(imgs), f"{shape}")
    for shape in INTEGRAL_UNALIGNED:
        for off in (1, 2, 3, 4):
            imgs = unaligned(shape, off, rng, dev)
            chk.same("integral", K.integral(imgs), K.integral_plain(imgs), f"{shape} offset {off}")
    odd = torch.from_numpy(lena_batch(FACES_N + 1, FACES_H - 1, FACES_W - 1)).to(dev)[1:]
    chk.same("integral", K.integral(odd), K.integral_plain(odd), "[1:] of 33 frames of 479x639")

    cascade = gt.load_frontalface()
    ii = K.integral(torch.from_numpy(lena_batch(2, FACES_H, FACES_W, roll=7)).to(dev))
    hits = {}
    for step in (1, 2, 3):
        for scale, _, _, ny, nx in _grid_plan(cascade, FACES_H, FACES_W, *LADDER, step):
            got = K.lbp_eval_scale(cascade, ii, scale, ny, nx, step)
            chk.same("lbp_eval_scale", got,
                     K.lbp_eval_scale_plain(cascade, ii, scale, ny, nx, step),
                     f"640x480 scale={scale} step={step}")
            hits[f"step{step}"] = hits.get(f"step{step}", 0) + int(got.sum())
    for y, x in ((0, 0), (20, 10), (200, 300), (FACES_H - 24, FACES_W - 24)):
        chk.same("lbp_eval_scale", K.lbp_eval_scale(cascade, ii, 1.0, 1, 1, 1, (y, x)),
                 K.lbp_eval_scale_plain(cascade, ii, 1.0, 1, 1, 1, (y, x)), f"window ({y}, {x})")

    # the four corner windows of the first and the last ladder scale, through lbp_window
    plan = _grid_plan(cascade, FACES_H, FACES_W, *LADDER, 1)
    for scale, win_w, win_h, _, _ in (plan[0], plan[-1]):
        for y, x in ((0, 0), (0, FACES_W - win_w), (FACES_H - win_h, 0),
                     (FACES_H - win_h, FACES_W - win_w)):
            chk.same("lbp_eval_scale", gt.lbp_window(cascade, ii[1], x, y, scale),
                     gt.lbp_window(cascade, ii[1].cpu(), x, y, scale).to(dev),
                     f"lbp_window scale={scale} ({y}, {x})")
    # every window passes every stage (full queues), or fails stage 0 (empty queues)
    cases = {"all pass": uniform_cascade(cascade, -np.inf), "all fail": uniform_cascade(cascade, np.inf)}
    for name, cas in cases.items():
        for scale, _, _, ny, nx in plan:
            got = K.lbp_eval_scale(cas, ii, scale, ny, nx, 1)
            chk.same("lbp_eval_scale", got, K.lbp_eval_scale_plain(cas, ii, scale, ny, nx, 1),
                     f"{name} scale={scale}")
            if bool(got.all()) != (name == "all pass") or bool(got.any()) != (name == "all pass"):
                raise AssertionError(f"lbp_eval_scale {name} scale={scale}: wrong hits")
    # a frame smaller than one tile, and 97x200 at steps 1-3
    for shape, steps in (((2, 30, 40), (1,)), ((2, 97, 200), (1, 2, 3))):
        small = K.integral(torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev))
        for step in steps:
            for scale, _, _, ny, nx in _grid_plan(cascade, *shape[1:], *LADDER, step):
                chk.same("lbp_eval_scale", K.lbp_eval_scale(cascade, small, scale, ny, nx, step),
                         K.lbp_eval_scale_plain(cascade, small, scale, ny, nx, step),
                         f"{shape} scale={scale} step={step}")

    syn = synthetic_cascade()
    sii = K.integral(torch.from_numpy(rng.integers(0, 256, (2, 40, 256), dtype=np.uint8)).to(dev))
    for scale in (1.0, 1.5):
        win = int(np.float32(8) * np.float32(scale))
        for step in (1, 2):
            ny, nx = (40 - win) // step + 1, (256 - win) // step + 1
            chk.same("lbp_eval_scale", K.lbp_eval_scale(syn, sii, scale, ny, nx, step),
                     K.lbp_eval_scale_plain(syn, sii, scale, ny, nx, step),
                     f"synthetic scale={scale} step={step}")
    torch.cuda.synchronize()
    emit("faces_kernels_vs_plain", ok=True, integral_shapes=[list(s) for s in INTEGRAL_SHAPES],
         integral_edge_shapes=[list(s) for s in INTEGRAL_EDGE_SHAPES],
         integral_unaligned=[[list(s), "offsets 1-4"] for s in INTEGRAL_UNALIGNED]
         + [[FACES_N, FACES_H - 1, FACES_W - 1], "[1:] of a batch"],
         wrap_corner=wrap_corner, lena_hits=hits,
         edge_cases=["lbp_window at the four corners of the first and last scale",
                     "all pass", "all fail at stage 0", "2x30x40", "2x97x200 steps 1-3"],
         checks={k: chk.checks[k] for k in FACES_KERNELS},
         max_abs_err={k: chk.max_err[k] for k in FACES_KERNELS})


def phase_faces_path(chk, dev):
    cascade = gt.load_frontalface()
    batch = torch.from_numpy(lena_batch(FACES_N, FACES_H, FACES_W, roll=7)).to(dev)
    warm_s = gt.pipelines.warm_start(FACES_H, FACES_W, FACES_N, *faces_args(cascade))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    out = gt.detect_faces(batch, *faces_args(cascade))
    torch.cuda.synchronize()
    launches = K.launch_counts()
    missing = [name for name in FACES_KERNELS if launches.get(name, 0) < 1]
    if missing:
        raise AssertionError(f"faces path did not launch {missing}: {launches}")
    if tuple(out.n.shape) != (FACES_N,) or tuple(out.x.shape) != (FACES_N, FACES_CAP):
        raise AssertionError(f"faces path: wrong table shapes {tuple(out.x.shape)}")
    # the tables keep 100 rects per frame; hold every hit mask of the ladder to the plain version
    ii = K.integral(batch)
    plan = _grid_plan(cascade, FACES_H, FACES_W, *LADDER, FACES_STEP)
    windows_hit = 0
    for scale, _, _, ny, nx in plan:
        got = K.lbp_eval_scale(cascade, ii, scale, ny, nx, FACES_STEP)
        chk.same("lbp_eval_scale", got,
                 K.lbp_eval_scale_plain(cascade, ii, scale, ny, nx, FACES_STEP),
                 f"faces path {FACES_N}-frame integral scale={scale}")
        windows_hit += int(got.sum())
    ref = gt.detect_faces(batch, *faces_args(cascade), force_reference=True)
    for name, a, b in zip(gt.Rects._fields, out, ref):
        chk.same("lbp_eval_scale", a, b, f"faces path {name} vs plain path")
    rows = [0, FACES_N - 1]
    on_cpu = gt.detect_faces(batch[rows].cpu(), *faces_args(cascade))
    for name, a, b in zip(gt.Rects._fields, out, on_cpu):
        if not torch.equal(a[rows].cpu(), b):
            raise AssertionError(f"faces path {name}: card differs from the plain path on the CPU")
    valid = torch.arange(FACES_CAP, device=dev)[None, :] < out.n[:, None]
    inside = (out.x + out.w <= FACES_W) & (out.y + out.h <= FACES_H) & (out.w >= 24)
    if not bool((inside | ~valid).all()) or bool((out.x.masked_fill(valid, 0) != 0).any()):
        raise AssertionError("faces path: a rect lies outside the frame or a padded row is not 0")

    g = np.load(os.path.join(HERE, "tests", "golden", "goldens.npz"))
    if not np.array_equal(gt.integral(torch.from_numpy(g["input"]).to(dev)).cpu().numpy(),
                          g["integral"]):
        raise AssertionError("golden integral differs on the card")
    for step in (1, 2, 3):
        key = "lbp_rects" if step == 1 else f"lbp_rects_step{step}"
        r = gt.detect_faces(torch.from_numpy(g["lbp_input"]).to(dev), cascade, 50, *LADDER, step)
        n = int(r.n)
        got = np.stack([v[:n].cpu().numpy() for v in (r.x, r.y, r.w, r.h)], axis=1)
        if not np.array_equal(got, g[key].astype(np.int64).reshape(-1, 4)):
            raise AssertionError(f"golden {key} differs on the card")
    emit("faces_path", ok=True, frames=FACES_N, height=FACES_H, width=FACES_W, step=FACES_STEP,
         max_rects=FACES_CAP, warm_start_seconds=warm_s, launches=launches,
         hit_masks_checked=len(plan), windows_hit=windows_hit, detections=out.n.tolist(),
         first_rect=[int(v[0, 0]) for v in out[1:]],
         goldens=["integral", "lbp_rects", "lbp_rects_step2", "lbp_rects_step3"])
    return batch, launches


def phase_faces_work(batch):
    """K5's real work: the plain version on frames 0 and 31 of the faces batch
    with the cascade cut to its first s stages, s = 1 .. nstages, gives each
    window's exit stage (the stages it passed) and so the weaks it runs.  Per
    scale: the exit-stage counts, the mean weaks a window, the divergence factor
    (the mean over groups of 32 windows along x of max / mean weaks) and the
    warp-weaks a thread per window and 64x32 tiles compacted per stage pay."""
    cascade = gt.load_frontalface()
    frames = [0, FACES_N - 1]
    ii = K.integral(batch[frames])
    nst = cascade.nstages
    nweaks = cascade.stage_nweaks.astype(np.int64)
    cum = torch.from_numpy(np.concatenate([[0], np.cumsum(nweaks)])).to(batch.device)
    cuts = [first_stages(cascade, s) for s in range(1, nst + 1)]
    scales, total = [], 0
    for scale, _, _, ny, nx in _grid_plan(cascade, FACES_H, FACES_W, *LADDER, FACES_STEP):
        passed = sum(K.lbp_eval_scale_plain(c, ii, scale, ny, nx, FACES_STEP).to(torch.int64)
                     for c in cuts)
        weaks = cum[(passed + 1).clamp(max=nst)].cpu().numpy()
        p = passed.cpu().numpy()
        groups, pad = -(-nx // 32), -nx % 32
        wmax = np.pad(weaks, ((0, 0), (0, 0), (0, pad)), constant_values=-1).reshape(
            len(frames), ny, groups, 32).max(-1)
        wsum = np.pad(weaks, ((0, 0), (0, 0), (0, pad))).reshape(len(frames), ny, groups, 32).sum(-1)
        count = np.full(groups, 32)
        count[-1] = 32 - pad
        tiles = np.pad(p, ((0, 0), (0, -ny % 32), (0, -nx % 64)), constant_values=-1).reshape(
            len(frames), -(-ny // 32), 32, -(-nx // 64), 64)
        compacted = sum(int((-(-(tiles >= s).sum(axis=(2, 4)) // 32)).sum()) * int(nweaks[s])
                        for s in range(nst))
        total += int(weaks.sum())
        scales.append({"scale": scale, "ny": ny, "nx": nx, "windows": int(weaks.size),
                       "exit_stage_counts": np.bincount(p.reshape(-1), minlength=nst + 1).tolist(),
                       "mean_weaks": float(weaks.mean()),
                       "divergence_factor": float((wmax / (wsum / count)).mean()),
                       "warp_weaks_thread_per_window": int(wmax.sum()),
                       "warp_weaks_compacted_64x32": compacted})
    torch.cuda.synchronize()
    work = {"frames": frames, "weaks": total, "weaks_per_batch": total * FACES_N // len(frames),
            "scales": scales}
    emit("faces_k5_work", **work,
         note="exit_stage_counts[s]: windows that passed s stages (the last entry: all of them); "
              "weaks_per_batch scales the two frames' weaks to the 32 frames")
    return work


def phase_faces_timing(batch, card, work, parent=None):
    cascade = gt.load_frontalface()
    plan = _grid_plan(cascade, FACES_H, FACES_W, *LADDER, FACES_STEP)
    nwin = sum(ny * nx for *_, ny, nx in plan)
    t_path = timeit(gt.detect_faces, batch, *faces_args(cascade))
    t_ref = timeit(gt.detect_faces, batch, *faces_args(cascade), force_reference=True,
                   iters=1, warmup=1, repeat=1)
    emit("faces_timing", card=card, metric=FACES_METRIC, value=FACES_N * nwin / t_path,
         unit="windows/sec/card", lbp_640x480_fps=FACES_N / t_path, frames=FACES_N,
         windows_per_frame=nwin, scales=len(plan), ms_per_batch=t_path * 1e3,
         plain_path_windows_per_sec=FACES_N * nwin / t_ref, plain_path_fps=FACES_N / t_ref,
         plain_path_ms_per_batch=t_ref * 1e3,
         windows="median of 3 windows of 20 calls (plain path: 1 call) after 2 warm-up calls "
                 "(plain path: 1)")
    ii = K.integral(batch)

    def k5(evaluate):
        return [evaluate(cascade, ii, scale, ny, nx, FACES_STEP) for scale, _, _, ny, nx in plan]

    px = batch.numel()
    # K5 reads the integral once a scale and writes a hit a window; a weak is
    # about 40 operations: 38 INT32 (16 corner addresses, 9 block sums, 8
    # compares, the subset test) and 2 FP32 (the leaf's add, the stage test),
    # counted over the weaks this batch's windows run (from phase_faces_work)
    # and, beside it, over stage 0 alone
    stage0 = int(cascade.stage_nweaks[0])

    def weak_ops(weaks):
        return {"int32": 38 * weaks, "fp32": 2 * weaks}
    times = {
        "integral": kernel_entry(timeit(K.integral, batch) * 1e3,
                                 timeit(K.integral_plain, batch, iters=3) * 1e3,
                                 5 * px, 2 * px, None,
                                 "none: a 2-D prefix sum is two cumsum calls"),
        "lbp_eval_scale": kernel_entry(
            timeit(k5, K.lbp_eval_scale) * 1e3,
            timeit(k5, K.lbp_eval_scale_plain, iters=1, warmup=1, repeat=1) * 1e3,
            len(plan) * 4 * px + FACES_N * nwin, weak_ops(work["weaks_per_batch"]), None,
            "none: no PyTorch call evaluates an LBP cascade"),
    }
    times["lbp_eval_scale"]["bound_ms_stage0"] = ops_ms(weak_ops(FACES_N * nwin * stage0))
    # K4 by the profiler, against the parent's in turns when given; two cumsum
    # calls as a yardstick (no one PyTorch call computes the 2-D prefix sum)
    ii_ms, ii_parent_ms = device_turns(lambda: K.integral(batch), parent)

    def two_cumsums():
        return torch.cumsum(torch.cumsum(batch, -1, dtype=torch.int32), -2)
    times["integral"].update(
        device_ms=ii_ms, parent_device_ms=ii_parent_ms,
        two_call_yardstick_ms=timeit(two_cumsums) * 1e3,
        two_call_yardstick_device_ms=device_ms(two_cumsums),
        two_call_yardstick="torch.cumsum(torch.cumsum(x, -1, dtype=torch.int32), -2): two "
                           "calls, int32, not the one-call library_ms")
    # the same launches with the cascade cut to stage 0: the fixed part and stage 0
    cut = first_stages(cascade, 1)
    times["lbp_eval_scale"]["stage0_only_ms"] = timeit(
        lambda: [K.lbp_eval_scale(cut, ii, scale, ny, nx, FACES_STEP)
                 for scale, _, _, ny, nx in plan]) * 1e3
    for name, entry in times.items():
        emit("kernel_time", card=card, kernel=name, shape=list(batch.shape), **entry,
             **({"summed_over_scales": len(plan)} if name == "lbp_eval_scale" else {}))
    emit("faces_profile", card=card, entry=f"detect_faces, {FACES_N} x 640x480, step 1",
         **profile_calls(gt.detect_faces, batch, *faces_args(cascade)))
    emit("memory", card=card, peak_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    return times


def _aruco():
    frame = read_pgm(os.path.join(HERE, "tests", "golden", "testdata", "aruco.pgm"))
    if frame is None:
        raise FileNotFoundError("tests/golden/testdata/aruco.pgm")
    return frame.copy()  # writable, for torch.from_numpy


def fast_frames(shape, rng):
    """(name, frames): random bytes, tiled lena, a period-2 checkerboard (every
    corner ties) and a dark frame (p < thr: C's unsigned p - thr wraps)."""
    n, h, w = shape
    checker = (np.indices((h, w)).sum(0) % 2 * 255).astype(np.uint8)
    return [("random", rng.integers(0, 256, shape, dtype=np.uint8)),
            ("lena", lena_batch(n, h, w, roll=5)),
            ("checker", np.broadcast_to(checker, shape).copy()),
            ("dark", rng.integers(0, 4, shape, dtype=np.uint8))]


def keypoint_cases(rng, h, w, k_random):
    """(N=2, K) int32 coordinates: tests/test_features.py's edge and corner
    keypoints, some outside the frame, then random ones; the second frame's in reverse."""
    edge = [(0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1), (w // 2, 0), (0, h // 2),
            (w - 1, h // 2), (w // 2, h - 1), (19, 19), (20, 20), (w - 20, h - 20),
            (-30, -25), (-10, 40), (w + 4, h + 30), (w + 60, -1), (5, h + 2)]
    xs = np.array([p[0] for p in edge] + rng.integers(0, w, k_random).tolist(), np.int32)
    ys = np.array([p[1] for p in edge] + rng.integers(0, h, k_random).tolist(), np.int32)
    return np.stack([xs, xs[::-1]]), np.stack([ys, ys[::-1]])


def large_keypoint_set(rng, xs, ys, h, w, k):
    """(2, k) int32 coordinates on ``xs``/``ys``'s device: ``xs``/``ys`` first,
    then random keypoints, a third with the whole r = 20 disc in an h x w frame
    and the rest anywhere from 25 pixels before the frame to 25 past it."""
    more = k - xs.shape[1]
    inner = more // 3
    def coords(size, lo, hi):
        return np.concatenate([rng.integers(20, size - 20, (2, inner)),
                               rng.integers(lo, hi, (2, more - inner))], 1).astype(np.int32)
    return (torch.cat([xs, torch.from_numpy(coords(w, -25, w + 25)).to(xs.device)], 1).contiguous(),
            torch.cat([ys, torch.from_numpy(coords(h, -25, h + 25)).to(ys.device)], 1).contiguous())


def phase_orb_kernels(chk, rng, dev):
    for shape in FAST_SHAPES:
        for name, frames in fast_frames(shape, rng):
            imgs = torch.from_numpy(frames).to(dev)
            for thr in FAST_THRESHOLDS:
                got, ref = K.fast(imgs, thr, True), K.fast_plain(imgs, thr, True)
                chk.same("fast", got[0], ref[0], f"{shape} {name} thr={thr} score")
                chk.same("fast", got[1], ref[1], f"{shape} {name} thr={thr} key")
            chk.same("fast", K.fast(imgs, 20)[1], K.fast_plain(imgs, 20)[1],
                     f"{shape} {name} key only")
            torch.cuda.synchronize()
    wide = K.fast(imgs, 0)[1]  # the last shape's dark frame
    if wide.dtype != torch.int64:
        raise AssertionError(f"fast on {FAST_SHAPES[-1]}: keys are {wide.dtype}, not int64")
    edges = [(shape, frames) for shape in FAST_EDGE_SHAPES for frames in fast_frames(shape, rng)]
    edges += [((FAST_UNALIGNED, f"offset {off}"), ("random", unaligned(FAST_UNALIGNED, off, rng, dev)))
              for off in range(1, 16)]
    edges.append((((1, 2900, 2900), "offset 3"), ("random", unaligned((1, 2900, 2900), 3, rng, dev))))
    for shape, (name, frames) in edges:
        imgs = frames if isinstance(frames, torch.Tensor) else torch.from_numpy(frames).to(dev)
        for thr in FAST_EDGE_THRESHOLDS:
            got, ref = K.fast(imgs, thr, True), K.fast_plain(imgs, thr, True)
            chk.same("fast", got[0], ref[0], f"{shape} {name} thr={thr} score")
            chk.same("fast", got[1], ref[1], f"{shape} {name} thr={thr} key")
            chk.same("fast", K.fast(imgs, thr)[1], ref[1], f"{shape} {name} thr={thr} key only")
        torch.cuda.synchronize()

    h, w = 64, 200
    imgs = torch.from_numpy(rng.integers(0, 256, (2, h, w), dtype=np.uint8)).to(dev)
    xs, ys = (torch.from_numpy(np.ascontiguousarray(c)).to(dev)
              for c in keypoint_cases(rng, h, w, 112))
    k = xs.shape[1]
    special = np.float32([0.0, np.pi, -np.pi, np.float32(np.pi), -np.float32(np.pi),
                          np.pi / 2, -np.pi / 2])
    angles = np.concatenate([special, rng.uniform(-np.pi, np.pi, k - len(special))])
    angles = torch.from_numpy(np.stack([angles, angles[::-1]]).astype(np.float32)).to(dev)
    sin, cos = libm32.sinf(angles), libm32.cosf_like_reference(angles)
    for r in (15, 0, 1, 7, 20):
        for a, b, what in zip(K.orb_moments(imgs, xs, ys, r), K.orb_moments_plain(imgs, xs, ys, r),
                              ("m01", "m10")):
            chk.same("orb_moments", a, b, f"edge keypoints r={r} {what}")
    # K7's words: keypoints at every x mod 4, on frames of an odd width (every
    # row misalignment), inside the frame and at its edges
    odd = torch.from_numpy(rng.integers(0, 256, (2, 61, 203), dtype=np.uint8)).to(dev)
    mx, my = (torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in keypoint_cases(rng, 61, 203, 4))
    mod = torch.arange(24, 40, dtype=torch.int32, device=dev)
    mx = torch.cat([mx, torch.stack([mod, mod + 140])], 1).contiguous()
    my = torch.cat([my, torch.stack([mod % 5 + 25, mod % 7 + 21])], 1).contiguous()
    for r in (0, 1, 15, 20):
        for a, b, what in zip(K.orb_moments(odd, mx, my, r), K.orb_moments_plain(odd, mx, my, r),
                              ("m01", "m10")):
            chk.same("orb_moments", a, b, f"every x mod 4, width 203, r={r} {what}")
    # a call with a 1024-thread block for every SM takes K7's other instance
    # (weights from the block's shared table): the same keypoints, then 2 x
    # 2,464 more, a third with the whole r = 20 disc inside, the rest anywhere
    lx, ly = large_keypoint_set(rng, mx, my, 61, 203, 2500)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if lx.numel() < sms * 32:
        raise AssertionError(f"{lx.numel()} keypoints do not give {sms} SMs a 1024-thread block")
    for r in (0, 1, 15, 20):
        for a, b, what in zip(K.orb_moments(odd, lx, ly, r), K.orb_moments_plain(odd, lx, ly, r),
                              ("m01", "m10")):
            chk.same("orb_moments", a, b, f"{lx.numel()} keypoints, width 203, r={r} {what}")
    chk.same("orb_brief", K.orb_brief(imgs, xs, ys, sin, cos),
             K.orb_brief_plain(imgs, xs, ys, sin, cos), "edge keypoints")
    # K8's window: every x mod 4 and every row misalignment (width 203, batches
    # that start 1 .. 3 bytes into their buffer), at, near and past the borders
    ma = np.concatenate([special, rng.uniform(-np.pi, np.pi, mx.shape[1] - len(special))])
    ma = torch.from_numpy(np.stack([ma, ma[::-1]]).astype(np.float32)).to(dev)
    ms, mc = libm32.sinf(ma), libm32.cosf_like_reference(ma)
    for off in (0, 1, 2, 3):
        frames = unaligned((2, 61, 203), off, rng, dev) if off else odd
        chk.same("orb_brief", K.orb_brief(frames, mx, my, ms, mc),
                 K.orb_brief_plain(frames, mx, my, ms, mc),
                 f"every x mod 4, width 203, offset {off}")
    # sin and cos off the unit circle: endpoints outside the 41 x 41 window read
    # as the 48 x 48 patch does
    scale = torch.tensor([1.0, 1.45, 0.5, 1.02], device=dev).repeat(k // 4 + 1)[:k]
    chk.same("orb_brief", K.orb_brief(imgs, xs, ys, sin * scale, cos * scale.flip(0)),
             K.orb_brief_plain(imgs, xs, ys, sin * scale, cos * scale.flip(0)),
             "sin and cos off the unit circle")
    # a call past the grid's cap: warps walk over more than one keypoint
    la = torch.from_numpy(rng.uniform(-np.pi, np.pi, (2, 2500)).astype(np.float32)).to(dev)
    bx, by = large_keypoint_set(rng, mx, my, 61, 203, 2500)
    chk.same("orb_brief", K.orb_brief(odd, bx, by, libm32.sinf(la), libm32.cosf_like_reference(la)),
             K.orb_brief_plain(odd, bx, by, libm32.sinf(la), libm32.cosf_like_reference(la)),
             f"{bx.numel()} keypoints, width 203")
    # the main path's shapes: 16 frames of 640x480, their 500 keypoints and real angles
    batch = torch.from_numpy(lena_batch(ORB_N, ORB_H, ORB_W, roll=5)).to(dev)
    kps = gt.orb_extract(batch, ORB_CAP, ORB_THR)
    sx, sy = kps.x.clamp(15, ORB_W - 16), kps.y.clamp(15, ORB_H - 16)
    for a, b, what in zip(K.orb_moments(batch, sx, sy), K.orb_moments_plain(batch, sx, sy),
                          ("m01", "m10")):
        chk.same("orb_moments", a, b, f"16x640x480 {what}")
    sin, cos = libm32.sinf(kps.angle), libm32.cosf_like_reference(kps.angle)
    chk.same("orb_brief", K.orb_brief(batch, sx, sy, sin, cos),
             K.orb_brief_plain(batch, sx, sy, sin, cos), "16x640x480")
    torch.cuda.synchronize()
    emit("orb_kernels_vs_plain", ok=True, fast_shapes=[list(s) for s in FAST_SHAPES],
         thresholds=list(FAST_THRESHOLDS), frames=["random", "lena", "checker", "dark"],
         fast_edge_shapes=[list(s) for s in FAST_EDGE_SHAPES],
         fast_unaligned=[list(FAST_UNALIGNED), "offsets 1-15"], fast_wide_unaligned=[1, 2900, 2900],
         fast_edge_thresholds=list(FAST_EDGE_THRESHOLDS),
         wide_key_keypoints=int((wide != 0).sum()),
         checks={k: chk.checks[k] for k in ORB_KERNELS},
         max_abs_err={k: chk.max_err[k] for k in ORB_KERNELS})


def track_pair(a, b):
    """``benchmarks/bench_all.py:191-212``: one batch-2 ``orb_extract``, then ``match_orb``."""
    ks = gt.orb_extract(torch.stack([a, b]), ORB_CAP, ORB_THR)
    k1, k2 = (gt.Keypoints(*(v[i] for v in ks)) for i in (0, 1))
    return k1, k2, gt.match_orb(k1, k2, PAIR_CAP, PAIR_DIST)


def _table_bits(table):
    """A table's fields, the float32 angle as its int32 bits."""
    return [v.view(torch.int32) if v.dtype == torch.float32 else v for v in table]


def _same_tables(chk, got, ref, what):
    owner = {"angle": "orb_moments", "descriptor": "orb_brief"}
    for name, a, b in zip(got._fields, _table_bits(got), _table_bits(ref)):
        chk.same(owner.get(name, "fast"), a, b, f"{what} {name}")


def _equal_on_cpu(got, ref, what):
    for name, a, b in zip(got._fields, _table_bits(got), _table_bits(ref)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"{what} {name}: card differs from the plain path on the CPU")


def _launched(kernels, fn, *args):
    """``fn(*args)`` with the counts reset just before and read just after, and
    PyTorch's sync debug mode raising on any host sync inside it; fails unless
    every kernel named in ``kernels`` launched."""
    torch.cuda.synchronize()
    K.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = K.launch_counts()
    missing = [name for name in kernels if launches.get(name, 0) < 1]
    if missing:
        raise AssertionError(f"{fn.__name__} did not launch {missing}: {launches}")
    return out, launches


def phase_orb_path(chk, dev):
    batch = torch.from_numpy(lena_batch(ORB_N, ORB_H, ORB_W, roll=5)).to(dev)
    aruco = _aruco()
    scene = torch.from_numpy(aruco).to(dev)
    tmpl = torch.from_numpy(aruco[100:350, 150:450].copy()).to(dev)
    shifted = torch.from_numpy(np.roll(aruco, 9, axis=1)).to(dev)
    kps, l_extract = _launched(ORB_KERNELS, gt.orb_extract, batch, ORB_CAP, ORB_THR)
    tracked, l_track = _launched(ORB_KERNELS, gt.track, tmpl, scene, TRACK_KPS)
    paired, l_pair = _launched(ORB_KERNELS, track_pair, scene, shifted)
    launches = {name: l_extract[name] + l_track[name] + l_pair[name] for name in KERNELS}

    _same_tables(chk, kps, gt.orb_extract(batch, ORB_CAP, ORB_THR, force_reference=True),
                 "orb_extract 16 frames")
    for got, ref, what in zip(tracked, gt.track(tmpl, scene, TRACK_KPS, force_reference=True),
                              ("template", "scene", "matches")):
        _same_tables(chk, got, ref, f"track {what}")
    ref_pair = gt.orb_extract(torch.stack([scene, shifted]), ORB_CAP, ORB_THR,
                              force_reference=True)
    _same_tables(chk, paired[0], gt.Keypoints(*(v[0] for v in ref_pair)), "pair frame 0")
    _same_tables(chk, paired[1], gt.Keypoints(*(v[1] for v in ref_pair)), "pair frame 1")
    n = kps.n.tolist()
    if tuple(kps.descriptor.shape) != (ORB_N, ORB_CAP, 8) or min(n) < 1:
        raise AssertionError(f"orb_extract: shapes {tuple(kps.descriptor.shape)}, counts {n}")
    if int(paired[2].n) >= PAIR_CAP or int(tracked[2].n) < 1:
        raise AssertionError("track: the match table saturated or is empty")

    rows = [0, ORB_N - 1]
    # fast trig: CUDA's float64 atan2 is not glibc's, so angles may differ; information only
    on_cpu = gt.orb_extract(batch[rows].cpu(), ORB_CAP, ORB_THR)
    fast_mode_angle_diffs = int((kps.angle[rows].cpu().view(torch.int32)
                                 != on_cpu.angle.view(torch.int32)).sum())
    libm32.use_exact_host_libm(True)
    try:
        _equal_on_cpu(gt.orb_extract(batch[rows], ORB_CAP, ORB_THR),
                      gt.orb_extract(batch[rows].cpu(), ORB_CAP, ORB_THR), "exact_host orb_extract")
        for got, ref, what in zip(gt.track(tmpl, scene, TRACK_KPS),
                                  gt.track(tmpl.cpu(), scene.cpu(), TRACK_KPS),
                                  ("template", "scene", "matches")):
            _equal_on_cpu(got, ref, f"exact_host track {what}")
    finally:
        libm32.use_exact_host_libm(False)

    g = np.load(os.path.join(HERE, "tests", "golden", "goldens.npz"))
    fk, score = gt.fast(torch.from_numpy(g["input"]).to(dev), 500, 15)
    nf = int(fk.n)
    xy = torch.stack([fk.x[:nf], fk.y[:nf]], 1).cpu().numpy()
    if (not np.array_equal(score.cpu().numpy(), g["fast_scoremap"])
            or not np.array_equal(xy, g["fast_xy"].astype(np.int64))
            or not np.array_equal(fk.response[:nf].cpu().numpy(), g["fast_response"].astype(np.int64))):
        raise AssertionError("golden fast_* differs on the card")

    def table(desc):
        d = torch.from_numpy(desc.astype(np.uint32)).to(dev)
        z = torch.zeros(len(desc), dtype=torch.int32, device=dev)
        return gt.Keypoints(torch.tensor(len(desc), dtype=torch.int32, device=dev), z, z, z,
                            z.to(torch.float32), d)

    for key, md in (("match_orb_64", 64.0), ("match_orb_200", 200.0)):
        m = gt.match_orb(table(g["match_d1"]), table(g["match_d2"]), 100, md)
        nm = int(m.n)
        got = torch.stack([m.idx1[:nm], m.idx2[:nm], m.distance[:nm]], 1).cpu().numpy()
        if not np.array_equal(got, g[key].astype(np.int64)):
            raise AssertionError(f"golden {key} differs on the card")
    emit("orb_path", ok=True, frames=ORB_N, height=ORB_H, width=ORB_W, max_kps=ORB_CAP,
         threshold=ORB_THR, launches=launches, launches_orb_extract=l_extract,
         launches_track=l_track, launches_track_pair=l_pair, keypoints=n,
         track_keypoints=[int(tracked[0].n), int(tracked[1].n)], track_matches=int(tracked[2].n),
         pair_keypoints=[int(paired[0].n), int(paired[1].n)], pair_matches=int(paired[2].n),
         fast_mode_angles_card_vs_cpu_differ=fast_mode_angle_diffs,
         fast_mode_angles_compared=int(kps.n[rows].sum()),
         exact_host_vs_cpu=["orb_extract frames 0 and 15", "track aruco"],
         goldens=["fast_scoremap", "fast_xy", "fast_response", "match_orb_64", "match_orb_200"])
    return (batch, tmpl, scene, shifted), launches


def phase_orb_timing(frames, card):
    batch, tmpl, scene, shifted = frames
    keypoints = int(gt.orb_extract(batch, ORB_CAP, ORB_THR).n.sum())
    t_path = timeit(gt.orb_extract, batch, ORB_CAP, ORB_THR)
    t_ref = timeit(gt.orb_extract, batch, ORB_CAP, ORB_THR, force_reference=True, iters=3)
    t_pair = timeit(track_pair, scene, shifted)
    t_track = timeit(gt.track, tmpl, scene, TRACK_KPS)
    t_track_ref = timeit(gt.track, tmpl, scene, TRACK_KPS, force_reference=True, iters=3)
    emit("orb_timing", card=card, metric="orb_keypoints_per_sec", value=keypoints / t_path,
         unit="keypoints/sec/card", keypoints_per_call=keypoints, frames=ORB_N,
         ms_per_batch=t_path * 1e3, plain_path_keypoints_per_sec=keypoints / t_ref,
         plain_path_ms_per_batch=t_ref * 1e3, orb_track_pair_fps=1 / t_pair,
         track_pair_ms=t_pair * 1e3, track_aruco_ms=t_track * 1e3,
         plain_track_aruco_ms=t_track_ref * 1e3,
         windows="median of 3 windows of 20 calls (plain path: 3 calls) after 2 warm-up calls")
    kps = gt.orb_extract(batch, ORB_CAP, ORB_THR)
    sx, sy = kps.x.clamp(15, ORB_W - 16), kps.y.clamp(15, ORB_H - 16)
    sin, cos = libm32.sinf(kps.angle), libm32.cosf_like_reference(kps.angle)
    pairs = {
        "fast": (lambda: K.fast(batch, ORB_THR), lambda: K.fast_plain(batch, ORB_THR)),
        "orb_moments": (lambda: K.orb_moments(batch, sx, sy),
                        lambda: K.orb_moments_plain(batch, sx, sy)),
        "orb_brief": (lambda: K.orb_brief(batch, sx, sy, sin, cos),
                      lambda: K.orb_brief_plain(batch, sx, sy, sin, cos)),
    }
    px, nk = batch.numel(), sx.numel()
    dy, dx = np.mgrid[-15:16, -15:16]
    disc = int((dx * dx + dy * dy <= 225).sum())
    # K6 25 INT32 operations a pixel, four pixels a 32-bit operation: 16
    # samples x (2 compares, |v - p|, the minimum) / 4, the run of 9 (56
    # operations over 8 pixels' packed bits), the NMS maximum and the key; K7 2
    # multiplies and 2 adds a disc pixel; K8 about 12 operations a pair
    # (rotation, rounding, 2 reads, a compare), 256 pairs
    cost = {"fast": (5 * px, {"int32": 25 * px}, None, "none: no PyTorch call computes FAST"),
            "orb_moments": (px + 16 * nk, 4 * disc * nk, None,
                            "none: no one call sums a disc around each keypoint"),
            "orb_brief": (px + 16 * nk + 32 * nk, 12 * 256 * nk, None,
                          "none: no PyTorch call computes rBRIEF")}
    times = {}
    for name, (kernel, plain) in pairs.items():
        times[name] = kernel_entry(timeit(kernel) * 1e3, timeit(plain, iters=3) * 1e3,
                                   *cost[name])
        emit("kernel_time", card=card, kernel=name,
             shape=list(batch.shape) if name == "fast" else [ORB_N, ORB_CAP], **times[name])
    emit("orb_profile", card=card, entry=f"orb_extract, {ORB_N} x 640x480",
         **profile_calls(gt.orb_extract, batch, ORB_CAP, ORB_THR))
    emit("orb_profile", card=card, entry=f"track, aruco, {TRACK_KPS} keypoints",
         **profile_calls(gt.track, tmpl, scene, TRACK_KPS))
    emit("memory", card=card, peak_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    return times


def document_batch(n):
    """``benchmarks/bench_all.py:153``'s frames: document.pgm rolled 3*i columns."""
    doc = read_pgm(os.path.join(HERE, "tests", "golden", "testdata", "document.pgm"))
    if doc is None:
        raise FileNotFoundError("tests/golden/testdata/document.pgm")
    return np.stack([np.roll(doc, 3 * i, axis=1) for i in range(n)])


def spiral(h, w, gap=4):
    """A one-arm rectangular spiral, arms ``gap`` pixels apart: one component
    whose minimum must travel the whole arm (tests/test_blobs_contour.py:440)."""
    sp = np.zeros((h, w), np.uint8)
    top, bot, lef, rig = 0, h - 1, 0, w - 1
    while top <= bot and lef <= rig:
        sp[top, lef:rig + 1] = sp[top:bot + 1, rig] = sp[bot, lef:rig + 1] = 255
        sp[top:bot + 1, lef] = 255
        top, bot, lef, rig = top + gap, bot - gap, lef + gap, rig - gap
        if lef <= rig:
            sp[top - gap + 1:top + 1, lef] = 255
    return sp


def snake():
    """tests/test_blobs_contour.py:427: a snake zigzagging between 8-row strips."""
    sn = np.zeros((16, 128), np.uint8)
    for i, x in enumerate(range(0, 128, 8)):
        sn[:, x] = 255
        sn[15 if i % 2 == 0 else 0, x: x + 9] = 255
    return sn


def _blob_fields(table):
    return [table.n, table.label, table.area, *table.box, *table.centroid]


def document_labels(n, dev):
    """``scan``'s label map of ``document_batch(n)``: (n, P) int32 and the width."""
    frames = torch.from_numpy(document_batch(n)).to(dev)
    labels = gt.blobs(gt.preprocess_binarize(frames), SCAN_CAP)[1]
    return labels.to(torch.int32).view(n, -1), frames.shape[2]


def phase_scan_kernels(chk, rng, dev):
    cases = [("snake", snake()[None]), ("spiral 40x128", spiral(40, 128)[None]),
             ("spiral 1024x1024", spiral(1024, 1024)[None]),
             ("all foreground", np.full((2, 300, 400), 255, np.uint8)),
             ("empty", np.zeros((2, 300, 400), np.uint8))]
    for shape in CCL_SHAPES + [(2, 67, w) for w in CCL_WIDTHS]:
        for d in CCL_DENSITIES:
            cases.append((f"{shape} density {d}", ((rng.random(shape) < d) * 255).astype(np.uint8)))
    # a comb: columns joined by bars every 37 rows, so components cross every tile border
    comb = np.zeros((1, 520, 1000), np.uint8)
    comb[:, :, ::2] = 255
    comb[:, ::37, :] = 255
    cases += [("comb", comb), ("comb, bars removed", np.where(np.arange(520)[:, None] % 37 == 0, 0,
                                                             comb[0])[None].astype(np.uint8)),
              (f"{CCL_MANY_FRAMES} density 0.5",
               ((rng.random(CCL_MANY_FRAMES) < 0.5) * 255).astype(np.uint8))]
    for what, frames in cases:
        imgs = torch.from_numpy(frames).to(dev)
        chk.same("ccl", K.ccl(imgs), K.ccl_plain(imgs), what)
    torch.cuda.synchronize()
    # an all-255 2100x2100 frame: one blob whose coordinate sums pass 2^32
    full = torch.full((1, 2100, 2100), 255, dtype=torch.uint8, device=dev)
    chk.same("ccl", K.ccl(full), K.ccl_plain(full), "2100x2100 all 255")
    table, labels, _ = gt.blobs(full, 4)
    ref = gt.blobs(full, 4, force_reference=True)
    for a, b in zip(_blob_fields(table) + [labels], _blob_fields(ref[0]) + [ref[1]]):
        chk.same("ccl", a if a.dtype != torch.uint16 else a.to(torch.int32),
                 b if b.dtype != torch.uint16 else b.to(torch.int32), "2100x2100 blobs")
    coord_sum = 2100 * (2099 * 2100 // 2)
    want = (coord_sum % 2**32) // (2100 * 2100)
    if coord_sum < 2**32 or [int(v[0, 0]) for v in table.centroid] != [want, want]:
        raise AssertionError(f"2100x2100 centroid {[int(v[0, 0]) for v in table.centroid]}, "
                             f"want {want} from the sum mod 2^32")
    # K22 on the scanner's label maps, the one blob of 2100x2100 (sums past
    # 2^32), a slab's rows from 700, and 7000 labels (the global-atomics path)
    seg, seg_w = document_labels(STATS_PAGES, dev)
    many = torch.from_numpy(rng.integers(0, 7000, (2, 100 * 128), dtype=np.int32)).to(dev)
    stats_cases = [(f"document {STATS_PAGES} pages", seg, SCAN_CAP + 1, seg_w, 0),
                   ("document page rows from 700", seg[:1], SCAN_CAP + 1, seg_w, 700),
                   ("2100x2100 all 255", labels.to(torch.int32).view(1, -1), 5, 2100, 0),
                   ("7000 labels", many, 7000, 128, 0)]
    for what, x, nseg, width, row0 in stats_cases:
        for a, b in zip(K.blob_stats(x, nseg, width, row0),
                        K.blob_stats_plain(x, nseg, width, row0)):
            chk.same("blob_stats", a, b, what)
    torch.cuda.synchronize()
    del seg, many

    src = torch.from_numpy(document_batch(SCAN_N)).to(dev)
    for name, quad in WARP_QUADS.items():
        for page in WARP_PAGES:
            frames = src if page == SCAN_PAGE else src[:2].contiguous()
            c = torch.tensor(quad, dtype=torch.int32, device=dev).expand(len(frames), 4, 2)
            c = c.contiguous()
            chk.same("quad_warp", K.quad_warp(frames, c, page), K.quad_warp_plain(frames, c, page),
                     f"{name} {page}")
        torch.cuda.synchronize()
    for what, frames, page in warp_edge_cases(rng, dev):
        c = torch.from_numpy(warp_edge_corners(rng, *frames.shape)).to(dev)
        chk.same("quad_warp", K.quad_warp(frames, c, page), K.quad_warp_plain(frames, c, page),
                 what)
    torch.cuda.synchronize()
    gen = torch.Generator(device=dev).manual_seed(14)
    for shape in WARP_WIDE:
        wide = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8, device=dev)
        for quad, page in warp_far_quads(*shape[1:]):
            c = torch.tensor([quad], dtype=torch.int32, device=dev)
            chk.same("quad_warp", K.quad_warp(wide, c, page), K.quad_warp_plain(wide, c, page),
                     f"{list(shape)} {quad} {page}")
        del wide
        torch.cuda.synchronize()
    emit("scan_kernels_vs_plain", ok=True, ccl_cases=len(cases) + 1,
         ccl_shapes=[list(s) for s in CCL_SHAPES], densities=list(CCL_DENSITIES),
         ccl_widths=list(CCL_WIDTHS), ccl_many_frames=list(CCL_MANY_FRAMES),
         warp_quads=sorted(WARP_QUADS), warp_pages=[list(p) for p in WARP_PAGES],
         warp_many_frames=[list(s) for s in WARP_MANY_FRAMES],
         warp_thin_sources=[list(s) for s in WARP_THIN_SOURCES],
         warp_edge_widths=list(WARP_EDGE_WIDTHS), warp_wide=[list(s) for s in WARP_WIDE],
         full_frame_centroid=want, blob_stats_cases=[c[0] for c in stats_cases],
         checks={k: chk.checks[k] for k in ("ccl", "quad_warp", "blob_stats")},
         max_abs_err={k: chk.max_err[k] for k in ("ccl", "quad_warp", "blob_stats")})


def warp_edge_corners(rng, n, sh, sw):
    """(n, 4, 2) int32 corners of random quads reaching up to half a frame past its edges."""
    lo, hi = np.array([-(sw // 2) - 2, -(sh // 2) - 2]), np.array([sw + sw // 2 + 2,
                                                                    sh + sh // 2 + 2])
    return rng.integers(lo, hi, (n, 4, 2)).astype(np.int32)


def warp_far_quads(sh, sw):
    """(quad, page) pairs on an sh x sw frame: the whole frame, and a quad that
    reaches 100 pixels past its far corner from 40 pixels inside it."""
    return (([[0, 0], [sw - 1, 0], [sw - 1, sh - 1], [0, sh - 1]], (5, 1001)),
            ([[max(sw - 40, 0), max(sh - 40, 0)], [sw + 100, max(sh - 40, 0)], [sw + 100, sh + 100],
              [max(sw - 40, 0), sh + 100]], (7, 203)))


def warp_edge_cases(rng, dev):
    """(label, frames, page) of K10's edges (WARP_MANY_FRAMES, WARP_THIN_SOURCES,
    WARP_EDGE_WIDTHS)."""
    shape, page = WARP_MANY_FRAMES
    yield (f"{list(shape)} -> {list(page)}",
           torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev), page)
    for shape in WARP_THIN_SOURCES:
        frames = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        for page in ((37, 61), (1, 9), (9, 1)):
            yield f"{list(shape)} -> {list(page)}", frames, page
    frames = torch.from_numpy(rng.integers(0, 256, (2, 97, 200), dtype=np.uint8)).to(dev)
    for dw in WARP_EDGE_WIDTHS:
        yield f"[2, 97, 200] -> [37, {dw}]", frames, (37, dw)


def _scan_batch(frames):
    return gt.scan(frames, SCAN_PAGE, SCAN_CAP)


def phase_scan_path(chk, dev):
    host = document_batch(SCAN_N)
    batch = torch.from_numpy(host).to(dev)
    (pages, corners), l_batch = _launched(SCAN_KERNELS, _scan_batch, batch)
    (page, corner), l_single = _launched(SCAN_KERNELS, _scan_batch, batch[0])
    for name in SCAN_KERNELS:  # one launch each, whatever the batch size
        if l_batch[name] != 1 or l_single[name] != 1:
            raise AssertionError(f"scan launched {name} {l_batch[name]} and {l_single[name]} times")
    launches = {name: l_batch[name] + l_single[name] for name in KERNELS}
    if tuple(pages.shape) != (SCAN_N, *SCAN_PAGE) or tuple(corners.shape) != (SCAN_N, 4, 2):
        raise AssertionError(f"scan: shapes {tuple(pages.shape)}, {tuple(corners.shape)}")
    ref_pages, ref_corners = gt.scan(batch, SCAN_PAGE, SCAN_CAP, force_reference=True)
    chk.same("quad_warp", pages, ref_pages, "scan pages vs plain path")
    chk.same("ccl", corners, ref_corners, "scan corners vs plain path")
    chk.same("quad_warp", page, pages[0], "single frame vs batch")
    chk.same("ccl", corner, corners[0], "single frame corners vs batch")
    rows = [0, SCAN_N - 1]
    cpu_pages, cpu_corners = gt.scan(torch.from_numpy(host[rows]), SCAN_PAGE, SCAN_CAP)
    if not (torch.equal(pages[rows].cpu(), cpu_pages)
            and torch.equal(corners[rows].cpu(), cpu_corners)):
        raise AssertionError("scan: card differs from the plain path on the CPU")
    binary = gt.preprocess_binarize(batch)
    table, _, overflowed = gt.blobs(binary, SCAN_CAP)

    g = np.load(os.path.join(HERE, "tests", "golden", "goldens.npz"))
    for key, cap in (("blobs", 500), ("multiblob", 64)):
        t, lab, _ = gt.blobs(torch.from_numpy(g[f"{key}_input"]).to(dev), cap)
        n = int(t.n)
        got = {"labels": lab.cpu().numpy(), "label": t.label[:n].cpu().numpy(),
               "area": t.area[:n].cpu().numpy(),
               "box": torch.stack([v[:n] for v in t.box], 1).cpu().numpy(),
               "centroid": torch.stack([v[:n] for v in t.centroid], 1).cpu().numpy()}
        for field, value in got.items():
            if not np.array_equal(value.astype(np.int64), g[f"{key}_{field}"].astype(np.int64)):
                raise AssertionError(f"golden {key}_{field} differs on the card")
    mb = torch.from_numpy(g["multiblob_input"]).to(dev)
    t, lab, _ = gt.blobs(mb, 64)
    big = int(t.area.argmax())
    mc = gt.blob_corners(mb, lab, t.label[big], gt.Rect(*(v[big] for v in t.box)),
                         gt.Point(*(v[big] for v in t.centroid)))
    persp = gt.perspective_correct(torch.from_numpy(g["input"]).to(dev),
                                   torch.from_numpy(g["persp_corners"].astype(np.int32)), (50, 70))
    if (not np.array_equal(mc.cpu().numpy(), g["multiblob_corners"].astype(np.int64))
            or not np.array_equal(persp.cpu().numpy(), g["persp"])):
        raise AssertionError("golden multiblob_corners or persp differs on the card")
    emit("scan_path", ok=True, frames=SCAN_N, height=batch.shape[1], width=batch.shape[2],
         page=list(SCAN_PAGE), max_blobs=SCAN_CAP, launches=launches, launches_batch=l_batch,
         launches_single=l_single, blobs=table.n.tolist(), overflowed=overflowed.tolist(),
         corners_frame0=corners[0].tolist(), cpu_frames_checked=rows,
         goldens=["blobs_*", "multiblob_*", "persp"])
    return batch, corners, launches


def device_events(prof):
    """A stopped profiler's device events: kernels, copies, fills.  Not the
    device's copies of host ranges (``record_function``, the port's ``gs.``
    spans), which overlap the kernels they cover."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events()
            if e.device_type == cuda and not getattr(e, "is_user_annotation", False)]


def profile_calls(fn, *args, calls=10, sessions=3):
    """Device time per call by kernel and by the PyTorch op that launched it
    (over ``calls`` calls, device events only), the device events (kernels,
    copies, fills) a call, the CUDA-event time and the host's enqueue time of
    one call, and the idle share 1 - busy / timed.  A
    profiler session that records no device events is run again, up to
    ``sessions`` in all."""
    from torch.profiler import ProfilerActivity, profile

    timed = timeit(fn, *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
        on_device = device_events(prof)
        if on_device:
            break
    else:
        raise AssertionError(f"the profiler saw no device time in {sessions} sessions")
    by_kernel = {}
    for e in on_device:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    busy = sum(by_kernel.values())
    by_op = [(e.key, e.self_device_time_total / 1e3 / calls) for e in prof.key_averages()
             if e.key.startswith("aten::") and e.self_device_time_total > 0]
    return {"timed_ms": timed * 1e3, "enqueue_ms": enqueue * 1e3, "device_busy_ms": busy,
            "idle_share": 1 - busy / (timed * 1e3), "device_kernels": len(by_kernel),
            "device_launches_a_call": len(on_device) / calls,
            "device_ms_by_kernel": [[name[:120], ms] for name, ms in
                                    sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]],
            "device_ms_by_op": sorted(by_op, key=lambda kv: -kv[1])[:12]}


# K10's least work (csrc/warp.cu), counted from the code.  A page pixel needs
# 25 rounded FP32 operations: the two coordinate lerps (6), the clamps (4), dx,
# dy and their complements (4), and the lerp's 8 products and 3 sums (11).  Its
# 7 type conversions: the 4 bytes and the 2 truncated coordinates to float run
# on the FP32 pipe (I2FP), the store's truncation as an FADD.RZ: 7 more; the 2
# truncations (F2I) at the conversion rate.  A column's u, 1 - u and four edge
# points (14) count once a frame and column, a row's v and 1 - v (2) once a
# frame and row.
WARP_FP32_A_PIXEL, WARP_CONVERSIONS_A_PIXEL = 25 + 7, 2
WARP_FP32_A_COLUMN, WARP_FP32_A_ROW = 14, 2


def warp_ops(n, dh, dw):
    """K10's operations by kind for ``n`` pages of dh x dw (see WARP_FP32_A_PIXEL)."""
    return {"fp32": n * (dh * dw * WARP_FP32_A_PIXEL + dw * WARP_FP32_A_COLUMN
                         + dh * WARP_FP32_A_ROW),
            "conversion": n * dh * dw * WARP_CONVERSIONS_A_PIXEL}


def phase_scan_timing(batch, corners, card, parent=None):
    single = batch[0]
    t_batch = timeit(_scan_batch, batch)
    t_single = timeit(_scan_batch, single)
    t_ref = timeit(gt.scan, batch, SCAN_PAGE, SCAN_CAP, force_reference=True, iters=2, repeat=1)
    t_ref1 = timeit(gt.scan, single, SCAN_PAGE, SCAN_CAP, force_reference=True, iters=2,
                    repeat=1)
    emit("scan_timing", card=card, metric="document_scan_batched_fps", value=SCAN_N / t_batch,
         unit="frames/sec/card", frames=SCAN_N, ms_per_batch=t_batch * 1e3,
         document_scan_latency_ms=t_single * 1e3, plain_path_batched_fps=SCAN_N / t_ref,
         plain_path_ms_per_batch=t_ref * 1e3, plain_path_latency_ms=t_ref1 * 1e3,
         windows="median of 3 windows of 20 calls (plain path: 1 window of 2 calls) after "
                 "2 warm-up calls")
    binary = gt.preprocess_binarize(batch)
    n, sh, sw = batch.shape
    dh, dw = SCAN_PAGE
    px, page_px = batch.numel(), n * dh * dw
    # grid_sample on the same source coordinates (align_corners: -1 and 1 are
    # the first and last pixel): bilinear, not bit-exact with the reference
    u = warp_grid(dw, batch.device).view(1, 1, dw)
    v = warp_grid(dh, batch.device).view(1, dh, 1)
    c = corners.to(torch.float32).view(n, 4, 2, 1, 1)
    sx, sy = ((c[:, 0, i] * (1 - u) + c[:, 1, i] * u) * (1 - v)
              + (c[:, 3, i] * (1 - u) + c[:, 2, i] * u) * v for i in (0, 1))
    grid = torch.stack([sx / (sw - 1) * 2 - 1, sy / (sh - 1) * 2 - 1], -1)
    src_f = batch.to(torch.float32)[:, None]
    gs_ms = timeit(torch.nn.functional.grid_sample, src_f, grid, mode="bilinear",
                   padding_mode="border", align_corners=True) * 1e3
    del src_f, grid
    # K9: a find per neighbour and a flatten, about 10 operations a pixel;
    # K10: warp_ops
    times = {
        "ccl": kernel_entry(timeit(K.ccl, binary) * 1e3,
                            timeit(K.ccl_plain, binary, iters=1, repeat=1) * 1e3,
                            5 * px, 10 * px, None, "none: PyTorch has no component labelling"),
        "quad_warp": kernel_entry(
            timeit(K.quad_warp, batch, corners, SCAN_PAGE) * 1e3,
            timeit(K.quad_warp_plain, batch, corners, SCAN_PAGE, iters=3) * 1e3,
            px + 32 * n + page_px, warp_ops(n, dh, dw), gs_ms,
            "grid_sample(bilinear, align_corners=True) of the float frames at the same "
            "coordinates: not bit-exact"),
    }
    # K22 at the bulk cell's batch: the label map read once, the outputs written once
    seg, seg_w = document_labels(STATS_PAGES, batch.device)
    nseg = SCAN_CAP + 1
    times["blob_stats"] = kernel_entry(
        timeit(K.blob_stats, seg, nseg, seg_w) * 1e3,
        timeit(K.blob_stats_plain, seg, nseg, seg_w, iters=3) * 1e3,
        4 * seg.numel() + 7 * 8 * seg.shape[0] * nseg, 0, None,
        "none: no one call gives the seven statistics")
    times["blob_stats"]["device_ms"] = device_ms(lambda: K.blob_stats(seg, nseg, seg_w))
    stats_by_kernel = profile_calls(K.blob_stats, seg, nseg, seg_w)["device_ms_by_kernel"]
    stats_one_ms = device_ms(lambda: K.blob_stats(seg[:1], nseg, seg_w))
    del seg
    # K9's three kernels by the profiler: back-to-back events read the host too
    gen = torch.Generator(device=batch.device).manual_seed(13)
    noise = ((torch.rand(binary.shape, generator=gen, device=batch.device) < 0.55) * 255).to(
        torch.uint8)
    times["ccl"]["device_ms"] = device_ms(lambda: K.ccl(binary))
    # K10 at scan's call and on one frame, against the parent's in turns when given
    one = batch[:1]
    warp_ms, warp_parent_ms = device_turns(lambda: K.quad_warp(batch, corners, SCAN_PAGE), parent)
    warp_one_ms, warp_one_parent_ms = device_turns(
        lambda: K.quad_warp(one, corners[:1], SCAN_PAGE), parent)
    times["quad_warp"].update(device_ms=warp_ms, parent_device_ms=warp_parent_ms,
                              device_ms_one_frame=warp_one_ms,
                              parent_device_ms_one_frame=warp_one_parent_ms)
    emit("scan_kernel_device_time", card=card, shape=list(binary.shape),
         device_ms={"ccl": times["ccl"]["device_ms"],
                    "ccl_one_frame": device_ms(lambda: K.ccl(binary[:1])),
                    "ccl_density_0.55": device_ms(lambda: K.ccl(noise)),
                    "quad_warp": warp_ms, "quad_warp_one_frame": warp_one_ms,
                    f"blob_stats_{STATS_PAGES}_pages": times["blob_stats"]["device_ms"],
                    "blob_stats_one_page": stats_one_ms},
         blob_stats_by_kernel=stats_by_kernel,
         blob_stats_bound_ms=times["blob_stats"]["bound_ms"],
         parent_device_ms={"quad_warp": warp_parent_ms, "quad_warp_one_frame": warp_one_parent_ms},
         device_ms_by_kernel={label: profile_calls(K.ccl, x)["device_ms_by_kernel"]
                              for label, x in (("ccl", binary), ("ccl_one_frame", binary[:1]))},
         event_ms={"ccl": times["ccl"]["ms"], "quad_warp": times["quad_warp"]["ms"],
                   "blob_stats": times["blob_stats"]["ms"]},
         quad_warp_bound_ms=times["quad_warp"]["bound_ms"],
         quad_warp_operations=times["quad_warp"]["operations"],
         source="torch.profiler device events over 20 calls after a warm-up call; with a "
                "parent, the median of 4 turns each (parent, committed, committed, parent, "
                "twice) (by kernel: over 10 calls, chip_smoke.profile_calls)")
    for name, entry in times.items():
        emit("kernel_time", card=card, kernel=name, shape=list(batch.shape), **entry)
    for label, frames in (("scan 8 frames", batch), ("scan 1 frame", single)):
        emit("scan_profile", card=card, entry=label, **profile_calls(_scan_batch, frames))
    emit("memory", card=card, peak_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    return times


def receipt_batch(n):
    """``benchmarks/bench_all.py:169-175``'s frames: receipt.pgm rolled 5*i columns."""
    rec = read_pgm(os.path.join(HERE, "tests", "golden", "testdata", "receipt.pgm"))
    if rec is None:
        raise FileNotFoundError("tests/golden/testdata/receipt.pgm")
    return np.stack([np.roll(rec, 5 * i, axis=1) for i in range(n)])


def adaptive_morph(frames):
    """BASELINE config #2 (``bench_all.py:177-178``): adaptive threshold, dilate, erode."""
    return gt.erode(gt.dilate(gt.adaptive_threshold(frames, DENSE_R, DENSE_C)))


def adaptive_morph_plain(frames):
    binary = K.adaptive_plain(frames, DENSE_R, DENSE_C)
    return K.morph_plain(K.morph_plain(binary, "dilate"), "erode")


def phase_dense_kernels(chk, rng, dev):
    for shape, imgs in stencil_frames(rng, dev):
        for r in ADAPTIVE_RADII:
            for c in ADAPTIVE_CS:
                chk.same("adaptive", K.adaptive(imgs, r, c), K.adaptive_plain(imgs, r, c),
                         f"{shape} r={r} c={c}")
        for op in ("erode", "dilate"):
            chk.same("morph", K.morph(imgs, op), K.morph_plain(imgs, op), f"{shape} {op}")
        for name, (taps, norm) in FILTER_TAPS.items():
            chk.same("filter3", K.filter3(imgs, taps, norm), K.filter3_plain(imgs, taps, norm),
                     f"{shape} {name}")
        torch.cuda.synchronize()
    for src, dst in RESIZE_CASES:
        imgs = torch.from_numpy(rng.integers(0, 256, (2, *src), dtype=np.uint8)).to(dev)
        chk.same("resize", K.resize(imgs, dst), K.resize_plain(imgs, dst), f"{src}->{dst}")
    for src, dst in RESIZE_EDGE_CASES:
        imgs = torch.from_numpy(rng.integers(0, 256, src, dtype=np.uint8)).to(dev)
        chk.same("resize", K.resize(imgs, dst), K.resize_plain(imgs, dst), f"{src}->{dst}")
    src, dsts = RESIZE_UNALIGNED
    for off in range(1, 16):
        imgs = unaligned(src, off, rng, dev)
        for dst in dsts:
            chk.same("resize", K.resize(imgs, dst), K.resize_plain(imgs, dst),
                     f"{src} at offset {off} -> {dst}")
        # the C entry into an output that starts off bytes into a buffer
        ref = K.resize_plain(imgs, dsts[0])
        out = torch.zeros(ref.numel() + 16, dtype=torch.uint8, device=dev)
        _build.check(_build.library().gs_resize(imgs.data_ptr(), out.data_ptr() + off, src[0],
                                                src[1], src[2], *dsts[0], _build.stream_of(imgs)),
                     "resize")
        chk.same("resize", out[off:off + ref.numel()].view(ref.shape), ref,
                 f"{src} at offset {off} -> {dsts[0]}, output at offset {off}")
        if out[:off].any() or out[off + ref.numel():].any():
            raise AssertionError(f"resize wrote outside its output at offset {off}")
    torch.cuda.synchronize()
    dense = ("adaptive", "morph", "filter3", "resize")
    emit("dense_kernels_vs_plain", ok=True, shapes=[list(s) for s in SHAPES + EDGE_SHAPES],
         unaligned=f"{list(UNALIGNED)}[1:]", radii=list(ADAPTIVE_RADII), offsets=list(ADAPTIVE_CS), taps=sorted(FILTER_TAPS),
         resize_cases=[[list(a), list(b)] for a, b in RESIZE_CASES],
         resize_edge_cases=[[list(a), list(b)] for a, b in RESIZE_EDGE_CASES],
         resize_unaligned=[list(RESIZE_UNALIGNED[0]), "offsets 1-15", [list(d) for d in RESIZE_UNALIGNED[1]]],
         checks={k: chk.checks[k] for k in dense}, max_abs_err={k: chk.max_err[k] for k in dense})


def dense_goldens(img):
    """The ten dense goldens' ops on one frame."""
    return {
        "adaptive_15_5": gt.adaptive_threshold(img, 15, 5), "erode": gt.erode(img),
        "dilate": gt.dilate(img), "sharpen": gt.sharpen(img), "emboss": gt.emboss(img),
        "blur_box3": gt.blur_box(img), "blur_gaussian3": gt.blur_gaussian(img),
        "resize_100_40": gt.resize(img, (100, 40)), "resize_nn_7_150": gt.resize_nn(img, (7, 150)),
        "crop_20_10_40_30": gt.crop(img, gt.Rect(20, 10, 40, 30)),
    }


def stencil3_access(src, dst, w):
    """The bytes of one row access of K12 or K13 launched on the addresses
    ``src`` and ``dst`` with rows of ``w`` bytes: 16 where all three are
    multiples of 16, 4 where they are multiples of 4, else 1, as
    ``csrc/stencil3.cu:access_width`` picks them."""
    a = src | dst | w
    return 16 if a % 16 == 0 else 4 if a % 4 == 0 else 1


class _MorphAccess:
    """Stands in for the kernel library and records the access width of every
    ``gs_morph`` launch from the arguments the wrapper passed it."""

    def __init__(self, lib):
        self._lib, self.widths = lib, []

    def gs_morph(self, src, dst, n, h, w, *rest):
        self.widths.append(stencil3_access(src, dst, w))
        return self._lib.gs_morph(src, dst, n, h, w, *rest)

    def __getattr__(self, name):
        return getattr(self._lib, name)


def phase_dense_path(chk, dev):
    host = receipt_batch(DENSE_N)
    batch = torch.from_numpy(host).to(dev)
    lib = _build.library()
    _build._lib = morph_access = _MorphAccess(lib)
    try:
        out, l_path = _launched(DENSE_KERNELS, adaptive_morph, batch)
    finally:
        _build._lib = lib
    if l_path["adaptive"] != 1 or l_path["morph"] != 2:
        raise AssertionError(f"config #2 launched {l_path}, not adaptive 1 and morph 2")
    if tuple(out.shape) != tuple(batch.shape) or out.dtype != torch.uint8:
        raise AssertionError(f"config #2: {tuple(out.shape)} {out.dtype}")
    ref = adaptive_morph_plain(batch)
    chk.same("adaptive", out, ref, "config #2 vs plain path")
    rows = [0, DENSE_N - 1]
    on_cpu = adaptive_morph(torch.from_numpy(host[rows]))
    if not torch.equal(out[rows].cpu(), on_cpu):
        raise AssertionError("config #2: card differs from the plain path on the CPU")
    white = int((out == 255).sum())
    if not 0 < white < out.numel():
        raise AssertionError(f"config #2: {white} white pixels of {out.numel()}")

    g = np.load(os.path.join(HERE, "tests", "golden", "goldens.npz"))
    img = torch.from_numpy(g["input"]).to(dev)
    got, l_goldens = _launched(("adaptive", "morph", "filter3", "resize"), dense_goldens, img)
    for name, value in got.items():
        if not np.array_equal(value.cpu().numpy(), g[name]):
            raise AssertionError(f"golden {name} differs on the card")
    launches = {name: l_path[name] + l_goldens[name] for name in KERNELS}
    emit("dense_path", ok=True, frames=DENSE_N, height=batch.shape[1], width=batch.shape[2],
         radius=DENSE_R, c=DENSE_C, launches=launches, launches_config2=l_path,
         morph_access_bytes=morph_access.widths,
         launches_goldens=l_goldens, white_fraction=white / out.numel(), cpu_frames_checked=rows,
         goldens=sorted(got))
    return batch, out, launches


def device_ms(fn, calls=20, sessions=3, kernel=None):
    """Device time of one call of ``fn()`` from ``torch.profiler`` (device events
    only, summed over the kernels it launches, or over those whose name holds
    ``kernel``), after one warm-up call.  Now and then a profiler session
    records no device events at all; such a session is run again, up to
    ``sessions`` in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(e.time_range.elapsed_us() for e in device_events(prof)
                    if kernel is None or kernel in e.name)
        if total > 0:
            return total / 1e3 / calls
    raise AssertionError(f"the profiler saw no device time in {sessions} sessions")


def phase_dense_timing(batch, binary, card):
    t_path = timeit(adaptive_morph, batch)
    t_ref = timeit(adaptive_morph_plain, batch, iters=3)
    big = torch.from_numpy(lena_batch(RESIZE_N, MAIN_H, MAIN_W)).to(batch.device)
    t_resize = timeit(gt.resize, big, RESIZE_TO)
    t_resize_ref = timeit(K.resize_plain, big, RESIZE_TO, iters=3)
    emit("dense_timing", card=card, metric="adaptive_morph_816x612_fps", value=DENSE_N / t_path,
         unit="frames/sec/card", frames=DENSE_N, ms_per_batch=t_path * 1e3,
         plain_path_fps=DENSE_N / t_ref, plain_path_ms_per_batch=t_ref * 1e3,
         op_resize_640x480_1MP_fps=RESIZE_N / t_resize, resize_ms_per_batch=t_resize * 1e3,
         plain_resize_fps=RESIZE_N / t_resize_ref,
         windows="median of 3 windows of 20 calls (plain: 3 calls) after 2 warm-up calls")
    F = torch.nn.functional
    px, big_px = batch.numel(), big.numel()
    out_px = RESIZE_N * RESIZE_TO[0] * RESIZE_TO[1]
    gauss, gnorm = FILTER_TAPS["blur_gaussian"]
    half = binary.to(torch.float16)[:, None]
    pool_ms = timeit(F.max_pool2d, half, 3, 1, 1) * 1e3
    del half
    bigf = big.to(torch.float32)[:, None]
    weight = torch.tensor(gauss, dtype=torch.float32, device=big.device).view(1, 1, 3, 3) / gnorm
    conv_ms = timeit(F.conv2d, bigf, weight, None, 1, 1) * 1e3
    interp_ms = timeit(F.interpolate, bigf, size=RESIZE_TO, mode="bilinear",
                       align_corners=False) * 1e3
    del bigf
    # per pixel: K11 4 running-sum adds, a division, a subtraction, a compare, a
    # select; K12 8 compares; K13 9 multiplies, 8 adds, a division, a clamp; K14
    # 16 FP32 operations an output pixel (4 bytes made floats, 8 multiplies, 3
    # adds, the truncation; each coordinate once a column or a row)
    times = {
        "adaptive": kernel_entry(
            timeit(K.adaptive, batch, DENSE_R, DENSE_C) * 1e3,
            timeit(K.adaptive_plain, batch, DENSE_R, DENSE_C, iters=3) * 1e3, 2 * px, 8 * px,
            None, "none: no one call gives a clipped-mean threshold"),
        "morph": kernel_entry(
            timeit(K.morph, binary, "dilate") * 1e3,
            timeit(K.morph_plain, binary, "dilate", iters=3) * 1e3, 2 * px, 8 * px, pool_ms,
            "max_pool2d(3, 1, 1) of the float16 frames (dilate; erode is -max_pool2d(-x))"),
        "filter3": kernel_entry(
            timeit(K.filter3, big, gauss, gnorm) * 1e3,
            timeit(K.filter3_plain, big, gauss, gnorm, iters=3) * 1e3, 2 * big_px, 20 * big_px,
            conv_ms, "conv2d(padding=1) of the float32 frames: no unsigned division, "
                     "cuDNN's default TF32"),
        "resize": kernel_entry(
            timeit(K.resize, big, RESIZE_TO) * 1e3, t_resize_ref * 1e3, big_px + out_px,
            {"fp32": 16 * out_px}, interp_ms,
            "interpolate(bilinear, align_corners=False) of the float32 frames: not bit-exact"),
    }
    shapes = {"adaptive": batch.shape, "morph": binary.shape, "filter3": big.shape,
              "resize": big.shape}
    for name, entry in times.items():
        emit("kernel_time", card=card, kernel=name, shape=list(shapes[name]), **entry,
             **({"to": list(RESIZE_TO)} if name == "resize" else {}),
             **({"taps": "blur_gaussian"} if name == "filter3" else {}))
    emit("dense_profile", card=card, entry="config #2, 256 frames",
         **profile_calls(adaptive_morph, batch))
    emit("dense_profile", card=card, entry="resize 256 x 1 MP to 480x640",
         **profile_calls(gt.resize, big, RESIZE_TO))
    emit("memory", card=card, peak_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    return times


def track_levels(tmpl, scene):
    """The frames and keypoints of ``track``'s calls of K7 and K8: the template's
    and the scene's pyramid levels, each through ``orb_extract`` with track's caps
    (833 keypoints a level, 2,500 at the last); (label, frames, table) each."""
    out = []
    for name, frame in (("template", tmpl), ("scene", scene)):
        cur = frame[None]
        levels = pyramid_levels(cur.shape[-2:])
        for lvl in range(len(levels)):
            if lvl:
                cur = downsample(cur)
            cap = TRACK_KPS if lvl == len(levels) - 1 else TRACK_KPS // len(levels)
            out.append((f"{name}_{cur.shape[-2]}x{cur.shape[-1]}", cur,
                        gt.orb_extract(cur, cap, ORB_THR)))
    return out


def brief_args(frames, table):
    """K8's inputs as ``orb_extract`` makes them from its table: the frames, the
    coordinates clamped 15 pixels inside the frame, the angles' sin and cos."""
    h, w = frames.shape[-2:]
    return (frames, table.x.clamp(15, w - 16), table.y.clamp(15, h - 16),
            libm32.sinf(table.angle), libm32.cosf_like_reference(table.angle))


def brief_bound_ms(frames, nk):
    """K8's bound: the frames read once, 16 B in and 32 B out a keypoint; about 12
    operations a pair (rotation, rounding, 2 reads, a compare), 256 pairs."""
    return kernel_entry(None, None, frames.numel() + 48 * nk, 12 * 256 * nk)["bound_ms"]


def phase_orb_device_time(frames, times, card, parent=None):
    """K6's, K7's and K8's device time per call from the profiler (their
    CUDA-event times over back-to-back calls read the host's launch rate), and
    K8's at each of track's six calls; K8 against the parent's in turns when given."""
    batch, tmpl, scene, _ = frames
    args = brief_args(batch, gt.orb_extract(batch, ORB_CAP, ORB_THR))
    dev = {"fast": device_ms(lambda: K.fast(batch, ORB_THR)),
           "orb_moments": device_ms(lambda: K.orb_moments(*args[:3]))}
    dev["orb_brief"], parent_ms = device_turns(lambda: K.orb_brief(*args), parent)
    for name, ms in dev.items():
        times[name]["device_ms"] = ms
    levels = []
    for label, cur, table in track_levels(tmpl, scene):
        a = brief_args(cur, table)
        ms, pms = device_turns(lambda a=a: K.orb_brief(*a), parent)
        levels.append({"level": label, "keypoints": a[1].numel(), "device_ms": ms,
                       "parent_device_ms": pms, "bound_ms": brief_bound_ms(cur, a[1].numel())})
    times["orb_brief"].update(
        parent_device_ms=parent_ms, track_levels=levels,
        track_device_ms=sum(lv["device_ms"] for lv in levels),
        track_lost_ms=sum(lv["device_ms"] - lv["bound_ms"] for lv in levels))
    emit("orb_kernel_device_time", card=card, shape=[ORB_N, ORB_CAP], fast_shape=list(batch.shape),
         device_ms=dev, parent_device_ms={"orb_brief": parent_ms},
         event_ms={name: times[name]["ms"] for name in dev}, orb_brief_track_levels=levels,
         source="torch.profiler device events over 20 calls after a warm-up call; with a "
                "parent, the median of 4 turns each (parent, committed, committed, parent, twice)")


def phase_cli(dev):
    from grayskull_tpu_torch import cli
    from grayskull_tpu_torch.core import host_arrays_to

    tdir = os.path.join(HERE, "tests", "golden", "testdata")
    results, launches = {}, {name: 0 for name in KERNELS}
    with tempfile.TemporaryDirectory(dir=HERE) as work:
        for args, src, kernels in CLI_COMMANDS:
            argv = [os.path.join(tdir, f"{a}.pgm") if a == "aruco" else a for a in args]
            argv.append(os.path.join(tdir, f"{src}.pgm"))
            has_out = args[0] not in ("identify", "view")
            outs = []
            for where in ("card", "cpu"):
                out_path = os.path.join(work, f"{args[0]}_{where}.pgm")
                buf = io.StringIO()
                torch.cuda.synchronize()
                K.reset_launch_counts()
                with contextlib.redirect_stdout(buf), host_arrays_to(None if where == "card"
                                                                      else "cpu"):
                    rc = cli.main(["nanomagick", *argv, *([out_path] if has_out else [])])
                torch.cuda.synchronize()
                counts = K.launch_counts()
                if rc != 0:
                    raise AssertionError(f"cli {args} on the {where} exited {rc}")
                data = open(out_path, "rb").read() if has_out else b""
                outs.append((buf.getvalue(), data, counts))
            (card_stdout, card_pgm, card_counts), (cpu_stdout, cpu_pgm, cpu_counts) = outs
            if card_stdout != cpu_stdout or card_pgm != cpu_pgm:
                raise AssertionError(f"cli {args}: the card's output differs from the CPU's")
            missing = [k for k in kernels if card_counts[k] < 1]
            if missing or any(cpu_counts.values()):
                raise AssertionError(f"cli {args}: card launched {card_counts}, cpu {cpu_counts}")
            for name in KERNELS:
                launches[name] += card_counts[name]
            results[args[0] if args[0] not in results else " ".join(args)] = {
                "bytes": len(card_pgm), "stdout_chars": len(card_stdout),
                "launches": {k: v for k, v in card_counts.items() if v}}
    emit("cli", ok=True, commands=len(results), byte_identical_with_cpu=True, results=results)
    return launches


def card_mesh(shape, dev):
    """A mesh of ``shape`` that names ``dev`` for every position."""
    return gt.parallel.make_mesh(shape, devices=[dev] * int(np.prod(shape)))


def phase_sharded_kernels(chk, rng, dev):
    """K15 and K16 at the first, a middle and the last row offset of a frame 8
    rows taller than the array; K17 and K18 on sizes whose tails are not whole
    16-byte words or around K18's vectors and blocks, aligned and 1, 4 and 8 bytes off."""
    for shape, imgs in stencil_frames(rng, dev):
        n, h, w = imgs.shape
        t = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).to(dev)
        h_total = h + 8
        for r in WINDOW_RADII:
            lo = min(r, h)
            kw = {"h_total": h_total, "row_lo": lo, "row_hi": max(lo, h - r)}
            for row0 in (-r, 4, h_total + r - h):
                got = K.blur_hist_window(imgs, row0, r, **kw)
                ref = K.blur_hist_window_plain(imgs, row0, r, **kw)
                chk.same("blur_hist_window", got[0], ref[0], f"{shape} r={r} row0={row0} blurred")
                chk.same("blur_hist_window", got[1], ref[1], f"{shape} r={r} row0={row0} hist")
        for row0 in (-1, 4, h_total + 1 - h):
            for want_binary in (True, False):
                got = K.threshold_sobel_window(imgs, t, row0, h_total=h_total,
                                               want_binary=want_binary)
                ref = K.threshold_sobel_window_plain(imgs, t, row0, h_total=h_total,
                                                     want_binary=want_binary)
                what = f"{shape} row0={row0} want_binary={want_binary}"
                chk.same("threshold_sobel_window", got[0], ref[0], what + " binary")
                chk.same("threshold_sobel_window", got[1], ref[1], what + " edges")
        torch.cuda.synchronize()
    gen = torch.Generator(device=dev).manual_seed(6)
    for size in BANDWIDTH_SIZES:
        x, y = (torch.randint(0, 256, (size + 8,), dtype=torch.uint8, device=dev, generator=gen)
                for _ in range(2))
        for off in BANDWIDTH_OFFSETS:
            a, b = x[off:off + size], y[off:off + size]
            chk.same("copy", K.copy(a), K.copy_plain(a), f"{size} B {off} B off")
            chk.same("triad", K.triad(a, b), K.triad_plain(a, b), f"{size} B {off} B off")
        del x, y
        torch.cuda.synchronize()
    names = ("blur_hist_window", "threshold_sobel_window", "copy", "triad")
    emit("sharded_kernels_vs_plain", ok=True, shapes=[list(s) for s in SHAPES + EDGE_SHAPES],
         unaligned=f"{list(UNALIGNED)}[1:]", radii=list(WINDOW_RADII), sizes=list(BANDWIDTH_SIZES),
         offsets=list(BANDWIDTH_OFFSETS),
         checks={k: chk.checks[k] for k in names}, max_abs_err={k: chk.max_err[k] for k in names})


def phase_sharded_path(chk, dev, lena):
    """The sharded entry points on meshes of ``cuda:0``, each against its
    single-device entry point on the same frames."""
    par = gt.parallel
    mesh = card_mesh((1, SPACE), dev)
    out, l_full = _launched(SHARDED_KERNELS, par.preprocess_spatial_shardmap, lena, mesh, MAIN_R)
    want = {"blur_hist_window": SPACE, "otsu": 1, "threshold_sobel_window": SPACE,
            "blur_hist": 0, "threshold_sobel": 0}
    if any(l_full[k] != v for k, v in want.items()):
        raise AssertionError(f"(1, {SPACE}) sharded preprocess launched {l_full}, want {want}")
    owners = ("blur_hist_window", "threshold_sobel_window", "threshold_sobel_window", "otsu")
    ref = gt.preprocess(lena, MAIN_R)
    for name, owner, a, b in zip(PREPROCESS_OUTPUTS, owners, out, ref):
        chk.same(owner, a, b, f"(1, {SPACE}) sharded {name} vs preprocess")
    runs = [l_full]
    batch = lena[:16]
    mesh24 = card_mesh((2, 4), dev)
    for r in (1, 5):
        got, counts = _launched(SHARDED_KERNELS, par.preprocess_spatial_shardmap, batch, mesh24, r)
        runs.append(counts)
        for name, owner, a, b in zip(PREPROCESS_OUTPUTS, owners, got, gt.preprocess(batch, r)):
            chk.same(owner, a, b, f"(2, 4) r={r} sharded {name} vs preprocess")
    got, counts = _launched(PREPROCESS_KERNELS, par.preprocess_sharded, batch,
                            card_mesh((4, 1), dev), MAIN_R)
    runs.append(counts)
    kinds = ("blur_hist", "threshold_sobel", "threshold_sobel", "otsu")
    for name, owner, a, b in zip(PREPROCESS_OUTPUTS, kinds, got, gt.preprocess(batch, MAIN_R)):
        chk.same(owner, a, b, f"(4, 1) preprocess_sharded {name} vs preprocess")
    frames = torch.from_numpy(lena_batch(32, FACES_H, FACES_W, roll=7)).to(dev)
    got, counts = _launched(("integral",), par.integral_sharded, frames, mesh)
    runs.append(counts)
    chk.same("integral", got, gt.integral(frames), f"(1, {SPACE}) integral_sharded vs integral")
    docs = torch.from_numpy(document_batch(SCAN_N)).to(dev)
    (pages, corners), counts = _launched(SCAN_KERNELS, par.scan_sharded, docs,
                                         card_mesh((2, 1), dev), SCAN_PAGE, SCAN_CAP)
    runs.append(counts)
    ref_pages, ref_corners = gt.scan(docs, SCAN_PAGE, SCAN_CAP)
    chk.same("quad_warp", pages, ref_pages, "(2, 1) scan_sharded pages vs scan")
    chk.same("ccl", corners, ref_corners, "(2, 1) scan_sharded corners vs scan")
    rows = [0, MAIN_N - 1]
    cpu_mesh = gt.parallel.make_mesh((1, SPACE), devices=["cpu"] * SPACE)
    on_cpu = par.preprocess_spatial_shardmap(lena[rows].cpu(), cpu_mesh, MAIN_R)
    for name, a, b in zip(PREPROCESS_OUTPUTS, out, on_cpu):
        if not torch.equal(a[rows].cpu(), b):
            raise AssertionError(f"sharded {name}: card differs from the plain path on the CPU")
    launches = {name: sum(c[name] for c in runs) for name in KERNELS}
    emit("sharded_path", ok=True, frames=MAIN_N, height=MAIN_H, width=MAIN_W, radius=MAIN_R,
         mesh=[1, SPACE], devices=[str(d) for d in mesh.devices.flat], launches=launches,
         launches_full_width=l_full, launches_per_run=runs[1:],
         also=["(2, 4) r=1 and r=5 on 16 frames", "preprocess_sharded (4, 1)",
               "integral_sharded (1, 4) on 32x480x640", "scan_sharded (2, 1) on 8 documents"],
         cpu_frames_checked=rows, thresholds=sorted(set(out[3].tolist()))[:8])
    return launches


def phase_bandwidth(card, dev):
    """``hbm_bandwidth_gbps`` with the counts at 0, then K17 and K18 against
    their plain versions and the library calls at the probe's 256 MiB."""
    torch.cuda.synchronize()
    K.reset_launch_counts()
    rates = gt.profiling.hbm_bandwidth_gbps()
    torch.cuda.synchronize()
    launches = K.launch_counts()
    missing = [name for name in BANDWIDTH_KERNELS if launches[name] < 1]
    if missing:
        raise AssertionError(f"hbm_bandwidth_gbps did not launch {missing}: {launches}")
    gen = torch.Generator(device=dev).manual_seed(7)
    x, y = (torch.randint(0, 256, (512, 512, 1024), dtype=torch.uint8, device=dev, generator=gen)
            for _ in range(2))  # the probe's 256 MiB
    out = torch.empty_like(x)
    nb = x.numel()
    times = {
        "copy": kernel_entry(timeit(K.copy, x) * 1e3, timeit(K.copy_plain, x) * 1e3, 2 * nb, 0,
                             timeit(out.copy_, x) * 1e3,
                             "Tensor.copy_ (the plain version, clone, is nearly the same call)"),
        "triad": kernel_entry(timeit(K.triad, x, y) * 1e3, timeit(K.triad_plain, x, y, iters=3) * 1e3,
                              3 * nb, nb, timeit(torch.add, x, y, out=out) * 1e3,
                              "torch.add(x, y, out=o) on uint8"),
    }
    for name, entry in times.items():
        emit("kernel_time", card=card, kernel=name, shape=list(x.shape), **entry)
    alternating = {
        "copy_vs_copy_": alternate_windows(lambda: K.copy(x), lambda: out.copy_(x)),
        "triad_vs_add": alternate_windows(lambda: K.triad(x, y), lambda: torch.add(x, y, out=out)),
    }
    emit("bandwidth", card=card, **rates, launches={k: launches[k] for k in BANDWIDTH_KERNELS},
         operand_bytes=nb, copy_ms=times["copy"]["ms"], copy__ms=times["copy"]["library_ms"],
         triad_ms=times["triad"]["ms"], add_ms=times["triad"]["library_ms"],
         alternating=alternating,
         source="profiling.hbm_bandwidth_gbps: median of 3 windows of 20 calls; alternating: "
                f"{BANDWIDTH_WINDOWS} windows of 20 calls each, kernel and library call in turns")
    return launches, times, rates


def alternate_windows(kernel, library, windows=BANDWIDTH_WINDOWS, iters=20):
    """ms per call of ``kernel`` and ``library`` over ``windows`` windows of
    ``iters`` calls each, the two in turns (the library first in every other
    pair): each one's median and min-max spread, and the median gap."""
    ms = {"kernel": [], "library": []}
    for fn in (kernel, library, kernel, library):  # warm-up
        fn()
    torch.cuda.synchronize()
    for i in range(windows):
        for name in (("kernel", "library") if i % 2 == 0 else ("library", "kernel")):
            fn = kernel if name == "kernel" else library
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            ms[name].append(start.elapsed_time(end) / iters)
    out = {}
    for name, values in ms.items():
        out[name] = {"median_ms": statistics.median(values), "min_ms": min(values),
                     "max_ms": max(values), "spread_ms": max(values) - min(values),
                     "windows_ms": values}
    out["median_gap_ms"] = out["kernel"]["median_ms"] - out["library"]["median_ms"]
    return out


def phase_sharded_timing(batch, card):
    """The full-width (1, 4) call, its shard bodies without the gather, and
    ``preprocess`` on the same batch; K15 and K16 at one shard's shapes."""
    from grayskull_tpu_torch.parallel.halo import exchange_halo
    from grayskull_tpu_torch.parallel.sharded import _spatial_shards

    par = gt.parallel
    mesh = card_mesh((1, SPACE), batch.device)
    n = batch.shape[0]
    t_call = timeit(par.preprocess_spatial_shardmap, batch, mesh, MAIN_R)
    t_bodies = timeit(_spatial_shards, batch, mesh, MAIN_R, "data", "space", True)
    t_single = timeit(gt.preprocess, batch, MAIN_R)
    emit("sharded_timing", card=card, metric="spatial_preprocess_1MP_frames_per_sec",
         value=n / t_call, unit="frames/sec/card", mesh=[1, SPACE], frames=n,
         ms_per_batch=t_call * 1e3, shard_bodies_frames_per_sec=n / t_bodies,
         shard_bodies_ms=t_bodies * 1e3, preprocess_frames_per_sec=n / t_single,
         preprocess_ms=t_single * 1e3,
         windows="median of 3 windows of 20 calls after 2 warm-up calls")
    h_loc = MAIN_H // SPACE
    shards = [batch[:, s * h_loc:(s + 1) * h_loc] for s in range(SPACE)]
    x = exchange_halo(shards, MAIN_R)[1].contiguous()  # a middle shard: (256, 260, 1024)
    kw = {"h_total": MAIN_H, "row_lo": MAIN_R, "row_hi": MAIN_R + h_loc}
    row0 = h_loc - MAIN_R
    blurred, hist = K.blur_hist_window(x, row0, MAIN_R, **kw)
    t = K.otsu(hist, MAIN_H * MAIN_W)
    b = blurred[:, MAIN_R - 1:MAIN_R + h_loc + 1].contiguous()  # (256, 258, 1024)
    xf = x.to(torch.float32)[:, None]
    k = 2 * MAIN_R + 1
    pool_ms = timeit(torch.nn.functional.avg_pool2d, xf, k, 1, MAIN_R,
                     count_include_pad=False) * 1e3
    del xf
    px15, px16 = x.numel(), b.numel()
    times = {
        "blur_hist_window": kernel_entry(
            timeit(K.blur_hist_window, x, row0, MAIN_R, **kw) * 1e3,
            timeit(K.blur_hist_window_plain, x, row0, MAIN_R, iters=3, **kw) * 1e3,
            2 * px15 + n * 1024, 10 * px15, pool_ms,
            "avg_pool2d(count_include_pad=False) of the float shard: float mean, no truncation, "
            "no histogram"),
        "threshold_sobel_window": kernel_entry(
            timeit(K.threshold_sobel_window, b, t, h_loc - 1, h_total=MAIN_H) * 1e3,
            timeit(K.threshold_sobel_window_plain, b, t, h_loc - 1, h_total=MAIN_H,
                   iters=3) * 1e3,
            3 * px16 + n, 16 * px16, None,
            "none: no one call gives (|gx|+|gy|)/2 of the binarized shard"),
    }
    for name, entry in times.items():
        emit("kernel_time", card=card, kernel=name,
             shape=list((x if name == "blur_hist_window" else b).shape),
             launches_per_call=SPACE, **entry)
    emit("sharded_profile", card=card, entry=f"preprocess_spatial_shardmap (1, {SPACE}), 256 x 1 MP",
         **profile_calls(par.preprocess_spatial_shardmap, batch, mesh, MAIN_R))
    emit("memory", card=card, peak_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    return times

# ---- K19 match_template and K20 contour ----------------------------------------------------
# benchmarks/bench_all.py:233-266: 64 frames of 480x640 (lena tiled, frame i rolled 11*i
# columns) and the 32x32 template at rows 200-231, columns 300-331 of frame 0; the
# 12-rectangle frame for the contour entry points
MATCH_N, MATCH_H, MATCH_W, MATCH_ROLL = 64, 480, 640, 11
MATCH_TMPL = (slice(200, 232), slice(300, 332))
CONTOUR_CAP, CONTOUR_BLOBS = 16, 64
# (frames, template) shapes: odd widths, tw % 4 of 0-3, a 1x1 map, a 1x1 template,
# 66,049 and 66,051 template pixels (past the default 48 KB of shared memory), a
# template staged in two chunks (24,577 rows of one word), frames past grid.z's 65,535
TEMPLATE_CASES = [((2, 30, 41), (5, 7)), ((3, 17, 131), (4, 8)), ((1, 30, 41), (30, 41)),
                  ((2, 9, 258), (1, 1)), ((2, 40, 300), (13, 17)), ((4, 33, 129), (6, 10)),
                  ((2, 100, 150), (32, 32)), ((70000, 3, 5), (2, 3))]
TEMPLATE_LIMIT_CASES = [((1, 260, 300), (257, 257)), ((1, 12, 7400), (9, 7339)),
                        ((1, 24600, 2), (24577, 1))]
TEMPLATE_OFFSETS = (0, 1, 3)
def _rects(h, w, rects, value=255):
    img = np.zeros((h, w), np.uint8)
    for y0, x0, y1, x1 in rects:
        img[y0:y1, x0:x1] = value
    return img


def twelve_blobs():
    """``benchmarks/bench_all.py:255-258``: 12 rectangles of 80 x 100 on 480 x 640."""
    return _rects(480, 640, [(120 * r + 20, 160 * c + 30, 120 * r + 100, 160 * c + 130)
                             for r in range(3) for c in range(4)])


def contour_frames(rng):
    """(name, frame, table capacity): K20's edge cases."""
    gray = _rects(40, 48, [(2, 2, 20, 20), (25, 5, 35, 40)])
    gray[2, 2:9] = 128  # blob pixels that are not contour foreground; a first pixel of 128
    gray[25:35, 20] = 128
    nested = _rects(48, 48, [(2, 2, 46, 46)])
    nested[8:40, 8:40] = 0
    nested[14:34, 14:34] = 255
    nested[20:28, 20:28] = 0
    nested[23:25, 23:25] = 255
    diagonal = _rects(20, 30, [(2, 2, 12, 12), (12, 12, 18, 25), (2, 14, 8, 20)])
    dots = np.zeros((40, 48), np.uint8)
    dots[1::3, 1::3] = 255  # more seeds than the capacity, more rows than a window
    one = np.zeros((9, 9), np.uint8)
    one[4, 4] = 255
    # past the shared-memory bitmaps (0.93 MP): K20 walks the bytes
    big = _rects(965, 965, [(10, 20, 300, 500), (400, 600, 960, 900), (0, 0, 1, 1)])
    big[500:520, 700:720] = 0
    return [("spiral_40x128", spiral(40, 128), 64), ("snake", snake(), 64),
            ("noise_12x12", ((np.random.default_rng(0).random((12, 12)) > 0.45) * 255).astype(
                np.uint8), 64),
            ("noise_20x24", ((rng.random((20, 24)) > 0.5) * 255).astype(np.uint8), 100),
            ("twelve_blobs", twelve_blobs(), CONTOUR_BLOBS), ("pixels_of_128", gray, 16),
            ("nested", nested, 16), ("diagonal", diagonal, 8), ("dots", dots, 100),
            ("single_pixel", one, 4), ("past_65535_labels", diagonal, 65536),
            ("byte_path_965x965", big, 8)]


def _contour_modes(img, table, label_map, cap):
    """The K20 calls of a frame: traces from its first foreground pixel, a
    background pixel and starts outside the frame, find at three capacities (up
    to more rows than one window of side-by-side walks), largest."""
    fg = np.argwhere(img > 128)
    first = (int(fg[0][1]), int(fg[0][0])) if len(fg) else (0, 0)
    h, w = img.shape
    calls = [{"start": s} for s in (first, (0, h - 1), (-1, 0), (0, -1), (w, 0), (-w - 1, 0))]
    calls += [{"table": table, "label_map": label_map, "max_contours": m}
              for m in sorted({min(cap, 3), min(cap, 16), min(cap, 80)})]
    calls.append({"table": table, "label_map": label_map, "largest": True})
    return calls


def phase_contour_template_kernels(chk, rng, dev):
    """K19 against ``match_template_plain`` at odd byte offsets, odd shapes and the
    template limit; K20 against ``contour_plain`` in its three modes, on fresh and
    carried masks."""
    cases = [(s, t, off) for s, t in TEMPLATE_CASES for off in TEMPLATE_OFFSETS]
    cases += [(s, t, 1) for s, t in TEMPLATE_LIMIT_CASES]
    for shape, tshape, off in cases:
        frames = unaligned(shape, off, rng, dev)
        tmpl = unaligned(tshape, 0, rng, dev)
        chk.same("match_template", K.match_template(frames, tmpl),
                 K.match_template_plain(frames, tmpl), f"{shape} {tshape} {off} B off")
    wide = torch.from_numpy(rng.integers(0, 256, (3, 50, 91), dtype=np.uint8)).to(dev)[:, :, 1:]
    tmpl = wide[0, 10:22, 30:45].contiguous()
    chk.same("match_template", gt.match_template(wide, tmpl),
             K.match_template_plain(wide.contiguous(), tmpl), "[:, :, 1:] of a wider batch")
    before = K.launch_counts()["match_template"]
    try:
        gt.match_template(torch.zeros((1, 10, 20000), dtype=torch.uint8, device=dev),
                          torch.zeros((4, 16513), dtype=torch.uint8, device=dev))
        raise AssertionError("a template of 66,052 pixels did not raise")
    except ValueError:
        pass
    if K.launch_counts()["match_template"] != before:
        raise AssertionError("a template of 66,052 pixels launched K19")
    torch.cuda.synchronize()

    steps = {}
    for name, img, cap in contour_frames(rng):
        g = torch.from_numpy(img).to(dev)
        table, label_map, _ = gt.blobs(g, cap)
        carried = torch.zeros_like(g)
        carried[::7, ::5] = 8
        carried[3::7, 2::5] = 9  # any non-zero byte counts as visited and keeps its value
        for i, kw in enumerate(_contour_modes(img, table, label_map, cap)):
            for mask_name, mask in (("fresh", torch.zeros_like(g)), ("carried", carried)):
                if "largest" in kw and mask_name == "carried":
                    continue  # largest always walks a fresh mask
                v_card, v_plain = mask.clone(), mask.clone()
                got = K.contour(g, v_card, **kw)
                ref = K.contour_plain(g, v_plain, **kw)
                mode = ("largest" if kw.get("largest") else
                        f"find {kw['max_contours']}" if "table" in kw else f"trace {kw['start']}")
                what = f"{name} {mode} {mask_name}"
                for field, a, b in zip(("rows", "flag", "steps"), got, ref):
                    chk.same("contour", a, b, f"{what} {field}")
                chk.same("contour", v_card, v_plain, f"{what} visited")
                steps[what] = int(ref[2].sum())
                if name == "noise_12x12" and i == 0 and steps[what] != 4 * 12 * 12 + 8:
                    raise AssertionError("the 12x12 noise walk did not run to the step bound")
        torch.cuda.synchronize()
    names = ("match_template", "contour")
    emit("template_contour_kernels_vs_plain", ok=True,
         template_cases=[[list(s), list(t), off] for s, t, off in cases],
         contour_frames=[name for name, _, _ in contour_frames(rng)], walks=len(steps),
         walk_steps=sum(steps.values()), longest_walks=sorted(steps.items(),
                                                              key=lambda kv: -kv[1])[:4],
         checks={k: chk.checks[k] for k in names}, max_abs_err={k: chk.max_err[k] for k in names})


def match_batch(dev):
    return torch.from_numpy(lena_batch(MATCH_N, MATCH_H, MATCH_W, roll=MATCH_ROLL)).to(dev)


def match_and_best(frames, tmpl):
    """``bench_all.py:241-244``: the score maps of a batch, then each map's best placement."""
    return gt.find_best_match(gt.match_template(frames, tmpl))


def phase_contour_template_path(chk, dev):
    """The new entry points through ``_launched``, against the single-device
    entry point, the plain path on the CPU and the goldens."""
    frames = match_batch(dev)
    tmpl = frames[0][MATCH_TMPL].contiguous()
    runs = []
    (xs, ys), counts = _launched(("match_template",), match_and_best, frames, tmpl)
    runs.append(counts)
    scores = gt.match_template(frames, tmpl)
    if counts["match_template"] != 1 or int(scores[0, ys[0], xs[0]]) != 255:
        raise AssertionError(f"match_template: {counts}, frame 0's best {int(xs[0]), int(ys[0])} "
                             "is not a perfect match")
    rows = [0, MATCH_N - 1]
    host = frames[rows].cpu()
    cpu_scores = gt.match_template(host, tmpl.cpu())
    if not torch.equal(scores[rows].cpu(), cpu_scores):
        raise AssertionError("match_template: card differs from the plain path on the CPU")
    for a, b in zip((xs[rows], ys[rows]), gt.find_best_match(cpu_scores)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("find_best_match: card differs from the CPU")
    h_loc = MATCH_H // SPACE
    for shape in ((1, SPACE), (2, SPACE)):
        mesh = card_mesh(shape, dev)
        for th, tw in ((32, 32), (h_loc, 40), (h_loc + 80, 24)):  # shorter, equal, taller
            t = frames[1, 100:100 + th, 50:50 + tw].contiguous()
            got, counts = _launched(("match_template",), gt.parallel.match_template_sharded,
                                    frames, t, mesh)
            runs.append(counts)
            if counts["match_template"] != shape[0] * shape[1]:
                raise AssertionError(f"{shape} match_template_sharded launched {counts}")
            chk.same("match_template", got, gt.match_template(frames, t),
                     f"{shape} match_template_sharded {th}x{tw} vs match_template")

    cim = twelve_blobs()
    g = torch.from_numpy(cim).to(dev)
    found, counts = _launched(("ccl", "contour"), gt.find_contours, g, CONTOUR_CAP, CONTOUR_BLOBS)
    runs.append(counts)
    if int(found.n) != 12:
        raise AssertionError(f"find_contours found {int(found.n)} contours, want 12")
    (largest, is_found), counts = _launched(("ccl", "contour"), gt.largest_blob_contour, g)
    runs.append(counts)
    traced, counts = _launched(("contour",), gt.trace_contour, g, (30, 20))
    runs.append(counts)
    carried, counts = _launched(("contour",), gt.trace_contour, g, (190, 20), traced.visited)
    runs.append(counts)
    for c in runs[-4:]:
        if c["contour"] != 1:
            raise AssertionError(f"a contour entry point launched K20 {c['contour']} times")
    with host_arrays_to("cpu"):
        ref = [gt.find_contours(cim, CONTOUR_CAP, CONTOUR_BLOBS), gt.largest_blob_contour(cim)]
        t1 = gt.trace_contour(cim, (30, 20))
        ref += [t1, gt.trace_contour(cim, (190, 20), t1.visited)]

    def flat(x):
        out = []
        for v in x:
            out += flat(v) if isinstance(v, tuple) else [v]
        return out

    for what, got, want in zip(("find_contours", "largest_blob_contour", "trace_contour",
                                "trace_contour carried"),
                               (found, (largest, is_found), traced, carried), ref):
        for a, b in zip(flat(got), flat(want)):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"{what}: card differs from the plain path on the CPU")

    g_npz = np.load(os.path.join(HERE, "tests", "golden", "goldens.npz"))
    res = gt.match_template(torch.from_numpy(g_npz["input"]).to(dev),
                            torch.from_numpy(g_npz["tmpl"]).to(dev))
    img = torch.from_numpy(g_npz["contour_input"]).to(dev)
    c1 = gt.trace_contour(img, (6, 5))
    c2 = gt.trace_contour(img, (42, 20), visited=c1.visited)
    c, f = gt.largest_blob_contour(img, max_blobs=16)
    got = {"match_template": res.cpu().numpy(),
           "contour1": np.array([*(int(v) for v in c1.box), int(c1.length)]),
           "contour2": np.array([*(int(v) for v in c2.box), int(c2.length)]),
           "contour_visited": c2.visited.cpu().numpy(),
           "largest_contour": np.array([int(f), *(int(v) for v in c.box), int(c.length),
                                        int(c.start.x), int(c.start.y)])}
    for key, value in got.items():
        if not np.array_equal(value.astype(np.int64), g_npz[key].astype(np.int64)):
            raise AssertionError(f"golden {key} differs on the card")
    launches = {name: sum(c[name] for c in runs) for name in KERNELS}
    emit("template_contour_path", ok=True, frames=MATCH_N, height=MATCH_H, width=MATCH_W,
         template=[32, 32], best_frame0=[int(xs[0]), int(ys[0])], launches=launches,
         launches_per_run=[{k: v for k, v in c.items() if v} for c in runs],
         meshes=[[1, SPACE], [2, SPACE]],
         sharded_templates=[[32, 32], [h_loc, 40], [h_loc + 80, 24]],
         contours=int(found.n), largest_found=bool(is_found),
         largest_box=[int(v) for v in largest.box], cpu_frames_checked=rows,
         goldens=list(got))
    return launches


def k19_design(n, h, w, th, tw):
    """Which of K19's designs takes an (n, h, w) batch and a (th, tw) template
    ("mma" or "int32", by ``csrc/template.cu``'s kMmaMinWidth and
    kMmaMaxWidth), and the byte products the tensor-core design issues: each
    warp of each band, for each template row, a 16 x 8 x 32 product for each
    of its kMmaR row tiles and each (chunk, column tile) pair whose Toeplitz
    tile is not all zero."""
    with open(os.path.join(HERE, "grayskull_tpu_torch", "csrc", "template.cu")) as f:
        src = f.read()
    c = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
         for name in ("kMmaMinWidth", "kMmaMaxWidth", "kMmaQ", "kMmaR", "kMmaWarpsX",
                      "kMmaWarpsY")}
    if not c["kMmaMinWidth"] <= tw <= c["kMmaMaxWidth"]:
        return "int32", None
    q, smax = c["kMmaQ"], (tw + 14) // 16
    pairs = sum(1 for u in range(0, q + smax, 2) for j in range(q) if -1 <= u - j <= smax)
    rh, rw = h - th + 1, w - tw + 1
    bands = n * -(-rh // (8 * c["kMmaR"] * c["kMmaWarpsY"])) * -(-rw // (16 * q * c["kMmaWarpsX"]))
    warps = bands * c["kMmaWarpsX"] * c["kMmaWarpsY"]
    return "mma", warps * th * c["kMmaR"] * pairs * 16 * 8 * 32


def phase_contour_template_timing(card, dev, parent=None):
    frames = match_batch(dev)
    tmpl = frames[0][MATCH_TMPL].contiguous()
    n, h, w = frames.shape
    th, tw = tmpl.shape
    t_match = timeit(match_and_best, frames, tmpl)
    cim = torch.from_numpy(twelve_blobs()).to(dev)
    if int(gt.find_contours(cim, CONTOUR_CAP, CONTOUR_BLOBS).n) != 12:
        raise AssertionError("find_contours on the 12-blob frame did not find 12")
    t_find = timeit(gt.find_contours, cim, CONTOUR_CAP, CONTOUR_BLOBS)
    t_largest = timeit(gt.largest_blob_contour, cim)
    emit("template_contour_timing", card=card,
         match_template_640x480_fps=n / t_match, match_ms_per_batch=t_match * 1e3,
         find_contours_12blob_640x480_ms=t_find * 1e3,
         largest_blob_contour_640x480_ms=t_largest * 1e3, frames=n, template=[th, tw],
         windows="median of 3 windows of 20 calls after 2 warm-up calls")

    # K19: the SSD is sum I^2 - 2 sum I*T + sum T^2, exact in integers, so the card's
    # least time is the correlation's byte products at the int8 tensor rate (a
    # multiply-add as two operations); the windowed sums of I^2 are not counted.
    # The committed design's own ceiling: the products it issues (its Toeplitz
    # tiles' zeros too) at that rate, or, for a template on the INT32 design, 2
    # INT32 instructions (__vabsdiffu4, __dp4a) each 4 squared differences.
    diffs = n * (h - th + 1) * (w - tw + 1) * th * tw
    F = torch.nn.functional
    frames_f = frames.to(torch.float32)[:, None]
    weight = tmpl.to(torch.float32)[None, None]
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True  # cuDNN's default choice took about 1 s a call
    try:
        conv_ms = timeit(F.conv2d, frames_f, weight, iters=3, warmup=1, repeat=1) * 1e3
    finally:
        torch.backends.cudnn.benchmark = benchmark
    del frames_f
    times = {"match_template": kernel_entry(
        timeit(K.match_template, frames, tmpl) * 1e3,
        timeit(K.match_template_plain, frames, tmpl, iters=1, repeat=1, warmup=1) * 1e3,
        frames.numel() + th * tw + n * (h - th + 1) * (w - tw + 1), {"int8_tensor": 2 * diffs},
        conv_ms, "conv2d of the float32 frames with the template, cudnn.benchmark on (the "
                 "correlation alone, not the SSD; cudnn.allow_tf32="
                 f"{torch.backends.cudnn.allow_tf32}): a yardstick")}
    design, issued = k19_design(n, h, w, th, tw)
    k19_ms, k19_parent_ms = device_turns(lambda: K.match_template(frames, tmpl), parent)
    times["match_template"].update(
        device_ms=k19_ms, parent_device_ms=k19_parent_ms, design=design,
        design_ceiling_ms=ops_ms({"int8_tensor": 2 * issued} if design == "mma" else
                                 {"int32": diffs / 2}),
        design_products=issued if design == "mma" else None,
        design_ceiling="the tensor-core design's issued byte products (m16n8k32 tiles, the "
                       "Toeplitz zeros included) at the int8 tensor rate" if design == "mma" else
                       "the INT32 design's issue time: __vabsdiffu4 + __dp4a each 4 squared "
                       "differences")

    # K20 at find_contours' call: the walks side by side, so a call's chain is
    # its longest walk, each step at least one dependent shared-memory load
    table, label_map, _ = gt.blobs(cim, CONTOUR_BLOBS)
    vis = torch.zeros_like(cim)

    def walks():
        vis.zero_()
        return K.contour(cim, vis, table=table, label_map=label_map, max_contours=CONTOUR_CAP)

    _, _, steps = walks()
    n_steps, longest = int(steps.sum()), int(steps.max())
    walk_ms = timeit(walks) * 1e3 - timeit(vis.zero_) * 1e3  # events, the memset apart
    # K20 alone (either template), against the parent's in turns
    walk_device_ms, walk_parent_ms = device_turns(walks, parent, kernel="contour_b")
    # the single walks: largest_blob_contour's, and a trace round the 40 x 128 spiral

    def largest():
        vis.zero_()
        return K.contour(cim, vis, table=table, label_map=label_map, largest=True)

    sp = torch.from_numpy(spiral(40, 128)).to(dev)
    sp_vis = torch.zeros_like(sp)

    def trace():
        sp_vis.zero_()
        return K.contour(sp, sp_vis, start=(0, 39))

    largest_steps, spiral_steps = int(largest()[2].sum()), int(trace()[2].sum())
    largest_ms, largest_parent_ms = device_turns(largest, parent, kernel="contour_b")
    spiral_ms, spiral_parent_ms = device_turns(trace, parent, kernel="contour_b")
    # the same walks on a frame past the shared-memory bitmaps: the byte path
    wide = torch.zeros((1000, 1000), dtype=torch.uint8, device=dev)
    wide[:480, :640] = cim
    wide_table, wide_map, _ = gt.blobs(wide, CONTOUR_BLOBS)
    wide_vis = torch.zeros_like(wide)

    def wide_walks():
        wide_vis.zero_()
        return K.contour(wide, wide_vis, table=wide_table, label_map=wide_map,
                         max_contours=CONTOUR_CAP)

    wide_steps = int(wide_walks()[2].max())
    wide_ms = timeit(wide_walks) * 1e3 - timeit(wide_vis.zero_) * 1e3
    hz = OP_RATES["fadd_chain"] * FADD_LATENCY_CYCLES
    mask = torch.zeros_like(cim)

    def plain_walks():
        mask.zero_()
        return K.contour_plain(cim, mask, table=table, label_map=label_map,
                               max_contours=CONTOUR_CAP)

    def per_step(ms, n):
        return None if ms is None else ms / n * 1e6

    # bytes: each step's 8 neighbours and mask byte
    times["contour"] = kernel_entry(
        walk_ms, timeit(plain_walks, iters=1, repeat=1, warmup=1) * 1e3, 9 * n_steps,
        {"shared_load_chain": longest}, None, "none: no contour walk in PyTorch")
    times["contour"].update(device_ms=walk_device_ms, parent_device_ms=walk_parent_ms,
                            steps=n_steps, longest_walk_steps=longest,
                            ns_per_longest_step=walk_device_ms / longest * 1e6,
                            byte_path_ms=wide_ms, byte_path_longest_steps=wide_steps,
                            step_bound="the longest walk's steps, one dependent shared-memory "
                                       f"load each, {SHARED_LOAD_LATENCY_CYCLES} cycles "
                                       "(chip_sweep.py --source contour) at the top SM clock")
    emit("template_contour_device_time", card=card,
         k19_device_ms=k19_ms, k19_parent_device_ms=k19_parent_ms, k19_design=design,
         k20_event_ms=walk_ms, k20_device_ms=walk_device_ms,
         k20_parent_device_ms=walk_parent_ms, k20_steps=n_steps, k20_longest_walk_steps=longest,
         k20_ns_per_longest_step=per_step(walk_device_ms, longest),
         k20_cycles_per_longest_step=walk_device_ms / longest * 1e-3 * hz,
         k20_largest_device_ms=largest_ms, k20_largest_parent_device_ms=largest_parent_ms,
         k20_largest_steps=largest_steps,
         k20_largest_ns_per_step=per_step(largest_ms, largest_steps),
         k20_largest_parent_ns_per_step=per_step(largest_parent_ms, largest_steps),
         k20_spiral_device_ms=spiral_ms, k20_spiral_parent_device_ms=spiral_parent_ms,
         k20_spiral_steps=spiral_steps, k20_spiral_ns_per_step=per_step(spiral_ms, spiral_steps),
         k20_spiral_parent_ns_per_step=per_step(spiral_parent_ms, spiral_steps),
         k20_byte_path_ms=wide_ms, k20_byte_path_longest_steps=wide_steps,
         source="device: torch.profiler device events of the kernel over 20 calls after a "
                "warm-up call (with a parent, the median of 4 turns each: parent, committed, "
                "committed, parent, twice); K20 events: CUDA events (timeit) of the memset "
                "and the kernel less those of the memset; byte path: the 12-blob frame in "
                "the corner of a 1000x1000 frame; spiral: trace_contour from (0, 39)")
    for name, entry in times.items():
        emit("kernel_time", card=card, kernel=name,
             shape=list(frames.shape) if name == "match_template" else list(cim.shape), **entry)
    for label, fn, args in (("match_template + find_best_match, 64 x 640x480", match_and_best,
                             (frames, tmpl)),
                            ("find_contours, 12 blobs", gt.find_contours,
                             (cim, CONTOUR_CAP, CONTOUR_BLOBS)),
                            ("largest_blob_contour, 12 blobs", gt.largest_blob_contour, (cim,))):
        emit("template_contour_profile", card=card, entry=label, **profile_calls(fn, *args))
    return times


# ---- the sparse sharded paths (parallel/sparse.py) and K10's rows entry ------------------
# ISSUE sizes: the binarized document (1024x768) on (1, 4) with cap 1000 and noise at
# density 0.55; the scanner on document.pgm and receipt.pgm to 1000x800 pages; ORB on
# aruco at 2,500 keypoints and a 480x640 lena frame at 500 (threshold 20); track's aruco
# tables matched at 300, distance 60; faces on the faces path's 32 frames over (2, 4)
SPARSE_MESH = (1, SPACE)
SPARSE_NOISE = 0.55
SPARSE_MATCHES, SPARSE_DIST = 300, 60
# K10's rows entry: (page, [(first row, rows)]): bands at the top, the middle and the
# bottom, one-row bands, pages of one row or one column
WARP_ROW_BANDS = [((1000, 800), [(0, 250), (250, 250), (750, 250), (0, 1), (500, 1), (999, 1)]),
                  ((347, 200), [(0, 87), (87, 173), (346, 1)]), ((1, 10), [(0, 1)]),
                  ((10, 1), [(0, 5), (5, 5), (9, 1)]), ((1, 1), [(0, 1)])]


def phase_sparse_kernels(chk, rng, dev):
    """K10's rows entry against its plain version: WARP_ROW_BANDS on the
    document's mild, steep and extreme quads and on random frames and quads."""
    docs = torch.from_numpy(document_batch(2)).to(dev)
    cases = [(docs, torch.tensor([q, q], dtype=torch.int32, device=dev))
             for q in WARP_QUADS.values()]
    for shape in ((3, 97, 200), (2, 1, 300), (2, 300, 1)):
        src = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        cases.append((src, torch.from_numpy(warp_edge_corners(rng, shape[0], *shape[1:])).to(dev)))
    n_checks = 0
    for src, corners in cases:
        for page, bands in WARP_ROW_BANDS:
            whole = K.quad_warp(src, corners, page)
            for row0, rows in bands:
                if row0 + rows > page[0]:
                    continue
                got = K.quad_warp_rows(src, corners, page, row0, rows)
                what = f"{tuple(src.shape)} page {page} rows {row0}+{rows}"
                chk.same("quad_warp_rows", got,
                         K.quad_warp_rows_plain(src, corners, page, row0, rows), what)
                chk.same("quad_warp_rows", got, whole[:, row0:row0 + rows], what + " vs quad_warp")
                n_checks += 1
        torch.cuda.synchronize()
    emit("sparse_kernels_vs_plain", ok=True, bands=[[list(p), [list(b) for b in bs]]
                                                    for p, bs in WARP_ROW_BANDS],
         sources=[list(src.shape) for src, _ in cases], checks=chk.checks["quad_warp_rows"],
         max_abs_err={"quad_warp_rows": chk.max_err["quad_warp_rows"]})


def _counted(fn, *args, **kwargs):
    """``fn(*args)`` with the counts set to 0 just before and read just after,
    and every host wait counted: PyTorch's sync debug mode "warn" raises one
    warning a synchronizing call.  Returns (output, launches, waits)."""
    torch.cuda.synchronize()
    K.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn(*args, **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    waits = sum("synchroniz" in str(w.message) for w in caught)
    return out, K.launch_counts(), waits


def faces_band_launches(cascade, h, w, nd, ns):
    """K5's launches in detect_faces_sharded over (nd, ns): per ladder scale,
    one a data shard and non-empty band of window rows."""
    plan = _grid_plan(cascade, h, w, *LADDER, 1)
    return sum(nd * sum(1 for s in range(ns) if s * -(-ny // ns) < ny) for *_, ny, _ in plan)


def _same_leaves(chk, owner, got, ref, what):
    """Every field of two tables (a Blobs' box and centroid flattened), by ``chk``."""
    def leaves(t):
        return [f for v in t for f in (v if isinstance(v, tuple) else (v,))]

    for i, (a, b) in enumerate(zip(leaves(got), leaves(ref))):
        chk.same(owner, a, b, f"{what} field {i}")


def phase_sparse_path(chk, dev):
    """The seven sparse sharded entry points on meshes of ``cuda:0``, each
    against its single-device entry point on the card (computed first), with
    its launches and host waits counted; the scanner and ORB once against the
    plain path on a CPU mesh."""
    par = gt.parallel
    mesh = card_mesh(SPARSE_MESH, dev)
    cascade = gt.load_frontalface()
    doc = torch.from_numpy(document_batch(1)[0]).to(dev)
    rec = torch.from_numpy(receipt_batch(1)[0]).to(dev)
    binary = gt.preprocess_binarize(doc)
    noise = torch.from_numpy(((np.random.default_rng(17).random(doc.shape) < SPARSE_NOISE)
                              * 255).astype(np.uint8)).to(dev)
    aruco = torch.from_numpy(_aruco()).to(dev)
    lena = torch.from_numpy(lena_batch(1, ORB_H, ORB_W)[0]).to(dev)
    tmpl = aruco[100:350, 150:450].contiguous()
    tk, sk, _ = gt.track(tmpl, aruco, TRACK_KPS)
    faces = torch.from_numpy(lena_batch(FACES_N, FACES_H, FACES_W, roll=7)).to(dev)
    mesh24 = card_mesh((2, 4), dev)
    ns = SPARSE_MESH[1]
    scan_counts = {"blur_hist_window": ns, "otsu": 1, "ccl": ns, "blob_stats": ns,
                   "quad_warp_rows": ns}
    orb_counts = {"fast": ns, "orb_moments": ns, "orb_brief": ns}
    faces_counts = {"integral": 8,
                    "lbp_eval_scale": faces_band_launches(cascade, FACES_H, FACES_W, 2, 4)}
    # (label, sharded call, single-device call, launches wanted, host waits wanted, owner)
    calls = [
        ("label_components_sharded document", (par.label_components_sharded, binary, mesh),
         (gt.label_components, binary), {"ccl": ns}, 1, "ccl"),
        (f"label_components_sharded noise {SPARSE_NOISE}", (par.label_components_sharded, noise,
                                                            mesh),
         (gt.label_components, noise), {"ccl": ns}, 1, "ccl"),
        ("blobs_sharded document", (par.blobs_sharded, binary, mesh, SCAN_CAP),
         (lambda x, cap: gt.blobs(x, cap)[0], binary, SCAN_CAP), {"ccl": ns, "blob_stats": ns}, 1,
         "ccl"),
        ("scan_spatial_shardmap document", (par.scan_spatial_shardmap, doc, mesh, SCAN_PAGE,
                                            SCAN_CAP),
         (gt.scan, doc, SCAN_PAGE, SCAN_CAP), scan_counts, 1, "quad_warp_rows"),
        ("scan_spatial_shardmap receipt", (par.scan_spatial_shardmap, rec, mesh, SCAN_PAGE,
                                           SCAN_CAP),
         (gt.scan, rec, SCAN_PAGE, SCAN_CAP), scan_counts, 1, "quad_warp_rows"),
        ("orb_extract_spatial aruco", (par.orb_extract_spatial, aruco, mesh, TRACK_KPS, ORB_THR),
         (gt.orb_extract, aruco, TRACK_KPS, ORB_THR), orb_counts, 0, None),
        ("orb_extract_spatial lena 480x640", (par.orb_extract_spatial, lena, mesh, ORB_CAP,
                                              ORB_THR),
         (gt.orb_extract, lena, ORB_CAP, ORB_THR), orb_counts, 0, None),
        ("match_orb_sharded track aruco", (par.match_orb_sharded, tk, sk, mesh, SPARSE_MATCHES,
                                           SPARSE_DIST),
         (gt.match_orb, tk, sk, SPARSE_MATCHES, SPARSE_DIST), {}, 0, "match"),
        (f"detect_faces_sharded {FACES_N} frames (2, 4)",
         (par.detect_faces_sharded, faces, mesh24, cascade, FACES_CAP),
         (gt.detect_faces, faces, cascade, FACES_CAP), faces_counts, 0, "lbp_eval_scale"),
    ]
    launches = {name: 0 for name in KERNELS}
    report = []
    for label, (fn, *args), (single, *single_args), want, want_waits, owner in calls:
        ref = single(*single_args)
        got, counts, waits = _counted(fn, *args)
        launched = {k: v for k, v in counts.items() if v}
        if launched != want:
            raise AssertionError(f"{label} launched {launched}, want {want}")
        if waits != want_waits:
            raise AssertionError(f"{label} waited on the host {waits} times, want {want_waits}")
        for k in KERNELS:
            launches[k] += counts[k]
        if owner is None:
            _same_tables(chk, got, ref, label)
        elif owner == "match":
            for a, b in zip(got, ref):
                if not torch.equal(a, b):
                    raise AssertionError(f"{label} differs from match_orb on the card")
        elif isinstance(got, tuple) and label.startswith("scan"):
            chk.same("quad_warp_rows", got[0], ref[0], f"{label} page")
            chk.same("ccl", got[1], ref[1], f"{label} corners")
        elif isinstance(got, torch.Tensor):
            chk.same(owner, got, ref, label)
        else:
            _same_leaves(chk, owner, got, ref, label)
        report.append({"call": label, "launches": launched, "host_waits": waits})
    # once against the plain path on a CPU mesh: the scanner, and ORB in exact_host trig
    cpu_mesh = gt.parallel.make_mesh(SPARSE_MESH, devices=["cpu"] * ns)
    page, corners = par.scan_spatial_shardmap(doc, mesh, SCAN_PAGE, SCAN_CAP)
    cpu_page, cpu_corners = par.scan_spatial_shardmap(doc.cpu(), cpu_mesh, SCAN_PAGE, SCAN_CAP)
    if not (torch.equal(page.cpu(), cpu_page) and torch.equal(corners.cpu(), cpu_corners)):
        raise AssertionError("scan_spatial_shardmap: card differs from the plain path on the CPU")
    libm32.use_exact_host_libm(True)
    try:
        _equal_on_cpu(par.orb_extract_spatial(aruco, mesh, TRACK_KPS, ORB_THR),
                      par.orb_extract_spatial(aruco.cpu(), cpu_mesh, TRACK_KPS, ORB_THR),
                      "exact_host orb_extract_spatial")
    finally:
        libm32.use_exact_host_libm(False)
    emit("sparse_path", ok=True, mesh=list(SPARSE_MESH), faces_mesh=[2, 4],
         devices=[str(d) for d in mesh.devices.flat], calls=report, launches=launches,
         blobs=int(gt.parallel.blobs_sharded(binary, mesh, SCAN_CAP).n),
         corners_document=corners.tolist(),
         cpu_checked=["scan_spatial_shardmap document", "orb_extract_spatial aruco (exact_host)"],
         host_waits="counted in sync debug mode 'warn', one warning a synchronizing call")
    inputs = {"binary": binary, "noise": noise, "doc": doc, "rec": rec, "aruco": aruco,
              "lena": lena, "tk": tk, "sk": sk, "faces": faces, "corners": corners,
              "calls": calls}
    return launches, inputs


def band_footprint(corners, size, row0, rows, sh, sw):
    """The source box (rows, columns) that page rows ``row0 .. row0 + rows - 1``
    sample: the coordinates are bilinear in (u, v), so their extremes lie at
    the band's four corner pixels; each sample also reads the next row and
    column."""
    c = corners.reshape(4, 2).cpu().numpy().astype(np.float64)
    dh = size[0]
    pts = []
    for u in (0.0, 1.0):
        for v in (row0 / (dh - 1) if dh > 1 else 0.0, (row0 + rows - 1) / (dh - 1) if dh > 1
                  else 0.0):
            top = c[0] * (1 - u) + c[1] * u
            bot = c[3] * (1 - u) + c[2] * u
            pts.append(top * (1 - v) + bot * v)
    pts = np.clip(np.array(pts), 0, [sw - 1, sh - 1])
    lo, hi = np.floor(pts.min(0)), np.minimum(np.floor(pts.max(0)) + 1, [sw - 1, sh - 1])
    return int(hi[1] - lo[1] + 1), int(hi[0] - lo[0] + 1)


def phase_sparse_timing(card, inputs):
    """Each sharded call's ms (CUDA events) beside its single-device call's,
    with the sharded call's idle share; K10's rows entry at the scanner's
    middle band."""
    rows_out = []
    for label, (fn, *args), (single, *single_args), _, waits, _ in inputs["calls"]:
        t_sharded = timeit(fn, *args)
        t_single = timeit(single, *single_args)
        prof = profile_calls(fn, *args)
        rows_out.append({"call": label, "sharded_ms": t_sharded * 1e3,
                         "single_device_ms": t_single * 1e3,
                         "sharded_over_single": t_sharded / t_single, "host_waits": waits,
                         "idle_share": prof["idle_share"], "device_busy_ms": prof["device_busy_ms"],
                         "enqueue_ms": prof["enqueue_ms"],
                         "device_ms_by_kernel": prof["device_ms_by_kernel"][:6]})
    emit("sparse_timing", card=card, mesh=list(SPARSE_MESH), calls=rows_out,
         windows="median of 3 windows of 20 calls after 2 warm-up calls (CUDA events); idle "
                 "share: chip_smoke.profile_calls over 10 calls")
    doc = inputs["doc"][None].contiguous()
    corners = inputs["corners"][None].contiguous()
    sh, sw = doc.shape[1:]
    dh, dw = SCAN_PAGE
    band = dh // SPARSE_MESH[1]
    row0 = band  # the second shard's band
    fr, fc = band_footprint(corners, SCAN_PAGE, row0, band, sh, sw)
    entry = kernel_entry(
        timeit(K.quad_warp_rows, doc, corners, SCAN_PAGE, row0, band) * 1e3,
        timeit(K.quad_warp_rows_plain, doc, corners, SCAN_PAGE, row0, band, iters=3) * 1e3,
        fr * fc + 32 + band * dw, warp_ops(1, band, dw), None,
        "none: no PyTorch call gives the reference's rounded bilinear quad warp")
    entry.update(device_ms=device_ms(lambda: K.quad_warp_rows(doc, corners, SCAN_PAGE, row0,
                                                              band)),
                 footprint_rows=fr, footprint_columns=fc, band=[row0, band],
                 bytes_counted="the source box the band samples, the corners, the band's rows")
    emit("kernel_time", card=card, kernel="quad_warp_rows", shape=list(doc.shape),
         page=list(SCAN_PAGE), **entry)
    return {"quad_warp_rows": entry}


# --- the freestanding trig (K21), debug.py and the two demos ----------------------

ORB_MOMENT = 255 * 709 * 15  # |m01|, |m10| < 255 * (disc pixels) * radius
FS_SWEEP = 1 << 20  # K21's sweep: (y, x) pairs and sine inputs
FS_COS_OFFSET = 1.57079  # the reference's cosine is gs_sin(angle + 1.57079f)
# the loop-end cases (NaN), then the largest input below the bound (the first
# loop's 166,886 steps) and -(2^18 + 1/4) (the second loop's 41,722)
FS_LOOP_END = (np.inf, -np.inf, np.nan, 2.0**27, -(2.0**27), 2.0**20, -(2.0**20), 3.4e38)
FS_INSIDE = (float(np.nextafter(np.float32(2.0**20), np.float32(0))), -(2.0**18 + 0.25))
FS_OWNER = {"angle": "freestanding", "descriptor": "orb_brief"}
# fs_moment_pairs' edges: 0, +-1, both ends of int32, odd values past 2^24
# (the cast to float32 rounds them)
FS_MOMENT_EDGES = (0, 1, -1, 2, -2, -2**31, 2**31 - 1, -2**31 + 1, 2**24 + 1, -(2**24 + 1),
                   2**25 + 3, 2**30 + 7)
FS_FLUSH_BYTES = 128 << 20  # written between the cold sweep's calls: past the 50 MB L2
FS_PATH_LAUNCHES = {"orb_extract": 1, "track": 6, "orb_extract_spatial": 1}  # K21's
# SASS opcodes that issue on the FP32 pipe, and those at the conversion rate
# (the SFU's MUFU, and I2F)
FP32_PIPE_OPS = ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FCHK", "FSET", "I2FP")
CONVERSION_OPS = ("MUFU", "I2F")
# An empty kernel with gs_fs_orient's arguments: the device time of a launch
# of a grid, the floor under K21's call.
LAUNCH_FLOOR_SOURCE = r"""#include <cstddef>
#include <cuda_runtime.h>

__global__ void launch_floor_kernel(const int*, const int*, float*, float*, float*, size_t,
                                    bool) {}

extern "C" int gs_launch_floor(unsigned blocks, unsigned threads, void* stream) {
  launch_floor_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      nullptr, nullptr, nullptr, nullptr, nullptr, 0, false);
  return cudaGetLastError();
}
"""
STREAM_SPEC = "blur:1,threshold:otsu,blobs,keypoints,faces,contours"
STREAM_FRAMES, STREAM_SIZE = 32, "480x640"
LIVE_FRAMES, LIVE_H, LIVE_W = 8, 240, 320


def fs_atan2_inputs(rng, n=FS_SWEEP):
    """(y, x) float32 pairs: ORB's integer moments, +-1e6 uniforms, and a
    moment against +-0.0 on each axis, the four signed-zero pairs among them."""
    third = n // 3
    rest = n - 2 * third
    half = rest // 2
    moments = rng.integers(-ORB_MOMENT, ORB_MOMENT, (2, third)).astype(np.float64)
    uniform = rng.uniform(-1e6, 1e6, (2, third))
    axes = np.zeros((2, rest))
    axes[0, :half] = rng.integers(-ORB_MOMENT, ORB_MOMENT, half)  # (y, +-0.0)
    axes[1, half:] = rng.integers(-ORB_MOMENT, ORB_MOMENT, rest - half)  # (+-0.0, x)
    axes[0, :4], axes[1, :4] = 0.0, 0.0
    signs = np.where(np.arange(rest) % 2 == 0, 1.0, -1.0)
    axes[1, :half] *= signs[:half]  # +0.0 and -0.0 in turns
    axes[0, half:] *= signs[half:]
    axes[:, :4] *= np.array([[1.0, -1.0, 1.0, -1.0], [1.0, 1.0, -1.0, -1.0]])
    yx = np.concatenate([moments, uniform, axes], axis=1).astype(np.float32)
    return torch.from_numpy(yx[0].copy()), torch.from_numpy(yx[1].copy())


def fs_sin_inputs(rng, n=FS_SWEEP):
    """float32 sine inputs: +-30 (both reduction loops, up to 5 steps) and ORB's
    angles, [-pi, pi] (taken with and without the cosine's offset)."""
    wide = torch.from_numpy(rng.uniform(-30.0, 30.0, n).astype(np.float32))
    orb = torch.from_numpy(rng.uniform(-np.pi, np.pi, n // 4).astype(np.float32))
    return wide, orb


def fs_moment_pairs(rng, n=FS_SWEEP):
    """int32 (m01, m10): every pair of FS_MOMENT_EDGES (0/0, +-1, int32's ends,
    odd values past 2^24), a small m01 against a large negative m10 (angles
    near +-pi), ORB's moment range and uniform int32s (a quarter of their
    angles put the cosine's input past pi, where its range reduction steps)."""
    edge = np.array(FS_MOMENT_EDGES, np.int64)
    ey, ex = (v.ravel() for v in np.meshgrid(edge, edge))
    k = (n - ey.size) // 3
    near_pi = (rng.integers(-3, 4, k), -rng.integers(1, 2**31, k))
    orb = rng.integers(-ORB_MOMENT, ORB_MOMENT, (2, k))
    uniform = rng.integers(-2**31, 2**31, (2, n - ey.size - 2 * k))
    m01 = np.concatenate([ey, near_pi[0], orb[0], uniform[0]]).astype(np.int32)
    m10 = np.concatenate([ex, near_pi[1], orb[1], uniform[1]]).astype(np.int32)
    return torch.from_numpy(m01), torch.from_numpy(m10)


def orient_threads():
    """gs_fs_orient's threads a block (an element each), read from its source."""
    text = (_build.CSRC_DIR / "freestanding.cu").read_text()
    return int(re.search(r"constexpr int kOrientThreads = (\d+);", text).group(1))


def check_orient(chk, dev, m01, m10, what, offsets=(0,)):
    """``fs_orient`` on the card against ``fs_orient_plain`` on the CPU, as int32
    bits, with the operands ``4 * lo`` bytes into their buffers for each lo."""
    F = K.freestanding
    m01, m10 = m01.cpu().contiguous(), m10.cpu().contiguous()
    want = F.fs_orient_plain(m01, m10)
    on_card = m01.to(dev), m10.to(dev)
    for lo in offsets:
        got = F.fs_orient(on_card[0][lo:], on_card[1][lo:])
        for name, a, b in zip(("angle", "sin", "cos"), got, want):
            chk.same("freestanding", a.cpu().view(torch.int32), b[lo:].view(torch.int32),
                     f"fs_orient {name}, {what} at +{4 * lo} B")
    return want


def phase_freestanding_kernels(chk, rng, dev):
    """K21 against its plain versions, bit for bit: ``fs_orient`` on 1 M int32
    moment pairs (the operands 0, 4 and 12 bytes into their buffers), 1 M (y, x) pairs
    and 1 M sine inputs on the card; the loop-end cases and the largest inputs
    inside the bound against the plain version on the CPU (its loops test on
    the host)."""
    F = K.freestanding
    m01, m10 = fs_moment_pairs(rng)
    angle, _, _ = check_orient(chk, dev, m01, m10, f"{m01.numel()} pairs",
                               offsets=(0, 1, 3))
    cast = m01.to(torch.float32).to(torch.int64) != m01.to(torch.int64)
    orient_cases = {"pairs": m01.numel(), "moments_the_cast_rounds": int(cast.sum()),
                    "angles_near_pi": int((angle.abs() > 3.14).sum()),
                    "cosine_inputs_past_pi": int((angle + float(np.float32(FS_COS_OFFSET))
                                                  > float(np.float32(3.141592))).sum())}
    y, x = (t.to(dev) for t in fs_atan2_inputs(rng))
    chk.same("freestanding", F.fs_atan2(y, x).view(torch.int32),
             F.fs_atan2_plain(y, x).view(torch.int32), f"atan2 sweep of {y.numel()}")
    wide, orb = (t.to(dev) for t in fs_sin_inputs(rng))
    for name, a, offset in (("sin +-30", wide, None), ("sin ORB range", orb, None),
                            ("cos ORB range", orb, FS_COS_OFFSET),
                            ("cos +-30", wide, FS_COS_OFFSET)):
        chk.same("freestanding", F.fs_sin(a, offset).view(torch.int32),
                 F.fs_sin_plain(a, offset).view(torch.int32), name)
    ends = torch.tensor(FS_LOOP_END + FS_INSIDE, dtype=torch.float32)
    got = F.fs_sin(ends.to(dev)).cpu()
    chk.same("freestanding", got.view(torch.int32), F.fs_sin_plain(ends).view(torch.int32),
             "loop ends and the bound")
    if not torch.isnan(got[:len(FS_LOOP_END)]).all() or torch.isnan(got[len(FS_LOOP_END):]).any():
        raise AssertionError(f"K21: the sine past and inside the bound gave {got.tolist()}")
    ends = ends[[i for i, v in enumerate(FS_LOOP_END) if abs(v) != 2.0**20]]  # stay NaN
    chk.same("freestanding", F.fs_sin(ends.to(dev), FS_COS_OFFSET).cpu().view(torch.int32),
             F.fs_sin_plain(ends, FS_COS_OFFSET).view(torch.int32), "loop ends, cosine")
    specials = torch.tensor([[np.nan, 1.0, np.inf, 0.0, -0.0, 5.0, -5.0, 0.0],
                             [1.0, np.nan, np.inf, -0.0, 0.0, -0.0, 0.0, 0.0]],
                            dtype=torch.float32)
    chk.same("freestanding", F.fs_atan2(specials[0].to(dev), specials[1].to(dev)).cpu()
             .view(torch.int32), F.fs_atan2_plain(specials[0], specials[1]).view(torch.int32),
             "atan2 NaN, inf and signed zeros")
    torch.cuda.synchronize()
    emit("freestanding_kernels_vs_plain", ok=True, orient=orient_cases, atan2_pairs=y.numel(),
         sin_inputs=2 * (wide.numel() + orb.numel()), loop_end_cases=list(map(str, FS_LOOP_END)),
         inside_bound=list(FS_INSIDE),
         max_abs_err=chk.max_err["freestanding"], checks=chk.checks["freestanding"])


def _same_fs_tables(chk, got, ref, what):
    for name, a, b in zip(got._fields, _table_bits(got), _table_bits(ref)):
        chk.same(FS_OWNER.get(name, "fast"), a, b, f"{what} {name}")


def phase_freestanding_path(chk, dev, orb_frames):
    """The ORB entry points in the freestanding mode, K21 on the card: each
    call with the counts at 0 and its host waits counted (none), its tables
    against the plain path on the card (the plain trig, not K21) and on the CPU."""
    batch, tmpl, scene, _ = orb_frames
    mesh = card_mesh(SPARSE_MESH, dev)
    cpu_mesh = gt.parallel.make_mesh(SPARSE_MESH, devices=["cpu"] * int(np.prod(SPARSE_MESH)))
    spatial = gt.parallel.orb_extract_spatial
    calls = [  # (name, card call, card plain path, CPU call)
        ("orb_extract", (gt.orb_extract, batch, ORB_CAP, ORB_THR),
         (lambda: gt.orb_extract(batch, ORB_CAP, ORB_THR, force_reference=True)),
         (lambda: gt.orb_extract(batch.cpu(), ORB_CAP, ORB_THR))),
        ("track", (gt.track, tmpl, scene, TRACK_KPS),
         (lambda: gt.track(tmpl, scene, TRACK_KPS, force_reference=True)),
         (lambda: gt.track(tmpl.cpu(), scene.cpu(), TRACK_KPS))),
        ("orb_extract_spatial", (spatial, scene, mesh, TRACK_KPS, ORB_THR),
         (lambda: spatial(scene, mesh, TRACK_KPS, ORB_THR, kernels=False)),
         (lambda: spatial(scene.cpu(), cpu_mesh, TRACK_KPS, ORB_THR))),
    ]
    launches = {name: 0 for name in KERNELS}
    report = {}
    libm32.use_freestanding(True)
    try:
        for name, (fn, *args), plain, on_cpu in calls:
            fn(*args)  # any first-call upload happens outside the counted call
            out, counts, waits = _counted(fn, *args)
            missing = [k for k in ORB_KERNELS if counts[k] < 1]
            if missing or waits or counts["freestanding"] != FS_PATH_LAUNCHES[name]:
                raise AssertionError(f"freestanding {name}: launches {counts}, {waits} host waits, "
                                     f"K21 expected {FS_PATH_LAUNCHES[name]}")
            tables, refs, cpus = ((t if name == "track" else (t,))
                                  for t in (out, plain(), on_cpu()))
            for got, ref, cpu in zip(tables, refs, cpus):
                _same_fs_tables(chk, got, ref, f"freestanding {name} vs plain path")
                _equal_on_cpu(got, cpu, f"freestanding {name}")
            for k in KERNELS:
                launches[k] += counts[k]
            report[name] = {"launches": {k: v for k, v in counts.items() if v},
                            "host_waits": waits,
                            "keypoints": [int(t.n.sum()) for t in tables if hasattr(t, "angle")]}
        free_mode = gt.orb_extract(batch[:2], ORB_CAP, ORB_THR)
        check_orient(chk, dev, *orb_call_moments(batch), "orb_extract's call")
        profiles = {"freestanding": profile_calls(gt.orb_extract, batch, ORB_CAP, ORB_THR)}
    finally:
        libm32.use_freestanding(False)
    profiles["fast"] = profile_calls(gt.orb_extract, batch, ORB_CAP, ORB_THR)
    angles_changed = int((gt.orb_extract(batch[:2], ORB_CAP, ORB_THR).angle.view(torch.int32)
                          != free_mode.angle.view(torch.int32)).sum())
    if angles_changed < ORB_CAP:
        raise AssertionError(f"freestanding mode changed only {angles_changed} angles")
    emit("freestanding_path", ok=True, frames=ORB_N, max_kps=ORB_CAP, track_kps=TRACK_KPS,
         mesh=list(SPARSE_MESH), calls=report, angles_changed_vs_fast_two_frames=angles_changed,
         orb_extract_profile={mode: {k: p[k] for k in ("device_launches_a_call", "device_kernels",
                                                       "device_busy_ms", "timed_ms", "idle_share",
                                                       "device_ms_by_kernel")}
                              for mode, p in profiles.items()},
         compared=["card vs plain path on the card (plain trig)", "card vs CPU, bit for bit",
                   "fs_orient at orb_extract's call vs fs_orient_plain on the CPU"])
    return launches


def phase_debug(dev):
    """``debug`` on card tensors: dumps read back equal to the CPU's, overlays
    of card tables equal to those of the CPU's tables, the NaN guard."""
    from grayskull_tpu_torch import debug

    launches = {name: 0 for name in KERNELS}
    frames = torch.from_numpy(lena_batch(3, LIVE_H, LIVE_W)).to(dev)
    ramp = (torch.linspace(-3.0, 5.0, LIVE_H * LIVE_W, device=dev).view(LIVE_H, LIVE_W) ** 2)
    with tempfile.TemporaryDirectory(dir=HERE) as work:
        card = debug.dump(frames, "card_u8", work) + debug.dump(ramp, "card_f", work)
        cpu = debug.dump(frames.cpu(), "cpu_u8", work) + debug.dump(ramp.cpu(), "cpu_f", work)
        for a, b in zip(card, cpu):
            if open(a, "rb").read() != open(b, "rb").read():
                raise AssertionError(f"debug.dump: {a} differs from the CPU's {b}")
        for i, p in enumerate(card[:3]):
            if not np.array_equal(read_pgm(p), frames[i].cpu().numpy()):
                raise AssertionError(f"debug.dump: {p} does not read back")
    frame = frames[0]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    rects = gt.detect_faces(frame, step=2)
    kps = gt.orb_extract(frame, ORB_CAP, ORB_THR)
    host = frame.cpu().numpy()
    rect_overlay = debug.draw_rects(host, rects)
    cross_overlay = debug.draw_crosses(frame, kps)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    for k in KERNELS:
        launches[k] += counts[k]
    if int(rects.n) < 1 or int(kps.n) < 1:
        raise AssertionError(f"debug: {int(rects.n)} faces, {int(kps.n)} keypoints to draw")
    if (not np.array_equal(rect_overlay, debug.draw_rects(host, gt.detect_faces(frame.cpu(),
                                                                                 step=2)))
            or not np.array_equal(cross_overlay,
                                  debug.draw_crosses(host, gt.orb_extract(frame.cpu(), ORB_CAP,
                                                                          ORB_THR)))):
        raise AssertionError("debug: an overlay of card tables differs from the CPU tables'")
    try:
        with debug.nan_guard():
            z = torch.zeros(64, device=dev)
            inf = torch.ones(64, device=dev) / z  # inf is not NaN
            torch.empty(1 << 20, device=dev)
            z / z
        raise AssertionError("debug.nan_guard: no FloatingPointError on 0/0 on the card")
    except FloatingPointError:
        pass
    emit("debug", ok=True, dumps=len(card), faces=int(rects.n), keypoints=int(kps.n),
         inf_passed=bool(torch.isinf(inf).all()),
         compared=["dump bytes (uint8 batch, float frame) card vs CPU",
                   "draw_rects of detect_faces, draw_crosses of orb_extract: card vs CPU tables",
                   "nan_guard raises on 0/0 on the card, not on 1/0 or torch.empty"])
    return launches


class _DemoServer:
    """A live demo's HTTP server on a free local port, in a thread."""

    def __init__(self, module, demo):
        import http.client
        import threading

        self.srv = module.ThreadingHTTPServer(("127.0.0.1", 0), module.make_handler(demo))
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()
        self.conn = http.client.HTTPConnection("127.0.0.1", self.srv.server_address[1],
                                               timeout=300)

    def ask(self, method, path, body=None):
        self.conn.request(method, path, body)
        resp = self.conn.getresponse()
        return resp.status, resp.read()

    def close(self):
        self.conn.close()
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join()


def live_requests(frames):
    body = np.asarray(frames[2]).tobytes()
    return [
        ("GET", "/", None),
        ("GET", "/frame?i=1&pipeline=blur:1,threshold:otsu"
                "&analyzers=blobs,keypoints,faces,contours,orb", None),
        ("GET", "/frame?i=9&pipeline=sobel,blobs&analyzers=keypoints", None),
        ("GET", "/frame?i=0&pipeline=nosuchop&analyzers=", None),
        ("POST", "/frame?pipeline=blur:1&analyzers=keypoints,contours", body),
        ("POST", "/frame?capture=1", body),
        ("POST", "/frame?pipeline=blur:1&analyzers=orb", np.asarray(frames[3]).tobytes()),
        ("POST", "/frame?pipeline=blur:1", body[:100]),
        ("POST", "/frame?pipeline=adaptive:5:5,bogus", body),
    ]


def phase_demos(dev):
    """The stream demo's ``main`` at its defaults but the spec (32 synthetic
    frames of 480x640), its last two frames and overlay against the same run on
    the CPU; the live demo on the card behind a local server, every response
    against a CPU demo's."""
    sys.path.insert(0, os.path.join(HERE, "examples"))
    import live_demo_torch
    import stream_demo_torch

    launches = {name: 0 for name in KERNELS}
    with tempfile.TemporaryDirectory(dir=HERE) as work:
        card_dir, cpu_dir = os.path.join(work, "card"), os.path.join(work, "cpu")
        buf = io.StringIO()
        torch.cuda.synchronize()
        K.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            stream_demo_torch.main(["--pipeline", STREAM_SPEC, "--frames", str(STREAM_FRAMES),
                                    "--size", STREAM_SIZE, "--out", card_dir])
        torch.cuda.synchronize()
        stream_counts = K.launch_counts()
        card_lines = buf.getvalue().splitlines()
        h, w = (int(v) for v in STREAM_SIZE.split("x"))
        frames = stream_demo_torch.synth_frames(STREAM_FRAMES, h, w)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            stream_demo_torch.process_stream(torch.from_numpy(frames[-2:]), STREAM_SPEC, cpu_dir)
        cpu_lines = buf.getvalue().splitlines()
        pairs = [(f"frame_{STREAM_FRAMES - 2 + i:04d}.pgm", f"frame_{i:04d}.pgm") for i in (0, 1)]
        for a, b in pairs + [("overlay.pgm", "overlay.pgm")]:
            if (open(os.path.join(card_dir, a), "rb").read()
                    != open(os.path.join(cpu_dir, b), "rb").read()):
                raise AssertionError(f"stream demo: {a} differs from the CPU run's {b}")
        written = len(os.listdir(card_dir))
    found = [ln for ln in card_lines if ln.startswith("  ") and "wrote" not in ln]
    if found != [ln for ln in cpu_lines if "wrote" not in ln] or written != STREAM_FRAMES + 1:
        raise AssertionError(f"stream demo: card printed {card_lines}, CPU {cpu_lines}")
    missing = [k for k in ("blur_hist", "otsu", "ccl", "fast", "integral", "lbp_eval_scale",
                           "contour") if stream_counts[k] < 1]
    if missing:
        raise AssertionError(f"stream demo did not launch {missing}: {stream_counts}")

    live = stream_demo_torch.synth_frames(LIVE_FRAMES, LIVE_H, LIVE_W)
    card = _DemoServer(live_demo_torch, live_demo_torch.Demo(live, device=dev))
    cpu = _DemoServer(live_demo_torch, live_demo_torch.Demo(live, device="cpu"))
    statuses = []
    try:
        for method, path, body in live_requests(live):
            torch.cuda.synchronize()
            K.reset_launch_counts()
            got = card.ask(method, path, body)
            torch.cuda.synchronize()
            counts = K.launch_counts()
            for k in KERNELS:
                launches[k] += counts[k]
            want = cpu.ask(method, path, body)
            same = (got[0] == want[0] and (json.loads(got[1]) == json.loads(want[1])
                                           if got[1][:1] == b"{" else got[1] == want[1]))
            if not same:
                raise AssertionError(f"live demo {method} {path}: card {got[0]} differs from "
                                     f"the CPU's {want[0]}")
            statuses.append([method, path.split("&")[0], got[0]])
    finally:
        card.close()
        cpu.close()
    if [s[2] for s in statuses].count(400) != 3:
        raise AssertionError(f"live demo: expected three 400s, got {statuses}")
    missing = [k for k in ("blur_hist", "otsu", "ccl", "fast", "orb_moments", "orb_brief",
                           "integral", "lbp_eval_scale", "contour") if launches[k] < 1]
    if missing:
        raise AssertionError(f"live demo did not launch {missing}: {launches}")
    emit("demos", ok=True, stream_fps_line=card_lines[0], stream_lines=found,
         stream_launches={k: v for k, v in stream_counts.items() if v},
         stream_compared=["frames 30 and 31", "overlay.pgm", "analyzer lines"],
         live_size=[LIVE_H, LIVE_W], live_requests=statuses,
         live_launches={k: v for k, v in launches.items() if v})
    return {k: launches[k] + stream_counts[k] for k in KERNELS}, card_lines[0]


def sass_instructions(kernels=("fs_orient_kernel", "fs_atan2_kernel", "fs_sin_kernel")):
    """{kernel: {opcode: count}} of the FP32-pipe and conversion-rate instructions
    in each named kernel's SASS (``cuobjdump -sass`` of the built library):
    every instruction of its code once, the division's slow path and the NaN
    exit included, so an upper count of one thread's; None if ``cuobjdump``
    fails."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    try:
        sass = subprocess.run([tool, "-sass", str(_build.build())], capture_output=True,
                              text=True, timeout=300, check=True).stdout
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        emit("sass", ok=False, error=str(e)[:300])
        return None
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in kernels if k in line), None)
            if current:
                counts[current] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
        if current and m and m.group(1) in FP32_PIPE_OPS + CONVERSION_OPS:
            counts[current][m.group(1)] = counts[current].get(m.group(1), 0) + 1
    return counts if all(k in counts for k in kernels) else None


def sine_steps(x):
    """The range reduction's steps over the float32 tensor ``x`` (|x| < 2^20)."""
    pi, two_pi = float(np.float32(3.141592)), float(np.float32(6.283185))
    steps = 0
    for over, step in ((lambda t: t > pi, -two_pi), (lambda t: t < -pi, two_pi)):
        v = x
        while True:
            m = over(v)
            k = int(m.sum())
            if not k:
                break
            steps += k
            v = torch.where(m, v + step, v)
    return steps


def fs_ops(sass, kernel, n, sin_inputs=()):
    """``n`` elements of the K21 kernel ``kernel`` (a thread an element) by kind:
    its SASS instructions an element and, in the sine, two (a compare and an
    add) a reduction step the data ``sin_inputs`` takes."""
    if sass is None:
        return 0
    fp32 = sum(c for op, c in sass[kernel].items() if op in FP32_PIPE_OPS)
    conversion = sum(c for op, c in sass[kernel].items() if op in CONVERSION_OPS)
    steps = sum(sine_steps(a) for a in sin_inputs)
    return {"fp32": fp32 * n + 2 * steps, "conversion": conversion * n}


def launch_floor(dev):
    """A function (blocks, threads) -> None that launches LAUNCH_FLOOR_SOURCE's
    empty kernel on the current stream, built like the port's kernels into
    ``_build/probe/``."""
    d = _build.BUILD_DIR / "probe"
    d.mkdir(parents=True, exist_ok=True)
    (d / "launch_floor.cu").write_text(LAUNCH_FLOOR_SOURCE)
    _build._run_all([_build.compile_command(d / "launch_floor.cu", d / "launch_floor.o")])
    _build._run_all([_build.link_command([d / "launch_floor.o"], d / "liblaunch_floor.so")])
    lib = ctypes.CDLL(str(d / "liblaunch_floor.so"))
    lib.gs_launch_floor.argtypes = (ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p)
    lib.gs_launch_floor.restype = ctypes.c_int

    def launch(blocks, threads):
        code = lib.gs_launch_floor(blocks, threads, torch.cuda.current_stream(dev).cuda_stream)
        if code != 0:
            raise RuntimeError(f"the empty kernel did not launch: CUDA error {code}")
    return launch


def orb_call_moments(batch):
    """K7's int32 moments at ``orb_extract(batch, ORB_CAP, ORB_THR)``'s call: its
    keypoints clamped as it clamps them."""
    kps = gt.orb_extract(batch, ORB_CAP, ORB_THR)
    sx, sy = kps.x.clamp(15, ORB_W - 16), kps.y.clamp(15, ORB_H - 16)
    return K.orb_moments(batch, sx, sy)


def fs_composition(m01, m10):
    """The orientation's trig as three K21 launches after two casts, as
    ``orb_extract`` ran it before ``fs_orient``: the yardstick of the fused call."""
    F = K.freestanding
    angle = F.fs_atan2(m01.to(torch.float32), m10.to(torch.float32))
    return angle, F.fs_sin(angle), F.fs_sin(angle, FS_COS_OFFSET)


def orb_rates_in_turns(batch, rounds=3):
    """``orb_extract`` frames/s on ``batch`` in the fast mode, the freestanding
    mode and the freestanding mode with ``fs_composition`` in place of
    ``fs_orient`` (the casts and three launches it replaced; the K21 wrappers
    called directly, without ``libm32``'s dispatch around them), in turns (in
    order, then reversed, ``rounds`` times); the last two first checked equal,
    bit for bit."""
    fused = libm32.fs_orient
    modes = ("fast", "freestanding", "freestanding_three_launches")

    def run(mode, fn):
        libm32.use_freestanding(mode != "fast")
        libm32.fs_orient = fs_composition if mode.endswith("three_launches") else fused
        try:
            return fn()
        finally:
            libm32.use_freestanding(False)
            libm32.fs_orient = fused

    tables = [run(mode, lambda: gt.orb_extract(batch, ORB_CAP, ORB_THR)) for mode in modes[1:]]
    if not all(torch.equal(a, b) for a, b in zip(*map(_table_bits, tables))):
        raise AssertionError("orb_extract with three K21 launches differs from fs_orient's")
    rates = {mode: [] for mode in modes}
    for _ in range(rounds):
        for mode in (*modes, *reversed(modes)):
            rates[mode].append(ORB_N / run(mode, lambda: timeit(gt.orb_extract, batch, ORB_CAP,
                                                                 ORB_THR)))
    return rates


def in_turns(fns, measure, rounds=2):
    """{name: [measure(fn), ...]}: the functions ``fns`` in order, then in
    reverse, ``rounds`` times."""
    out = {name: [] for name in fns}
    for _ in range(rounds):
        for name in [*fns, *reversed(fns)]:
            out[name].append(measure(fns[name]))
    return out


def phase_freestanding_timing(card, orb_frames, stream_fps_line):
    """K21 at ``orb_extract``'s call (``fs_orient`` on the 16 x 500 keypoints'
    moments, in turns with the three-launch composition it replaced) and on
    1 M moment pairs L2-warm and cold, by CUDA events and by device time, beside
    its plain version, its bound, an empty kernel on the same grid (the launch
    floor) and ``torch.atan2`` (a yardstick: not the same function); the kept
    atan2 and sine entries on 1 M inputs; ``orb_extract`` frames/s in the fast
    mode, the freestanding mode and the freestanding mode with the three
    launches it replaced (``orb_rates_in_turns``); the stream demo's rate."""
    F = K.freestanding
    batch = orb_frames[0]
    dev = batch.device
    m01, m10 = orb_call_moments(batch)
    n = m01.numel()
    angle = F.fs_orient(m01, m10)[0]
    threads = orient_threads()
    sass = sass_instructions()
    orient_ops = lambda a, k: fs_ops(sass, "fs_orient_kernel", k,  # noqa: E731
                                     (a, a + float(np.float32(FS_COS_OFFSET))))
    calls = {"composition": lambda: fs_composition(m01, m10),
             "fs_orient": lambda: F.fs_orient(m01, m10)}
    events = in_turns(calls, lambda fn: timeit(fn) * 1e3)
    k21_device = in_turns(calls, lambda fn: device_ms(fn, kernel="fs_"))
    all_device = in_turns(calls, device_ms)
    floor_launch = launch_floor(dev)
    blocks = -(-n // threads)
    floor = device_ms(lambda: floor_launch(blocks, threads), kernel="launch_floor")
    med = statistics.median
    m01f, m10f = m01.to(torch.float32), m10.to(torch.float32)
    entry = kernel_entry(med(events["fs_orient"]),
                         timeit(F.fs_orient_plain, m01, m10, iters=3) * 1e3, 20 * n,
                         orient_ops(angle, n), timeit(torch.atan2, m01f, m10f) * 1e3,
                         "torch.atan2 float32 on the same moments cast to float32: a "
                         "yardstick, not the same function (no GS_NO_STDLIB polynomial, no "
                         "sine, no cast)")
    entry.update(device_ms=med(k21_device["fs_orient"]), launches_a_call=1, elements=n,
                 grid=[blocks, threads],
                 launch_floor_device_ms=floor,
                 composition_ms=med(events["composition"]),
                 composition_device_ms=med(k21_device["composition"]),
                 composition_device_ms_with_casts=med(all_device["composition"]),
                 turns={"events_ms": events, "k21_device_ms": k21_device,
                        "all_kernels_device_ms": all_device},
                 sass_instructions=sass,
                 bytes_counted="8 B read and 12 B written an element (int32 moments; angle, "
                               "sine, cosine)")
    emit("kernel_time", card=card, kernel="freestanding", call="orb_extract", shape=[ORB_N, ORB_CAP],
         **entry)
    rng = np.random.default_rng(9)
    y, x = (t.to(dev) for t in fs_moment_pairs(rng))
    big = F.fs_orient(y, x)[0]
    flush = torch.empty(FS_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    sweep_calls = {"composition": lambda: fs_composition(y, x),
                   "fs_orient": lambda: F.fs_orient(y, x)}
    cold_calls = {name: (lambda fn=fn: (flush.zero_(), fn())) for name, fn in sweep_calls.items()}
    orient = kernel_entry(timeit(sweep_calls["fs_orient"]) * 1e3,
                          timeit(F.fs_orient_plain, y, x, iters=3) * 1e3, 20 * y.numel(),
                          orient_ops(big, y.numel()), None)
    orient.update(warm_device_ms=in_turns(sweep_calls, lambda fn: device_ms(fn, kernel="fs_")),
                  cold_device_ms=in_turns(cold_calls, lambda fn: device_ms(fn, kernel="fs_")),
                  elements=y.numel(), cold=f"{FS_FLUSH_BYTES} bytes written before each call")
    for key in ("warm_device_ms", "cold_device_ms"):
        orient[f"{key}_median"] = {name: med(v) for name, v in orient[key].items()}
    orient["device_ms"] = orient["warm_device_ms_median"]["fs_orient"]
    emit("kernel_time", card=card, kernel="freestanding", call="orient sweep", shape=[y.numel()],
         **orient)
    y, x = (t.to(dev) for t in fs_atan2_inputs(rng))
    wide = fs_sin_inputs(rng)[0].to(dev)
    sweep = {"orient": orient}
    for name, fn, plain, lib, nbytes, ops in (
            ("atan2", lambda: F.fs_atan2(y, x), lambda: F.fs_atan2_plain(y, x),
             lambda: torch.atan2(y, x), 12 * y.numel(), fs_ops(sass, "fs_atan2_kernel", y.numel())),
            ("sin", lambda: F.fs_sin(wide), lambda: F.fs_sin_plain(wide),
             lambda: torch.sin(wide), 8 * wide.numel(),
             fs_ops(sass, "fs_sin_kernel", wide.numel(), (wide,)))):
        e = kernel_entry(timeit(fn) * 1e3, timeit(plain, iters=3) * 1e3, nbytes, ops,
                         timeit(lib) * 1e3, f"torch.{name} float32 (a yardstick)")
        e.update(device_ms=device_ms(fn, kernel="fs_"), elements=y.numel())
        sweep[name] = e
        emit("kernel_time", card=card, kernel="freestanding", call=f"{name} sweep",
             shape=[y.numel()], **e)
    rates = orb_rates_in_turns(batch)
    emit("freestanding_timing", card=card,
         orb_extract_frames_per_sec={mode: statistics.median(v) for mode, v in rates.items()},
         orb_extract_frames_per_sec_turns=rates,
         k21_at_orb_extract_events_ms=entry["ms"], k21_at_orb_extract_device_ms=entry["device_ms"],
         composition_at_orb_extract_events_ms=entry["composition_ms"],
         composition_at_orb_extract_device_ms=entry["composition_device_ms"],
         launch_floor_device_ms=floor, bound_ms=entry["bound_ms"],
         k21_sweep={k: {f: v.get(f) for f in ("ms", "device_ms", "plain_ms", "bound_ms",
                                              "library_ms", "cold_device_ms_median",
                                              "warm_device_ms_median")}
                    for k, v in sweep.items()},
         stream_demo=stream_fps_line,
         windows="events: median of 3 windows of 20 calls after 2 warm-up calls (plain: 3 "
                 "calls); device: torch.profiler over 20 calls; fused and composition in turns "
                 "(in order, then reversed, twice); orb_extract rates: the three modes in "
                 "turns (in order, then reversed, three times), medians")
    return {"freestanding": entry}



def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an earlier commit's tree: its K4, K8, K10, K19 and K20 "
                                     "are timed beside the committed ones by the profiler, in "
                                     "turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    op_rates = set_op_rates()
    t_start = t0 = time.perf_counter()
    _build.library()
    parent = parent_library(args.parent)
    emit("build", card=card, parent=args.parent, device=torch.cuda.get_device_name(0),
         torch=torch.__version__,
         cuda=torch.version.cuda, build_seconds=time.perf_counter() - t0,
         nvcc=" ".join(_build.NVCC_FLAGS), operation_rates=op_rates,
         native_pgm_loader=native.available(), native_library=native.library_path())

    chk = Checker()
    phase_kernels(chk, np.random.default_rng(0), dev)
    phase_faces_kernels(chk, np.random.default_rng(1), dev)
    phase_orb_kernels(chk, np.random.default_rng(2), dev)
    phase_scan_kernels(chk, np.random.default_rng(3), dev)
    phase_dense_kernels(chk, np.random.default_rng(4), dev)
    phase_sharded_kernels(chk, np.random.default_rng(5), dev)
    phase_contour_template_kernels(chk, np.random.default_rng(6), dev)
    phase_sparse_kernels(chk, np.random.default_rng(7), dev)
    t0 = time.perf_counter()
    phase_freestanding_kernels(chk, np.random.default_rng(8), dev)
    slice_seconds = {"k21_vs_plain": time.perf_counter() - t0}
    batch, pre_launches = phase_main_path(chk, dev)
    faces_batch, faces_launches = phase_faces_path(chk, dev)
    orb_frames, orb_launches = phase_orb_path(chk, dev)
    scan_batch, scan_corners, scan_launches = phase_scan_path(chk, dev)
    dense_batch, dense_binary, dense_launches = phase_dense_path(chk, dev)
    cli_launches = phase_cli(dev)
    sharded_launches = phase_sharded_path(chk, dev, batch)
    tc_launches = phase_contour_template_path(chk, dev)
    sparse_launches, sparse_calls = phase_sparse_path(chk, dev)
    t0 = time.perf_counter()
    fs_launches = phase_freestanding_path(chk, dev, orb_frames)
    debug_launches = phase_debug(dev)
    demo_launches, stream_fps_line = phase_demos(dev)
    slice_seconds["paths"] = time.perf_counter() - t0
    bw_launches, times, rates = phase_bandwidth(card, dev)
    times.update(phase_timing(batch, card))
    times.update(phase_sharded_timing(batch, card))
    del batch
    times.update(phase_faces_timing(faces_batch, card, phase_faces_work(faces_batch), parent))
    times.update(phase_orb_timing(orb_frames, card))
    phase_orb_device_time(orb_frames, times, card, parent)
    t0 = time.perf_counter()
    times.update(phase_freestanding_timing(card, orb_frames, stream_fps_line))
    slice_seconds["timing"] = time.perf_counter() - t0
    emit("freestanding_debug_demos_seconds", **slice_seconds)
    times.update(phase_scan_timing(scan_batch, scan_corners, card, parent))
    del scan_batch, faces_batch, orb_frames
    times.update(phase_dense_timing(dense_batch, dense_binary, card))
    del dense_batch, dense_binary
    times.update(phase_contour_template_timing(card, dev, parent))
    times.update(phase_sparse_timing(card, sparse_calls))

    # each path ran with the counts at 0 and launches only its own kernels
    launches = {name: pre_launches[name] + faces_launches[name] + orb_launches[name]
                + scan_launches[name] + dense_launches[name] + cli_launches[name]
                + sharded_launches[name] + tc_launches[name] + bw_launches[name]
                + sparse_launches[name] + fs_launches[name] + debug_launches[name]
                + demo_launches[name]
                for name in KERNELS}
    emit("elapsed", seconds=time.perf_counter() - t_start)
    copy_rate = rates["copy_gbps"] * 1e9
    summary = [{"name": name, **info, "launches": launches[name],
                "max_abs_err": chk.max_err[name], **times[name],
                "bound_ms_at_copy": bound_at(times[name], copy_rate),
                "copy_gbps": rates["copy_gbps"]}
               for name, info in KERNELS.items()]
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
