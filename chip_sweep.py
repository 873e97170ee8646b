#!/usr/bin/env python3
"""Time variants of ``csrc/preproc.cu``'s kernels against each other on one card.

Run from the repository root on a machine with an NVIDIA Hopper card::

    python3 chip_sweep.py [--parent DIR ...]

It builds ``grayskull_tpu_torch/csrc/preproc.cu`` as it is and in variants
that change one tile constant -- K2/K16's strip of rows a warp sweeps
(``kSobelStrip``: 32, 64, 128) and the outputs a K11 thread makes in its
row pass (``kAdaptiveItem``: 16, 32, 64) -- two ablations of
``blur_hist_kernel`` that skip its vertical pass or its row pass (their
outputs are wrong and not checked: they split K1's and K11's time between
the stages) -- and, with ``--parent``, the
``grayskull_tpu_torch/csrc/preproc.cu`` under each DIR (for example the
parent commit unpacked with ``git archive``; the variant is named after the
directory), each into a library of its own under
``grayskull_tpu_torch/_build/sweep/`` (``nvcc -Xptxas -v`` prints each
kernel's registers).  Each library's K1, K2, K11 and K16 are held bit for bit
to their plain versions at the shapes of PERF.md's kernel table, then every
variant is timed in turns, first in order and then in reverse, with
``profiling.timeit`` (median of 3 windows of 20 calls), on the same inputs:

* K1 ``blur_hist``: 256 frames of lena tiled to 1024x1024, r = 2;
* K2 ``threshold_sobel``: the blurred frames with their Otsu thresholds and
  the binary map, and ``sobel`` (no thresholds) of the frames;
* K16 ``threshold_sobel_window``: the middle shard of a (1, 4) split,
  256 x 258 x 1024;
* K11 ``adaptive``: 256 frames of receipt.pgm (816x612), r = 15, c = 5.

Each phase prints one JSON line; the last line is ``{"ok": true, ...}``.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import torch

from chip_smoke import MAIN_H, MAIN_N, MAIN_R, MAIN_W, card_line, lena_batch, receipt_batch
from grayskull_tpu_torch import kernels as K
from grayskull_tpu_torch.kernels import _build
from grayskull_tpu_torch.profiling import timeit

HERE = os.path.dirname(os.path.abspath(__file__))
ENTRIES = ("gs_blur_hist", "gs_blur_hist_window", "gs_threshold_sobel",
           "gs_threshold_sobel_window", "gs_adaptive")
# name: {constant definition in preproc.cu: its replacement}
VARIANTS = {
    "committed": {},
    "strip32": {"constexpr int kSobelStrip = 64;": "constexpr int kSobelStrip = 32;"},
    "strip128": {"constexpr int kSobelStrip = 64;": "constexpr int kSobelStrip = 128;"},
    "item16": {"constexpr int kAdaptiveItem = 32;": "constexpr int kAdaptiveItem = 16;"},
    "item64": {"constexpr int kAdaptiveItem = 32;": "constexpr int kAdaptiveItem = 64;"},
}
# ablations: timed, never checked
ABLATIONS = {
    "no_vertical_pass": {
        "    box_columns(StagedBytes{band, pitch, ry0, a0}, colsum, swp, sw, cx0, y0, rows, h, r, ry0,\n"
        "                ry1 - 1);\n": ""},
    "no_row_pass": {
        "for (int item = threadIdx.x; item < total; item += blockDim.x) {":
            "for (int item = threadIdx.x + total; item < total; item += blockDim.x) {"},
}


def emit(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def build_variants(text, parent):
    """Compile every variant's preproc.cu at once; return {name: loaded library}."""
    sources = {}
    for name, edits in {**VARIANTS, **ABLATIONS}.items():
        body = text
        for old, new in edits.items():
            if body.count(old) != 1:
                raise AssertionError(f"{name}: {old!r} is not in preproc.cu once")
            body = body.replace(old, new)
        sources[name] = body
    for path in parent:
        with open(os.path.join(path, "grayskull_tpu_torch", "csrc", "preproc.cu")) as f:
            sources[os.path.basename(os.path.normpath(path))] = f.read()
    jobs = {}
    for name, body in sources.items():
        d = _build.BUILD_DIR / "sweep" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "preproc.cu").write_text(body)
        cmd = _build.compile_command(d / "preproc.cu", d / "preproc.o") + ["-Xptxas", "-v"]
        jobs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
    libs, regs = {}, {}
    for name, (d, proc) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        regs[name] = [line.split("ptxas info    : ")[-1] for line in out.splitlines()
                      if "registers" in line or "spill" in line]
        subprocess.run(_build.link_command([d / "preproc.o"], d / "libpreproc.so"), check=True)
        lib = ctypes.CDLL(str(d / "libpreproc.so"))
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        lib.gs_error_string.argtypes = (ctypes.c_int,)
        lib.gs_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs, regs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="a checkout whose preproc.cu is timed too (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    t0 = time.perf_counter()
    committed = _build.library()  # K3 and the inputs come from the committed build
    text = (_build.CSRC_DIR / "preproc.cu").read_text()
    libs, regs = build_variants(text, args.parent)
    emit("sweep_build", card=card, seconds=time.perf_counter() - t0, variants=list(libs),
         ptxas={name: [r for r in lines if re.search(r"threshold_sobel|blur_hist|Used", r)]
                for name, lines in regs.items()})

    lena = torch.from_numpy(lena_batch(MAIN_N, MAIN_H, MAIN_W)).to(dev)
    blurred, hist = K.blur_hist(lena, MAIN_R)
    t = K.otsu(hist, MAIN_H * MAIN_W)
    h_loc = MAIN_H // 4
    shard = blurred[:, h_loc - 1:2 * h_loc + 1].contiguous()  # (256, 258, 1024), row0 = h_loc - 1
    receipt = torch.from_numpy(receipt_batch(MAIN_N)).to(dev)
    cases = {
        "blur_hist": (lambda: K.blur_hist(lena, MAIN_R),
                      lambda: K.blur_hist_plain(lena, MAIN_R)),
        "threshold_sobel": (lambda: K.threshold_sobel(blurred, t, True),
                            lambda: K.threshold_sobel_plain(blurred, t, True)),
        "sobel": (lambda: K.threshold_sobel(lena), lambda: K.threshold_sobel_plain(lena)),
        "threshold_sobel_window": (
            lambda: K.threshold_sobel_window(shard, t, h_loc - 1, h_total=MAIN_H),
            lambda: K.threshold_sobel_window_plain(shard, t, h_loc - 1, h_total=MAIN_H)),
        "adaptive": (lambda: K.adaptive(receipt, 15, 5),
                     lambda: K.adaptive_plain(receipt, 15, 5)),
    }
    shapes = {"blur_hist": lena.shape, "threshold_sobel": blurred.shape, "sobel": lena.shape,
              "threshold_sobel_window": shard.shape, "adaptive": receipt.shape}
    refs = {name: plain() for name, (_, plain) in cases.items()}
    for name, lib in libs.items():
        if name in ABLATIONS:
            continue
        _build._lib = lib
        for kernel, (fn, _) in cases.items():
            got, ref = fn(), refs[kernel]
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            for a, b in zip(got, ref):
                if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
                    raise AssertionError(f"{name} {kernel} differs from the plain version")
        torch.cuda.synchronize()
    emit("sweep_checks", ok=True, variants=[v for v in libs if v not in ABLATIONS],
         unchecked_ablations=list(ABLATIONS), kernels=list(cases), max_abs_err=0)

    order = list(libs)
    times = {name: {kernel: [] for kernel in cases} for name in order}
    for turn in (order, order[::-1]):
        for name in turn:
            _build._lib = libs[name]
            for kernel, (fn, _) in cases.items():
                times[name][kernel].append(timeit(fn) * 1e3)
    _build._lib = committed
    for kernel in cases:
        emit("sweep", card=card, kernel=kernel, shape=list(shapes[kernel]),
             ms={name: times[name][kernel] for name in order},
             mean_ms={name: sum(times[name][kernel]) / 2 for name in order},
             windows="profiling.timeit (median of 3 windows of 20 calls), variants in order "
                     "then in reverse")
    emit("elapsed", seconds=time.perf_counter() - t0)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
