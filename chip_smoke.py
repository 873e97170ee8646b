#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``grayskull_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``grayskull_tpu_torch/csrc`` with
``nvcc``, holds each kernel bit for bit to its plain PyTorch version on the
card, drives the main path (``grayskull_tpu_torch.preprocess``: blur(2) -> Otsu
-> threshold -> Sobel on 256 frames of 1024x1024) and checks that it ran
through every kernel and agrees with the plain path and the numpy goldens, then
times it with CUDA events.  Each phase prints one JSON line; then come the
per-kernel summary line and the card's ``nvidia-smi`` name and power limit, and
the last line is ``{"ok": true, "device": {...}}``.  Any failure raises and the
exit code is non-zero; without a CUDA device it exits 1 and prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import grayskull_tpu_torch as gt
from grayskull_tpu_torch import kernels as K
from grayskull_tpu_torch.io import read_pgm
from grayskull_tpu_torch.kernels import _build
from grayskull_tpu_torch.profiling import timeit

HERE = os.path.dirname(os.path.abspath(__file__))
METRIC = "fused_blur_otsu_threshold_sobel_1MP_frames_per_sec"
SHAPES = [(2, 24, 128), (1, 97, 200), (1, 7, 8), (1, 17, 129), (2, 816, 612), (4, 1024, 1024)]
RADII = (1, 2, 6, 7, 16)
MAIN_N, MAIN_H, MAIN_W, MAIN_R = 256, 1024, 1024, 2
KERNELS = {
    "blur_hist": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/preproc.cu",
                  "replaces": "grayskull_tpu/kernels/preproc.py:273",
                  "also_replaces": "grayskull_tpu/kernels/preproc.py:485"},
    "otsu": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/otsu.cu",
             "replaces": "grayskull_tpu/ops/histogram.py:55"},
    "threshold_sobel": {"route": "cuda", "source": "grayskull_tpu_torch/csrc/preproc.cu",
                        "replaces": "grayskull_tpu/kernels/preproc.py:794",
                        "also_replaces": "grayskull_tpu/kernels/preproc.py:569"},
}


def emit(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


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
        err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max()) if got.numel() else 0
        self.max_err[name] = max(self.max_err[name], err)
        self.checks[name] += 1
        if err != 0:
            raise AssertionError(f"{name} {what}: max |kernel - plain| = {err}")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
                         check=True).stdout
    return out.strip().splitlines()[0].strip()


def lena_batch(n, h, w):
    """``bench.py``'s frames: lena tiled to h x w, rolled 13*i columns per frame."""
    tile = read_pgm(os.path.join(HERE, "tests", "golden", "testdata", "lena.pgm"))
    if tile is None:
        raise FileNotFoundError("tests/golden/testdata/lena.pgm")
    reps = (-(-h // tile.shape[0]), -(-w // tile.shape[1]))
    frame = np.tile(tile, reps)[:h, :w]
    return np.stack([np.roll(frame, 13 * i, axis=1) for i in range(n)])


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
    return cases


def phase_kernels(chk, rng, dev):
    for shape in SHAPES:
        imgs = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        n, h, w = shape
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
    torch.cuda.synchronize()
    emit("kernels_vs_plain", ok=True, shapes=[list(s) for s in SHAPES], radii=list(RADII),
         checks=chk.checks, max_abs_err=chk.max_err)


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
    missing = [name for name in KERNELS if launches.get(name, 0) < 1]
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
        on_card = gt.preprocess(gt.as_image(frame).to(dev))
        on_cpu = gt.preprocess_reference(frame)
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
    times = {}
    for name, (kernel, plain) in pairs.items():
        times[name] = (timeit(kernel) * 1e3, timeit(plain, iters=3) * 1e3)
        emit("kernel_time", card=card, kernel=name, shape=list(batch.shape),
             ms=times[name][0], plain_ms=times[name][1])
    # the standalone ops (blur, sobel) take the same kernels without the histogram or thresholds
    for name, kernel, plain in (
            ("blur_hist without histogram", lambda: K.blur_hist(batch, MAIN_R, False),
             lambda: K.blur_hist_plain(batch, MAIN_R, False)),
            ("threshold_sobel without thresholds", lambda: K.threshold_sobel(batch),
             lambda: K.threshold_sobel_plain(batch))):
        emit("kernel_time", card=card, kernel=name, shape=list(batch.shape),
             ms=timeit(kernel) * 1e3, plain_ms=timeit(plain, iters=3) * 1e3)
    emit("memory", card=card, peak_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    return times


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    t0 = time.perf_counter()
    _build.library()
    emit("build", card=card, device=torch.cuda.get_device_name(0), torch=torch.__version__,
         cuda=torch.version.cuda, build_seconds=time.perf_counter() - t0,
         nvcc=" ".join(_build.NVCC_FLAGS))

    chk = Checker()
    phase_kernels(chk, np.random.default_rng(0), dev)
    batch, launches = phase_main_path(chk, dev)
    times = phase_timing(batch, card)

    summary = [{"name": name, **info, "launches": launches[name],
                "max_abs_err": chk.max_err[name], "ms": times[name][0],
                "plain_ms": times[name][1]} for name, info in KERNELS.items()]
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
