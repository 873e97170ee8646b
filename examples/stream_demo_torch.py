#!/usr/bin/env python3
"""Streaming pipeline demo on the PyTorch + CUDA port — ``examples/stream_demo.py``
on ``grayskull_tpu_torch``, with the same flags, pipeline specs and outputs.

A configurable per-frame pipeline (the reference's WASM/webcam demo,
``examples/wasm/`` of the C library) runs on a batch of frames on the card; its
overlay renderers (blob boxes, keypoint crosses, face rects, contour boxes)
draw on the last processed frame on the host.  Frames come from a directory
of PGMs (through the native threaded loader) or are synthesized.

Usage::

    python examples/stream_demo_torch.py --pipeline blur:2,threshold:otsu,blobs \\
        --frames 64 --size 480x640 [--src dir_of_pgms] [--view] [--out dir]

It runs on the CUDA device and fails without one.  :func:`process_stream`
is everything but the timing, on a tensor's own device (the tests call it
on the CPU).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import grayskull_tpu_torch as gs  # noqa: E402
from grayskull_tpu_torch import debug, profiling  # noqa: E402


def synth_frames(n, h, w, seed=0):
    """Webcam-ish synthetic frames: moving bright quad + noise + a few dots."""
    rng = np.random.default_rng(seed)
    base = (rng.random((h, w)) * 40).astype(np.uint8)
    frames = []
    for i in range(n):
        f = base.copy()
        cx, cy = int(w * (0.3 + 0.4 * np.sin(i / 7))), int(h * (0.4 + 0.2 * np.cos(i / 5)))
        s = min(h, w) // 4
        f[max(0, cy - s) : cy + s, max(0, cx - s) : cx + s] = 210
        for _ in range(6):
            y, x = rng.integers(0, h), rng.integers(0, w)
            f[max(0, y - 2) : y + 2, max(0, x - 2) : x + 2] = 255
        frames.append(f)
    return np.stack(frames)


def build_pipeline(spec: str):
    """Parse ``blur:2,threshold:otsu,sobel,...`` into (dense_fn, analyzers)."""
    steps = []
    analyzers = []
    for item in spec.split(","):
        parts = item.strip().split(":")
        name, args = parts[0], parts[1:]
        if name == "blur":
            r = int(args[0]) if args else 1
            steps.append(lambda x, r=r: gs.blur(x, r))
        elif name == "threshold":
            if args and args[0] == "otsu":
                steps.append(lambda x: gs.threshold(x, gs.otsu_threshold(x)[..., None, None]))
            else:
                t = int(args[0])
                steps.append(lambda x, t=t: gs.threshold(x, t))
        elif name == "adaptive":
            r, c = int(args[0]), int(args[1]) if len(args) > 1 else 0
            steps.append(lambda x, r=r, c=c: gs.adaptive_threshold(x, r, c))
        elif name == "erode":
            steps.append(gs.erode)
        elif name == "dilate":
            steps.append(gs.dilate)
        elif name == "sobel":
            steps.append(gs.sobel)
        elif name == "sharpen":
            steps.append(gs.sharpen)
        elif name == "emboss":
            steps.append(gs.emboss)
        elif name in ("blobs", "keypoints", "faces", "contours"):
            analyzers.append((name, args))
        else:
            raise SystemExit(f"unknown pipeline op: {name}")

    def dense(x):
        for s in steps:
            x = s(x)
        return x
    return dense, analyzers


def _boxes(box, n):
    """The first ``n`` (x, y, w, h) rows of a Rects-like box table, on the host."""
    return zip(*(v[:n].cpu().numpy() for v in (box.x, box.y, box.w, box.h)))


def process_stream(frames, spec: str, out: str | None = None, view: bool = False):
    """Run the pipeline ``spec`` on the (N, H, W) uint8 tensor ``frames`` on its
    own device: the dense steps on the batch, the analyzers on the last frame,
    their overlay on the last processed frame.  Prints what the analyzers
    found; writes the processed frames and ``overlay.pgm`` to ``out``; renders
    the overlay on the terminal with ``view``.  Returns (processed, overlaid)
    as numpy."""
    dense, analyzers = build_pipeline(spec)
    on_device = dense(frames)
    processed = on_device.cpu().numpy()
    overlaid = processed[-1]
    for name, aargs in analyzers:
        if name == "blobs":
            table, _, _ = gs.ops.blobs(on_device[-1], int(aargs[0]) if aargs else 100)
            n = int(table.n)
            print(f"  blobs: {n} components")
            overlaid = debug.draw_rects(overlaid, _boxes(table.box, n), color=200)
        elif name == "keypoints":
            thr = int(aargs[0]) if aargs else 20
            kps, _ = gs.ops.fast(frames[-1], 500, thr)
            print(f"  keypoints: {int(kps.n)} corners")
            overlaid = debug.draw_crosses(overlaid, kps)
        elif name == "faces":
            rects = gs.pipelines.detect_faces(frames[-1], step=int(aargs[0]) if aargs else 2)
            print(f"  faces: {int(rects.n)} detections")
            overlaid = debug.draw_rects(overlaid, rects)
        elif name == "contours":
            # multi-contour extraction (WASM demo's contour stage, generalized)
            cap = int(aargs[0]) if aargs else 16
            cs = gs.ops.find_contours(frames[-1], max_contours=cap)
            n = int(cs.n)
            print(f"  contours: {n} traced, "
                  f"lengths {[int(v) for v in cs.length[:n].cpu().numpy()]}")
            overlaid = debug.draw_rects(overlaid, _boxes(cs.box, n), color=255)

    if out:
        os.makedirs(out, exist_ok=True)
        for i, f in enumerate(processed):
            gs.io.write_pgm(f, os.path.join(out, f"frame_{i:04d}.pgm"))
        gs.io.write_pgm(overlaid, os.path.join(out, "overlay.pgm"))
        print(f"  wrote {len(processed)} frames to {out}")
    if view:
        from grayskull_tpu_torch.cli import cmd_view

        cmd_view(overlaid, [])
    return processed, overlaid


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pipeline", default="blur:1,threshold:otsu,blobs")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--size", default="480x640")
    ap.add_argument("--src", help="directory of PGM frames (else synthetic)")
    ap.add_argument("--out", help="write overlaid frames to this directory")
    ap.add_argument("--view", action="store_true", help="render last frame to terminal")
    args = ap.parse_args(argv)

    h, w = (int(v) for v in args.size.split("x"))
    if args.src:
        paths = sorted(
            os.path.join(args.src, f) for f in os.listdir(args.src) if f.endswith(".pgm")
        )[: args.frames]
        frames = gs.io.read_pgm_batch(paths, pad_to=(h, w))
    else:
        frames = synth_frames(args.frames, h, w)

    batch = gs.as_image(frames)  # to the CUDA device; raises without one
    dense, _ = build_pipeline(args.pipeline)
    stats = profiling.throughput(dense, batch, iters=5)
    print(
        f"pipeline [{args.pipeline}] over {frames.shape}: "
        f"{stats['frames_per_sec']:.0f} fps, {stats['gpix_per_sec']:.2f} Gpix/s"
    )
    process_stream(batch, args.pipeline, args.out, args.view)


if __name__ == "__main__":
    main()
