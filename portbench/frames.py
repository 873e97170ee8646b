"""The frame pool of a cell, made on the device from the seed.

A configuration's ``content`` names a PGM under ``portbench/`` and how each
frame departs from it: the image repeated to cover the frame and cut to its
size (taken as it is where the sizes agree), rolled along its columns by a
step in ``0 .. roll_max``, scaled by a gain in ``[gain[0], gain[1]]`` and
shifted by a whole offset in ``offset[0] .. offset[1]``, rounded and clipped
to uint8.  So the frames differ in content and in their histograms.

The rolls, the gains and the offsets are each one fixed set for every seed
(the rolls and gains evenly spaced, the offsets cycling through their
range), each dealt to the frames in its own order drawn from the seed.  A
frame's gain and offset set its threshold, and with its roll the blobs that
follow: every seed gives the pool other frames but the same spread of work.
The same seed gives the same pool.
"""

from __future__ import annotations

import numpy as np
import torch

from .spec import ROOT

_BLOCK = 256  # frames made at once: bounds the float32 temporaries


def read_pgm(path) -> np.ndarray:
    """A binary (P5) 8-bit PGM as an (H, W) uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    if magic != b"P5" or maxval != 255:
        raise ValueError(f"{path}: not an 8-bit binary PGM")
    pixels = np.frombuffer(data, np.uint8, h * w, pos + 1)
    return pixels.reshape(h, w)


def base_image(content: dict, height: int, width: int) -> np.ndarray:
    """The configuration's image repeated to cover (height, width) and cut to it."""
    img = read_pgm(ROOT / content["image"])
    reps = (-(-height // img.shape[0]), -(-width // img.shape[1]))
    return np.ascontiguousarray(np.tile(img, reps)[:height, :width])


def make_pool(content: dict, count: int, height: int, width: int, seed: int,
              device) -> torch.Tensor:
    """(count, height, width) uint8 frames on ``device``, drawn from ``seed``."""
    device = torch.device(device)
    base = torch.from_numpy(base_image(content, height, width)).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    step = torch.arange(count, device=device)

    def dealt(values):
        return values[torch.randperm(count, generator=gen, device=device)]

    rolls = dealt(step * (int(content["roll_max"]) + 1) // count)
    lo, hi = (float(v) for v in content["gain"])
    gains = dealt(lo + (hi - lo) * (step.to(torch.float32) + 0.5) / count)
    o_lo, o_hi = (int(v) for v in content["offset"])
    offsets = dealt((o_lo + step % (o_hi - o_lo + 1)).to(torch.float32))
    pool = torch.empty((count, height, width), dtype=torch.uint8, device=device)
    cols = torch.arange(width, device=device)
    for s in range(0, count, _BLOCK):
        e = min(s + _BLOCK, count)
        idx = (cols[None, :] - rolls[s:e, None]) % width  # np.roll by rolls[i] columns
        rolled = base[:, idx].permute(1, 0, 2).to(torch.float32)
        px = rolled * gains[s:e, None, None] + offsets[s:e, None, None]
        pool[s:e] = px.round_().clamp_(0, 255).to(torch.uint8)
    return pool
