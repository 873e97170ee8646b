"""``invert``: each pixel ``p`` of a batch becomes ``255 - p``; each frame's sum
of the inverted pixels is read back for every batch."""

import torch

RESULT = "sums"  # the small output a batch is done with, once on the host


def call(frames, params):
    inverted = 255 - frames
    return {"inverted": inverted, "sums": inverted.sum((1, 2), dtype=torch.int64)}
