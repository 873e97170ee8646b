"""Plain reference of ``invert``.  ``control=True`` sums the frames in
bfloat16, which holds whole numbers exactly only up to 256."""

from __future__ import annotations

import torch


def reference(frames, params, control=False):
    inverted = 255 - frames
    if control:
        sums = inverted.to(torch.bfloat16).sum((1, 2), dtype=torch.bfloat16).to(torch.int64)
    else:
        sums = inverted.to(torch.int64).sum((1, 2))
    return {"inverted": inverted, "sums": sums}
