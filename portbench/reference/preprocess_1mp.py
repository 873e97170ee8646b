"""Plain reference of ``preprocess_1mp``: blur(r) -> Otsu -> threshold -> Sobel,
as ``grayskull.h`` computes them, in plain PyTorch on the frames' device
(``portbench/plain.py``; nothing of the port).

``control=True`` is the control that has to fail: the Otsu sweep in
bfloat16, the next precision below the float32 that the reference states,
and the blur's integer mean as a bfloat16 product with the count's
reciprocal (a float mean, as ``avg_pool2d`` takes it, one precision down).
"""

from __future__ import annotations

import torch

from portbench import plain

_BLOCK = 32  # frames a step: bounds the int32 prefix sums


def reference(frames, params, control=False):
    """The outputs of ``preprocess`` for (N, H, W) uint8 frames: the stencils by
    blocks of frames, the Otsu sweep over the whole batch at once."""
    r = int(params["radius"])
    dtype = torch.bfloat16 if control else torch.float32
    divide = dtype if control else None
    n, h, w = frames.shape
    blurred = torch.cat([plain.blur(frames[s:s + _BLOCK], r, divide)
                         for s in range(0, n, _BLOCK)])
    t = plain.otsu(plain.histograms(blurred), h * w, dtype)
    binary = (blurred > t.view(-1, 1, 1)).to(torch.uint8) * 255
    edges = torch.cat([plain.sobel(binary[s:s + _BLOCK]) for s in range(0, n, _BLOCK)])
    return {"blurred": blurred, "binary": binary, "edges": edges, "thresholds": t}
