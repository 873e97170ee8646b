"""``k5_lbp_roofline``: K5 ``lbp_eval_scale`` (``csrc/lbp.cu``,
``lbp_scale_kernel``, one launch a ladder scale) against its least time over
the ladder, in %.

The work a window does depends on the frame: it leaves the cascade at its
first failed stage.  What every window pays whatever its content is stage 0
in full (``grayskull.h:794-812``): its 3 weak classifiers at 40 operations
each (16 corner addresses, 9 block sums, 8 compares, the subset test, the
leaf's add, the stage's test), 120 a window.  That floor is the count here,
so no implementation can change it.  A launch's minimal traffic is the uint32
integral read once, 4 N H W bytes, and a byte a window for its hit written.
Each launch's least time is the larger of its bytes at 3.35 TB/s and its
operations at 67 T/s; the ladder's least time is their sum.

The ladder is computed here from ``params`` and the batch's shape, in numpy
float32 as ``grayskull.h:819-821`` does: ``scale`` from ``min_scale``, times
``scale_factor`` while ``scale <= max_scale`` and the frontal-face cascade's
24 x 24 window, ``(int)(24 * scale)``, fits; ``(H - win) // step + 1`` rows and
columns of windows.  At 32 frames of 480 x 640, step 1, scales 1.0-4.0 x 1.2:
8 scales, 65,606,752 windows, 380,179,552 bytes and 7,872,810,240 operations
a call, 0.11931 ms.  The measured time is the kernel's device time in
the traced batches over its launches, times the ladder's scales.
"""

import re

import numpy as np

from portbench import roofline

KERNEL = re.compile(r"\blbp_scale_kernel\b")
WINDOW = 24  # the frontal-face cascade's window, in pixels
OPS_A_WINDOW = 3 * 40  # stage 0's three weak classifiers


def ladder(params, h, w):
    """``[(ny, nx)]``: the window grid of each ladder scale of an (h, w) frame."""
    if not {"scale_factor", "min_scale", "max_scale", "step"} <= set(params):
        return []
    f = np.float32
    scale, factor, top = f(params["min_scale"]), f(params["scale_factor"]), f(params["max_scale"])
    step = int(params["step"])
    out = []
    while scale <= top:
        win = int(f(WINDOW) * scale)
        if win > w or win > h:
            break
        out.append(((h - win) // step + 1, (w - win) // step + 1))
        scale = f(scale * factor)
    return out


def counts(params, n, h, w):
    """``[(bytes, operations)]`` of each launch of a call on (n, h, w) frames."""
    return [(4 * n * h * w + n * ny * nx, OPS_A_WINDOW * n * ny * nx)
            for ny, nx in ladder(params, h, w)]


def least_seconds(params, n, h, w):
    return sum(roofline.least_seconds(b, ops) for b, ops in counts(params, n, h, w))


def read(ctx):
    trace = ctx.trace
    if trace is None:
        return None
    times = [s for name, s in trace.device_events if KERNEL.search(name)]
    n, h, w = ctx.batch_shape
    scales = len(ladder(ctx.params, h, w))
    if not times or not scales:
        return None
    measured = sum(times) / len(times) * scales  # a call's device time
    return 100.0 * least_seconds(ctx.params, n, h, w) / measured if measured > 0 else None
