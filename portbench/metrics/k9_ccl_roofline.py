"""``k9_ccl_roofline``: K9 ``ccl`` (``csrc/ccl.cu``: ``tile_kernel``,
``border_kernel``, ``flatten_kernel``, one launch each a call) against its
least time, in %.

Per call on (N, H, W) binary frames its minimal traffic is the frames read
once and the int32 labels written once: 5 N H W bytes; its operations
about 10 a pixel (a find a neighbour and the flatten).  At 8 pages of
1024 x 768 that is 31,457,280 bytes.  The measured time is the device time
of the three kernels a call in the traced batches.
"""

import re

from portbench import roofline

KERNELS = re.compile(r"\b(tile|border|flatten)_kernel\(")
FIRST = "tile_kernel("  # one a call


def least_bytes(n, h, w):
    return 5 * n * h * w


def operations(n, h, w):
    return 10 * n * h * w


def read(ctx):
    trace = ctx.trace
    if trace is None:
        return None
    times = [s for name, s in trace.device_events if KERNELS.search(name)]
    calls = sum(1 for name, _ in trace.device_events if FIRST in name)
    if not times or not calls:
        return None
    n, h, w = ctx.batch_shape
    return roofline.share_pct(least_bytes(n, h, w), operations(n, h, w), sum(times) / calls)
