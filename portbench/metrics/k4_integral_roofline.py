"""``k4_integral_roofline``: K4 ``integral`` (``csrc/integral.cu``:
``band_totals_kernel``, ``carry_scan_kernel``, ``band_scan_kernel``; the first
two only where a frame spans several bands) against its least time, in %.

Per call on (N, H, W) frames its minimal traffic is the uint8 frames read
once and the uint32 integral written once: 5 N H W bytes.  At 32 frames of
480 x 640 that is 49,152,000 bytes, 0.014672 ms at 3.35 TB/s.  Its
operations are counted as none: two adds a pixel, far below the byte bound.
The measured time is the device time of the three kernels a call in the
traced batches; calls are counted by ``band_scan_kernel``, one a call.
"""

import re

from portbench import roofline

KERNELS = re.compile(r"\b(band_totals|carry_scan|band_scan)_kernel\b")
FIRST = re.compile(r"\bband_scan_kernel\b")  # templated: no "(" after it


def least_bytes(n, h, w):
    return 5 * n * h * w


def read(ctx):
    trace = ctx.trace
    if trace is None:
        return None
    times = [s for name, s in trace.device_events if KERNELS.search(name)]
    calls = sum(1 for name, _ in trace.device_events if FIRST.search(name))
    if not times or not calls:
        return None
    n, h, w = ctx.batch_shape
    return roofline.share_pct(least_bytes(n, h, w), 0, sum(times) / calls)
