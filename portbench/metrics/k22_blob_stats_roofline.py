"""``k22_blob_stats_roofline``: K22 ``blob_stats`` (``csrc/blobs.cu``:
``blob_stats_init_kernel``, ``blob_stats_kernel``, one launch each a call)
against its least time, in %.

Per call on (N, H, W) pages with ``max_blobs`` labels its minimal traffic is
the int32 label map read once and seven int64 statistics of each of the
``max_blobs + 1`` labels written once: 4 N H W + 56 N (max_blobs + 1) bytes.
At 32 pages of 1024 x 768 and 1000 labels that is 102,457,088 bytes, 0.030584
ms at 3.35 TB/s.  Its operations are counted as none: a few a pixel, far
below the byte bound.  The measured time is the device time of the two
kernels a call in the traced batches; calls are counted by the stats kernel.
"""

import re

from portbench import roofline

KERNELS = re.compile(r"\bblob_stats_(init_)?kernel\b")
FIRST = re.compile(r"\bblob_stats_kernel\b")  # one a call; templated, so no "(" after it


def least_bytes(n, h, w, max_blobs):
    return 4 * n * h * w + 56 * n * (max_blobs + 1)


def read(ctx):
    trace = ctx.trace
    max_blobs = ctx.params.get("max_blobs")
    if trace is None or max_blobs is None:
        return None
    times = [s for name, s in trace.device_events if KERNELS.search(name)]
    calls = sum(1 for name, _ in trace.device_events if FIRST.search(name))
    if not times or not calls:
        return None
    n, h, w = ctx.batch_shape
    return roofline.share_pct(least_bytes(n, h, w, max_blobs), 0, sum(times) / calls)
