"""``k1_blur_hist_roofline``: K1 ``blur_hist`` (``csrc/preproc.cu``,
``blur_hist_kernel``) against its least time, in %.

Per call on (N, H, W) frames its minimal traffic is the frames read once,
the blurred frames written once and N 256-bin int32 histograms written:
2 N H W + 1024 N bytes; its operations about 10 a pixel (the window sums'
adds and subtractions, the division, the histogram's add).  At 256 x 1 MP
that is 537,133,056 bytes, 0.16034 ms at 3.35 TB/s: bound by bytes.  The
measured time is the kernel's device time a launch in the traced batches.
"""

from portbench import roofline

KERNEL = "blur_hist_kernel"


def least_bytes(n, h, w):
    return 2 * n * h * w + 1024 * n


def operations(n, h, w):
    return 10 * n * h * w


def read(ctx):
    trace = ctx.trace
    if trace is None:
        return None
    times = [s for name, s in trace.device_events if KERNEL in name]
    if not times:
        return None
    n, h, w = ctx.batch_shape
    return roofline.share_pct(least_bytes(n, h, w), operations(n, h, w), sum(times) / len(times))
