"""``scatter_device_ms``: device ms a batch of PyTorch's scatter ops
(``scatter_add_``, ``scatter_reduce_``, ``scatter_``), the blob statistics
of ``ops/blobs.py``, by the profiler's self device time of each op."""


def read(ctx):
    trace = ctx.trace
    if trace is None:
        return None
    seconds = sum(s for op, s in trace.op_device_s.items() if op.startswith("aten::scatter"))
    return 1e3 * seconds / trace.batches if seconds > 0 else None
