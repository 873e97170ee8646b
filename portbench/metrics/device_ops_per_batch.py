"""``device_ops_per_batch``: device events (kernels, copies, fills) a batch in
the traced batches: each is a launch the host pays for."""


def read(ctx):
    trace = ctx.trace
    if trace is None or not trace.device_events:
        return None
    return len(trace.device_events) / trace.batches
