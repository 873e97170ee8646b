"""``device_idle_pct``: the share of a batch's wall time in which no device
event ran: 100 x (1 - busy time a batch / wall time a batch).  The busy time
is the union of the device's events over the traced batches; the wall time
is that of the same run's untraced batches (the profiler's end to the
window's end, over their count), since the profiler's host cost stretches
the traced batches' own wall time."""


def read(ctx):
    trace = ctx.trace
    if trace is None or not trace.batches or not ctx.batch_wall_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.batches / ctx.batch_wall_s)
