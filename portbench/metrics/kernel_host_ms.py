"""``kernel_host_ms``: host ms a batch inside the port's kernel wrappers (the
``gs.kernels.*`` spans of ``grayskull_tpu_torch.profiling``: each wrapper's
checks, allocations, the library's load and the launch; they do not nest),
over the traced batches.

The spans are recorded only while the profiler records, so the store holds
the traced batches' entry calls and nothing of the warm-up or the untraced
rest; the traced batches are its last ``ctx.trace.batches`` calls (the spans
under one outermost span).  The profiler's cost a host op is inside these
times.  Without the program's spans, or with fewer calls than batches,
nothing is read.
"""

PREFIX = "gs.kernels."


def traced_calls(ctx):
    """The spans of the last ``ctx.trace.batches`` calls in the program's store,
    a list a call, oldest first; None if there are fewer."""
    trace = ctx.trace
    if trace is None or not trace.batches:
        return None
    from grayskull_tpu_torch import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:  # a program without spans
        return None
    by_call = {}
    for s in spans():
        by_call.setdefault(s.call, []).append(s)
    if len(by_call) < trace.batches:
        return None
    return [by_call[c] for c in sorted(by_call)[-trace.batches:]]


def host_ms(calls, keep):
    """Host ms a call inside the spans whose name ``keep`` accepts."""
    ns = sum(s.end_ns - s.start_ns for call in calls for s in call if keep(s.name))
    return ns / 1e6 / len(calls)


def read(ctx):
    calls = traced_calls(ctx)
    if calls is None:
        return None
    return host_ms(calls, lambda name: name.startswith(PREFIX))
