"""``host_call_ms``: mean host time from the call into the port's entry to its
return, over the window's batches outside the profiler (a span the loop
takes around each call).  With one batch in flight it adds to every
batch's time; with two it hides behind the device's work."""


def read(ctx):
    calls = ctx.call_s
    return 1e3 * sum(calls) / len(calls) if calls else None
