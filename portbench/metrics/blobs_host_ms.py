"""``blobs_host_ms``: host ms a batch inside the port's blob layer (the
``gs.ops.blobs`` span: seed ranks, K9, the label gather, the statistics'
scatters and the compaction, its child spans included), over the traced
batches, as ``kernel_host_ms`` takes them."""

from portbench import spec

_calls = spec.metric_reader("kernel_host_ms")

NAME = "gs.ops.blobs"


def read(ctx):
    calls = _calls.traced_calls(ctx)
    if calls is None or not any(s.name == NAME for call in calls for s in call):
        return None
    return _calls.host_ms(calls, lambda name: name == NAME)
