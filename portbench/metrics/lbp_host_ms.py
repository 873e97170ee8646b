"""``lbp_host_ms``: host ms a batch inside the port's LBP layer (the
``gs.ops.lbp_detect`` span: the ladder's plan, its K5 wrappers and the
emission, its child spans included), over the traced batches, as
``kernel_host_ms`` takes them."""

from portbench import spec

_calls = spec.metric_reader("kernel_host_ms")

NAME = "gs.ops.lbp_detect"


def read(ctx):
    calls = _calls.traced_calls(ctx)
    if calls is None or not any(s.name == NAME for call in calls for s in call):
        return None
    return _calls.host_ms(calls, lambda name: name == NAME)
