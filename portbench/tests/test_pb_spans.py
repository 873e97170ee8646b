"""The readers of the program's spans (``kernel_host_ms``, ``blobs_host_ms``) on
a store that a CPU profiler session filled through the cells' own drivers."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from grayskull_tpu_torch import profiling
from portbench import spec

PARAMS = {"preprocess_1mp": spec.config("preprocess_1mp")["params"],
          "document_scan": {**spec.config("document_scan")["params"], "out_size": [40, 32]}}


def _batch(seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (2, 48, 64),
                                                                 dtype=np.uint8))


def _fill(config, calls):
    """``calls`` driver calls under a profiler session, after one outside it."""
    driver = spec.driver(config)
    batches = [_batch(i) for i in range(calls + 1)]
    profiling.clear_spans()
    driver.call(batches[0], PARAMS[config])  # untraced: records nothing
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        for b in batches[1:]:
            driver.call(b, PARAMS[config])
    return profiling.spans()


def _ctx(batches):
    return types.SimpleNamespace(trace=types.SimpleNamespace(batches=batches), call_s=[],
                                 batch_wall_s=None, batch_shape=(2, 48, 64), params={})


def _ms_a_call(spans, keep, last):
    calls = sorted({s.call for s in spans})[-last:]
    ns = sum(s.end_ns - s.start_ns for s in spans if s.call in calls and keep(s.name))
    return ns / 1e6 / last


@pytest.fixture(autouse=True)
def _empty_store():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def test_both_readers_on_the_scan_driver_read_the_last_calls():
    spans = _fill("document_scan", 5)
    assert len({s.call for s in spans}) == 5
    kernels = spec.metric_reader("kernel_host_ms.sync").read(_ctx(3))
    blobs = spec.metric_reader("blobs_host_ms.sync").read(_ctx(3))
    assert kernels == pytest.approx(_ms_a_call(spans, lambda n: n.startswith("gs.kernels."), 3))
    assert blobs == pytest.approx(_ms_a_call(spans, lambda n: n == "gs.ops.blobs", 3))
    entry = _ms_a_call(spans, lambda n: n == "gs.pipelines.scan", 3)
    assert 0 < kernels < entry and 0 < blobs < entry
    assert spec.metric_reader("kernel_host_ms").read(_ctx(5)) == pytest.approx(
        _ms_a_call(spans, lambda n: n.startswith("gs.kernels."), 5))


def test_kernel_host_ms_reads_the_preprocess_driver_and_blobs_host_ms_nothing():
    spans = _fill("preprocess_1mp", 2)
    kernels = spec.metric_reader("kernel_host_ms").read(_ctx(2))
    assert kernels == pytest.approx(_ms_a_call(spans, lambda n: n.startswith("gs.kernels."), 2))
    assert kernels > 0
    assert spec.metric_reader("blobs_host_ms").read(_ctx(2)) is None


def test_readers_return_nothing_when_the_store_is_short():
    _fill("document_scan", 2)
    for name in ("kernel_host_ms", "blobs_host_ms"):
        reader = spec.metric_reader(name)
        assert reader.read(_ctx(3)) is None
        assert reader.read(_ctx(2)) is not None
        assert reader.read(types.SimpleNamespace(trace=None)) is None
    profiling.clear_spans()
    assert spec.metric_reader("kernel_host_ms").read(_ctx(1)) is None


def test_readers_return_nothing_for_a_program_without_spans(monkeypatch):
    _fill("document_scan", 2)
    monkeypatch.delattr(profiling, "spans")
    for name in ("kernel_host_ms", "blobs_host_ms"):
        assert spec.metric_reader(name).read(_ctx(1)) is None
