"""The readers that ``lbp_faces_vga.bulk`` adds (``k4_integral_roofline``,
``k5_lbp_roofline``, ``lbp_host_ms``) on synthetic traces and on a store of
spans that a CPU profiler session filled through the cell's own driver."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from grayskull_tpu_torch import profiling
from portbench import roofline, spec

PARAMS = spec.config("lbp_faces_vga")["params"]
CELL = (32, 480, 640)
ARGS = "(unsigned char const*, unsigned int*, int, int)"
K4 = "void (anonymous namespace)::band_scan_kernel<true>" + ARGS
K4_TOTALS = "void (anonymous namespace)::band_totals_kernel<true>" + ARGS
K4_CARRY = "(anonymous namespace)::carry_scan_kernel(unsigned int*, int, int, int)"
K5 = ("(anonymous namespace)::lbp_scale_kernel(unsigned int const*, int const*, unsigned char*, "
      + ", ".join(["int"] * 12) + ")")


def _ctx(device_events, batches=1, params=PARAMS, shape=CELL):
    trace = types.SimpleNamespace(device_events=device_events, batches=batches)
    return types.SimpleNamespace(trace=trace, call_s=[], batch_wall_s=None, batch_shape=shape,
                                 params=params)


def test_k4_counts_its_bytes_at_the_cell():
    k4 = spec.metric_reader("k4_integral_roofline")
    assert k4.least_bytes(*CELL) == 49_152_000
    ms = 1e3 * roofline.least_seconds(k4.least_bytes(*CELL), 0)
    assert ms == pytest.approx(0.014672238805970149, rel=1e-12)


def test_k4_reads_its_three_kernels_a_call():
    k4 = spec.metric_reader("k4_integral_roofline")
    # two calls: (2 + 1 + 20) and (3 + 1 + 20) us; the K5 and copy events are not K4's
    events = [(K4_TOTALS, 2e-6), (K4_CARRY, 1e-6), (K4, 20e-6), (K5, 1e-3),
              (K4_TOTALS, 3e-6), (K4_CARRY, 1e-6), (K4, 20e-6), ("Memcpy DtoH", 5e-6)]
    least = roofline.least_seconds(49_152_000, 0)
    assert k4.read(_ctx(events, 2)) == pytest.approx(100 * least / 23.5e-6)
    assert k4.read(_ctx([(K5, 1e-3)])) is None


def test_k5_counts_the_stage_zero_floor_at_the_cell():
    k5 = spec.metric_reader("k5_lbp_roofline")
    grid = k5.ladder(PARAMS, 480, 640)
    assert len(grid) == 8 and grid[0] == (457, 617)
    assert 32 * sum(ny * nx for ny, nx in grid) == 65_606_752
    counts = k5.counts(PARAMS, *CELL)
    assert sum(b for b, _ in counts) == 380_179_552
    assert sum(ops for _, ops in counts) == 7_872_810_240
    assert 1e3 * k5.least_seconds(PARAMS, *CELL) == pytest.approx(0.11931000358208955,
                                                                  rel=1e-12)
    # scale 1.0 is bound by its operations, the largest scale by its bytes
    assert counts[0][1] / roofline.FP32_OPS_PER_S > counts[0][0] / roofline.HBM_BYTES_PER_S
    assert counts[-1][1] / roofline.FP32_OPS_PER_S < counts[-1][0] / roofline.HBM_BYTES_PER_S


def test_k5_ladder_follows_the_float32_scales_and_the_stride():
    k5 = spec.metric_reader("k5_lbp_roofline")
    # 24 x 1.2^k in float32, truncated: 24 28 34 41 49 59 71 85; 100 is past 4.0
    wins = [480 - ny + 1 for ny, _ in k5.ladder(PARAMS, 480, 640)]
    assert wins == [24, 28, 34, 41, 49, 59, 71, 85]
    assert k5.ladder({**PARAMS, "step": 2}, 480, 640)[0] == (229, 309)
    assert len(k5.ladder(PARAMS, 40, 640)) == 3  # a window past 40 rows stops the ladder
    assert k5.ladder({"max_blobs": 5}, 480, 640) == []


def test_k5_reads_a_call_as_its_launches_over_the_ladder():
    k5 = spec.metric_reader("k5_lbp_roofline")
    events = [(K5, 0.5e-3)] * 8 + [(K4, 20e-6)] + [(K5, 0.25e-3)] * 8
    least = k5.least_seconds(PARAMS, *CELL)
    assert k5.read(_ctx(events, 2)) == pytest.approx(100 * least / 3e-3)
    assert k5.read(_ctx([(K4, 20e-6)])) is None
    assert k5.read(_ctx(events, params={})) is None  # no ladder to count
    assert k5.read(types.SimpleNamespace(trace=None)) is None


@pytest.fixture
def _empty_store():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _fill(calls):
    """``calls`` driver calls on small frames under a profiler session."""
    driver = spec.driver("lbp_faces_vga")
    rng = np.random.default_rng(11)
    batches = [torch.from_numpy(rng.integers(0, 256, (2, 40, 57), dtype=np.uint8))
               for _ in range(calls)]
    with profile(activities=[ProfilerActivity.CPU]):
        for b in batches:
            driver.call(b, PARAMS)
    return profiling.spans()


def _ms_a_call(spans, keep, last):
    calls = sorted({s.call for s in spans})[-last:]
    return sum(s.end_ns - s.start_ns for s in spans
               if s.call in calls and keep(s.name)) / 1e6 / last


def test_lbp_host_ms_reads_nothing_without_the_spans(_empty_store):
    reader = spec.metric_reader("lbp_host_ms")
    assert reader.read(_ctx([], 1)) is None  # an empty store
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("gs.pipelines.preprocess"):
            pass
    assert reader.read(_ctx([], 1)) is None  # spans, but none of the LBP layer
    assert reader.read(types.SimpleNamespace(trace=None)) is None


def test_the_span_readers_take_a_faces_batch_as_one_call(_empty_store):
    spans = _fill(3)
    assert len({s.call for s in spans}) == 3  # one outermost span a batch
    lbp = spec.metric_reader("lbp_host_ms").read(_ctx([], 2))
    kernels = spec.metric_reader("kernel_host_ms").read(_ctx([], 2))
    assert lbp == pytest.approx(_ms_a_call(spans, lambda n: n == "gs.ops.lbp_detect", 2))
    assert kernels == pytest.approx(_ms_a_call(spans, lambda n: n.startswith("gs.kernels."), 2))
    entry = _ms_a_call(spans, lambda n: n == "gs.pipelines.detect_faces", 2)
    assert 0 < lbp < entry and 0 < kernels < entry
    per_call = [sum(s.name.startswith("gs.kernels.") for s in spans if s.call == c)
                for c in sorted({s.call for s in spans})]
    assert per_call == [1 + 3] * 3  # K4 and a K5 a ladder scale under each call
