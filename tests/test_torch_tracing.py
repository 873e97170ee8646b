"""The port's spans (``profiling.span``) on the CPU.

With no profiler session a span reads one flag and does nothing else; in one
the entry calls leave the layer tree ``gs.pipelines`` -> ``gs.ops`` ->
``gs.kernels`` in the store and on the profiler's timeline, and change no
output.  The card's test (the spans against the launch counters) is in
``tests/test_torch_cuda.py``.
"""

import collections
import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import grayskull_tpu_torch as gt
from grayskull_tpu_torch import profiling
from tests.test_torch_cuda import host_arrays_on_cpu  # noqa: F401

DOC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "testdata",
                   "document.pgm")

SCAN_TREE = {  # (span, its parent's name) -> spans a call
    ("gs.pipelines.scan", None): 1,
    ("gs.pipelines.scan.binarize", "gs.pipelines.scan"): 1,
    ("gs.kernels.blur_hist", "gs.pipelines.scan.binarize"): 1,
    ("gs.kernels.otsu", "gs.pipelines.scan.binarize"): 1,
    ("gs.ops.blobs", "gs.pipelines.scan"): 1,
    ("gs.kernels.ccl", "gs.ops.blobs"): 1,
    ("gs.ops.blobs.stats", "gs.ops.blobs"): 1,
    ("gs.kernels.blob_stats", "gs.ops.blobs.stats"): 1,
    ("gs.ops.blobs.compact", "gs.ops.blobs"): 1,
    ("gs.ops.blob_corners", "gs.pipelines.scan"): 1,
    ("gs.ops.perspective_correct", "gs.pipelines.scan"): 1,
    ("gs.kernels.quad_warp", "gs.ops.perspective_correct"): 1,
}
PREPROCESS_TREE = {
    ("gs.pipelines.preprocess", None): 1,
    ("gs.kernels.blur_hist", "gs.pipelines.preprocess"): 1,
    ("gs.kernels.otsu", "gs.pipelines.preprocess"): 1,
    ("gs.kernels.threshold_sobel", "gs.pipelines.preprocess"): 1,
}


def _faces_tree(nscales):
    return {("gs.pipelines.detect_faces", None): 1,
            ("gs.kernels.integral", "gs.pipelines.detect_faces"): 1,
            ("gs.ops.lbp_detect", "gs.pipelines.detect_faces"): 1,
            ("gs.kernels.lbp_eval_scale", "gs.ops.lbp_detect"): nscales,
            ("gs.ops.lbp.emit", "gs.ops.lbp_detect"): 1}


def _pages():
    doc = gt.io.read_pgm(DOC)[::8, ::8]  # 128 x 96
    return torch.from_numpy(np.stack([np.roll(doc, 7 * i, axis=1) for i in range(2)]))


def _frames():
    return torch.from_numpy(np.random.default_rng(31).integers(0, 256, (2, 40, 56),
                                                                dtype=np.uint8))


def _inputs():
    pages = _pages()
    return pages, pages[:1].contiguous(), _frames()


def _run_calls(pages, page, frames):
    """Two ``scan`` calls and one ``preprocess`` call: their outputs."""
    return [gt.scan(pages, out_size=(40, 30)), gt.scan(page, out_size=(20, 16)),
            gt.preprocess(frames)]


def _profiled(fn, *args):
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, prof


def _calls(spans):
    by_call = collections.defaultdict(list)
    for s in spans:
        by_call[s.call].append(s)
    return [by_call[c] for c in sorted(by_call)]


def _tree(call):
    names = {s.id: s.name for s in call}
    return collections.Counter((s.name, names.get(s.parent)) for s in call)


class _CountingFlag:
    """A stand-in for ``torch.autograd.profiler`` that counts reads of its flag."""

    def __init__(self, value):
        self.value, self.reads = value, 0

    @property
    def _is_profiler_enabled(self):
        self.reads += 1
        return self.value


def test_the_private_flag_follows_the_profiler():
    """The gate reads ``torch.autograd.profiler._is_profiler_enabled``: if a torch
    upgrade drops or stops setting it, this fails, not the spans in silence."""
    flag = torch.autograd.profiler
    assert flag._is_profiler_enabled is False
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert flag._is_profiler_enabled is True
        assert profiling.span("gs.test") is not profiling.span("gs.test")
    finally:
        prof.stop()
    assert flag._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert flag._is_profiler_enabled is True
    assert flag._is_profiler_enabled is False


def test_with_no_profiler_a_span_reads_one_flag_and_does_nothing(monkeypatch):
    profiling.clear_spans()
    a, b = profiling.span("gs.a"), profiling.span("gs.b")
    assert a is b  # one shared null context
    flag = _CountingFlag(False)
    monkeypatch.setattr(profiling, "_autograd_profiler", flag)

    def refuse(*args, **kwargs):
        raise AssertionError("no record_function and no clock with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling.time, "perf_counter_ns", refuse)
    with profiling.span("gs.a") as inside:
        assert inside is None
    assert flag.reads == 1

    @profiling.spanned("gs.f")
    def f(x):
        return x + 1

    assert f(1) == 2 and flag.reads == 2
    assert profiling.spans() == []


def test_with_no_profiler_the_entry_calls_store_nothing():
    profiling.clear_spans()
    _run_calls(*_inputs())
    assert profiling.spans() == []


def test_spans_of_the_entry_calls_form_the_layer_tree():
    _profiled(_run_calls, *_inputs())
    calls = _calls(profiling.spans())
    assert [_tree(c) for c in calls] == [SCAN_TREE, SCAN_TREE, PREPROCESS_TREE]
    assert len({c[0].call for c in calls}) == 3  # a call id a call
    for call in calls:
        by_id = {s.id: s for s in call}
        root = [s for s in call if s.parent is None]
        assert len(root) == 1 and root[0].id == root[0].call
        for s in call:
            assert s.start_ns <= s.end_ns
            if s.parent is not None:
                parent = by_id[s.parent]
                assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns, s
            if s.name.startswith("gs.kernels."):  # kernel spans do not nest
                assert not by_id[s.parent].name.startswith("gs.kernels.")
    ends = [(c[-1].start_ns, c[-1].end_ns) for c in calls]  # the root closes last
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))


def test_spans_lie_on_the_profilers_timeline_around_their_aten_ops():
    _, prof = _profiled(_run_calls, *_inputs())  # inputs made outside the session
    events = list(prof.events())
    spans = [e for e in events if e.name.startswith("gs.")]
    assert collections.Counter(e.name for e in spans) == collections.Counter(
        s.name for s in profiling.spans())
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in spans)
    assert all(getattr(e, "is_user_annotation", True) for e in spans)
    entries = sorted((e.time_range.start, e.time_range.end) for e in spans
                     if e.name in ("gs.pipelines.scan", "gs.pipelines.preprocess"))
    assert len(entries) == 3
    ops = [e for e in events if e.name.startswith("aten::")]
    assert ops
    for op in ops:  # the session ran the entry calls alone
        assert any(s <= op.time_range.start and op.time_range.end <= e
                   for s, e in entries), op.name
    for e in spans:
        assert any(s <= e.time_range.start and e.time_range.end <= end for s, end in entries)


def test_outputs_are_bit_identical_with_spans_on_and_off():
    inputs = _inputs()
    off = _run_calls(*inputs)
    on, _ = _profiled(_run_calls, *inputs)
    assert profiling.spans()
    for a, b in zip(off, on):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_a_span_ends_on_an_exception_and_threads_keep_their_own_stacks():
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with profiling.span("gs.test.outer"):
                with profiling.span("gs.test.inner"):
                    raise ValueError("planted")

        def worker():
            with profiling.span("gs.test.thread"):
                with profiling.span("gs.test.thread.child"):
                    pass

        with profiling.span("gs.test.main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
        with profiling.span("gs.test.after"):
            pass
    got = {s.name: s for s in profiling.spans()}
    assert got["gs.test.inner"].parent == got["gs.test.outer"].id
    assert got["gs.test.outer"].parent is None
    assert got["gs.test.thread"].parent is None  # not under the main thread's open span
    assert got["gs.test.after"].parent is None
    assert got["gs.test.thread.child"].parent == got["gs.test.thread"].id
    assert got["gs.test.after"].call != got["gs.test.outer"].call


def test_the_store_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(profiling, "_store", collections.deque(maxlen=3))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with profiling.span(f"gs.test.{i}"):
                pass
    assert [s.name for s in profiling.spans()] == ["gs.test.2", "gs.test.3", "gs.test.4"]
    profiling.clear_spans()
    assert profiling.spans() == []


def test_the_chrome_trace_shows_the_spans(tmp_path):
    profiling.clear_spans()
    with profiling.trace(str(tmp_path / "tb")):
        gt.scan(_pages(), out_size=(40, 30))
    with open(tmp_path / "tb" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {name for name, _ in SCAN_TREE} <= names


def test_chip_smokes_device_events_leave_out_the_spans_device_copies():
    """A span's ``record_function`` range has a device copy, typed CUDA and
    marked a user annotation; ``chip_smoke``'s readers count kernels, copies
    and fills alone (its launches a call, busy time and idle share)."""
    import types

    import chip_smoke

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [types.SimpleNamespace(name="blur_hist_kernel", device_type=cuda,
                                    is_user_annotation=False),
              types.SimpleNamespace(name="gs.kernels.blur_hist", device_type=cuda,
                                    is_user_annotation=True),
              types.SimpleNamespace(name="gs.kernels.blur_hist", device_type=cpu,
                                    is_user_annotation=True),
              types.SimpleNamespace(name="Memset (Device)", device_type=cuda)]
    prof = types.SimpleNamespace(events=lambda: events)
    assert [e.name for e in chip_smoke.device_events(prof)] == ["blur_hist_kernel",
                                                                "Memset (Device)"]


def test_a_detect_faces_call_forms_its_layer_tree_and_counts_its_windows():
    """One profiled ``detect_faces`` call: one outermost pipeline span, the LBP
    op under it with the emission inside, a kernel span for K4 and one for K5
    a ladder scale (the CPU path: no launch), and the windows counter's rise of
    the ladder's windows times the frames; outside a session nothing is stored."""
    from grayskull_tpu_torch import kernels as K
    from grayskull_tpu_torch.ops import lbp as lbp_ops
    from grayskull_tpu_torch.ops.lbp import _grid_plan

    frames = torch.from_numpy(np.random.default_rng(37).integers(0, 256, (2, 40, 57),
                                                                 dtype=np.uint8))
    plan = _grid_plan(gt.load_frontalface(), 40, 57, 1.2, 1.0, 4.0, 1)
    assert len(plan) == 3
    profiling.clear_spans()
    off = gt.detect_faces(frames)
    assert profiling.spans() == []
    K.reset_launch_counts()
    windows = lbp_ops.counters["windows"]
    on, _ = _profiled(gt.detect_faces, frames)
    assert lbp_ops.counters["windows"] - windows == 2 * sum(ny * nx for *_, ny, nx in plan)
    assert not any(K.launch_counts().values())
    calls = _calls(profiling.spans())
    assert [_tree(c) for c in calls] == [_faces_tree(len(plan))]
    root = calls[0][-1]
    assert root.name == "gs.pipelines.detect_faces" and root.parent is None
    for a, b in zip(off, on):
        assert torch.equal(a, b)
