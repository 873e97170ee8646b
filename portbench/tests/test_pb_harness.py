"""The benchmark's parts on the CPU, at sizes a test run holds: the seeded
pool, the files found by name, the roofline counts, the references against
the port's CPU path, the trace reduction, the comparison against the
control and planted faults, the ban on JAX, and a configuration added as
new files alone."""

from __future__ import annotations

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import pb_faults
from portbench import compare, frames, roofline, run, spec, trace

PORTBENCH = pathlib.Path(spec.HERE)
BENCH = spec.benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]
SEED = 2**31 + 977  # past 32 signed bits, as the driver's seeds are


def _config_of(cell):
    return next(c["config"] for c in BENCH["workloads"] if c["name"] == cell)


def _cpu_sizes(config):
    """The configuration's ``cpu`` block: a cell at a size the CPU runs in about a second."""
    return spec.config(config)["cpu"]


def test_pool_is_seeded_and_frames_differ():
    content = spec.config("preprocess_1mp")["content"]
    a = frames.make_pool(content, 12, 64, 96, SEED, "cpu")
    b = frames.make_pool(content, 12, 64, 96, SEED, "cpu")
    c = frames.make_pool(content, 12, 64, 96, SEED + 1, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (12, 64, 96)
    assert torch.equal(a, b) and not torch.equal(a, c)
    thresholds = spec.reference("preprocess_1mp").reference(a, {"radius": 2})["thresholds"]
    assert len(set(thresholds.tolist())) >= 6  # frames differ in their Otsu threshold
    assert len({bytes(f.numpy()) for f in a}) == 12


def test_pool_follows_the_image_roll_gain_and_offset():
    content = {"image": "portbench/data/lena.pgm", "roll_max": 0, "gain": [1.0, 1.0],
               "offset": [0, 0]}
    pool = frames.make_pool(content, 2, 200, 300, SEED, "cpu")
    base = frames.base_image(content, 200, 300)
    assert np.array_equal(pool[1].numpy(), base)
    assert np.array_equal(base[:128, :128], frames.read_pgm(spec.ROOT / content["image"]))
    assert np.array_equal(base[128:, 128:256], base[:72, :128])


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_loads_by_name(cell):
    config = _config_of(cell)
    cfg, traffic = spec.config(config), spec.workload(cell)
    assert traffic["name"] == cell and cfg["name"] == config
    assert {"batch", "in_flight", "pool_frames", "warmup_batches", "check_batches",
            "trace_batches"} <= set(traffic)
    assert traffic["pool_frames"] % traffic["batch"] == 0
    assert callable(spec.driver(config).call) and callable(spec.reference(config).reference)
    assert spec.per_layer_metrics(BENCH, cell) and spec.end_to_end_metrics(BENCH, cell)
    for m in spec.per_layer_metrics(BENCH, cell):
        assert callable(spec.metric_reader(m["name"]).read)


def test_benchmark_entries_point_at_their_files():
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert (spec.ROOT / c["file"]).is_file()
    for m in BENCH["per_layer"]:
        assert (PORTBENCH / "metrics" / f"{spec.stem(m['name'])}.py").is_file()
    assert {spec.stem(m["name"]) for m in BENCH["end_to_end"]} == {
        "frames_per_s", "batch_p95_ms", "setup_s"}  # the quantities run.py takes


@pytest.mark.parametrize("config", CONFIGS)
def test_every_configuration_holds_its_cpu_test_size(config):
    # run.run_cell takes the frame's height and width and the counts of the cell's traffic
    allowed = {"height", "width"}
    for cell in (c["name"] for c in BENCH["workloads"] if c["config"] == config):
        allowed |= {k for k, v in spec.workload(cell).items() if isinstance(v, int)}
    sizes = _cpu_sizes(config)
    assert sizes and set(sizes) <= allowed, set(sizes) - allowed


def test_a_family_of_cells_reads_its_quantity_by_the_stem():
    assert spec.stem("frames_per_s.sync") == "frames_per_s"
    assert spec.stem("setup_s") == "setup_s"
    assert spec.metric_reader("device_idle_pct.sync").__file__.endswith("device_idle_pct.py")
    for cell in CELLS:  # each cell reports each quantity once, and what it moves
        e2e = [m["name"] for m in spec.end_to_end_metrics(BENCH, cell)]
        assert len({spec.stem(n) for n in e2e}) == len(e2e) == 3
        for m in spec.per_layer_metrics(BENCH, cell):
            assert m["moves"] in e2e


def test_roofline_counts_match_the_kernel_table():
    k1 = spec.metric_reader("k1_blur_hist_roofline")
    k9 = spec.metric_reader("k9_ccl_roofline")
    k22 = spec.metric_reader("k22_blob_stats_roofline")
    # PERF.md: K1 on 256 x 1 MP reads and writes 537,133,056 bytes, 0.16034 ms
    assert k1.least_bytes(256, 1024, 1024) == 537_133_056
    ms = 1e3 * roofline.least_seconds(k1.least_bytes(256, 1024, 1024),
                                      k1.operations(256, 1024, 1024))
    assert ms == pytest.approx(0.1603382256716418, rel=1e-12)
    # PERF.md: K9 on 8 pages of 1024 x 768 moves 31.5 MB (5 bytes a pixel)
    assert k9.least_bytes(8, 1024, 768) == 31_457_280
    # PERF.md: K22 on 32 pages of 1024 x 768 with 1000 labels, 102,457,088 bytes
    assert k22.least_bytes(32, 1024, 768, 1000) == 102_457_088
    ms = 1e3 * roofline.least_seconds(k22.least_bytes(32, 1024, 768, 1000), 0)
    assert ms == pytest.approx(0.03058420537313433, rel=1e-12)
    assert roofline.share_pct(1.0, 0.0, 0.0) is None


def _port_outputs(config, pool):
    params = spec.config(config)["params"]
    return spec.driver(config).call(pool, params), params


@pytest.mark.parametrize("seed", [1, SEED])
def test_preprocess_reference_equals_the_port_on_the_cpu(seed):
    pool = frames.make_pool(spec.config("preprocess_1mp")["content"], 6, 80, 144, seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    noise = torch.randint(0, 256, (2, 33, 47), generator=gen, dtype=torch.uint8)
    for batch in (pool, noise):
        got, params = _port_outputs("preprocess_1mp", batch)
        want = spec.reference("preprocess_1mp").reference(batch, params)
        assert set(want) == set(got)
        for key in want:
            assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("seed", [3, SEED])
def test_scan_reference_equals_the_port_on_the_cpu(seed):
    content = spec.config("document_scan")["content"]
    pool = frames.make_pool(content, 3, 160, 120, seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    blobs = (torch.rand((3, 70, 90), generator=gen) < 0.55).to(torch.uint8) * 200
    blank = torch.zeros((1, 40, 50), dtype=torch.uint8)  # no blob: corners at (0, 0)
    params = {**spec.config("document_scan")["params"], "out_size": [37, 29]}
    for batch in (pool, blobs, blank):
        got = spec.driver("document_scan").call(batch, params)
        want = spec.reference("document_scan").reference(batch, params)
        assert torch.equal(got["corners"], want["corners"])
        assert torch.equal(got["pages"], want["pages"])
    # a small cap drops late labels: the largest blob is taken among the first ones
    capped = {**params, "max_blobs": 3}
    got = spec.driver("document_scan").call(blobs, capped)
    want = spec.reference("document_scan").reference(blobs, capped)
    assert torch.equal(got["corners"], want["corners"])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_on_the_cpu_is_correct(cell):
    result = run.run_cell(cell, SEED, 0.3, 0, device="cpu", sizes=_cpu_sizes(_config_of(cell)))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end_metrics(BENCH, cell)}
    assert {spec.stem(n) for n in result["metrics"]} == {"frames_per_s", "batch_p95_ms", "setup_s"}
    assert result["checked"]["whole_outputs"] >= 1


@pytest.mark.parametrize("fault", ["control", *pb_faults.FAULTS])
@pytest.mark.parametrize("config", CONFIGS)
def test_the_control_and_each_fault_come_out_not_correct(config, fault):
    cell = next(c["name"] for c in BENCH["workloads"] if c["config"] == config)
    make = pb_faults.control if fault == "control" else pb_faults.FAULTS[fault]
    result = run.run_cell(cell, SEED, 0.3, 0, device="cpu", sizes=_cpu_sizes(config),
                          call=make(config))
    assert not result["correct"], result["checks"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_verdict_needs_every_number_and_limit():
    assert compare.verdict({"a": 0}, {"a": 0}) == (True, {"a": {"value": 0, "limit": 0}})
    assert not compare.verdict({"a": 1}, {"a": 0})[0]
    assert not compare.verdict({}, {"a": 0})[0]
    assert not compare.verdict({"a": 0, "b": 0}, {"a": 0})[0]


def test_percentile_is_numpys():
    values = sorted(np.random.default_rng(5).random(137).tolist())
    for q in (50, 95, 99):
        assert run._percentile(values, q) == pytest.approx(np.percentile(values, q))


class _Event:
    def __init__(self, name, start, end, cuda=False):
        self.name = name
        self.time_range = types.SimpleNamespace(start=start, end=end)
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)


class _Profile:
    """A stopped profiler's events, on the trace's clock in us."""

    def __init__(self, events, op_device_us):
        self._events = events
        self._ops = [types.SimpleNamespace(key=k, self_device_time_total=v)
                     for k, v in op_device_us.items()]

    def events(self):
        return self._events

    def key_averages(self):
        return self._ops


def _fake_trace():
    kernel = "void (anonymous namespace)::blur_hist_kernel<0>(unsigned char const*)"
    ccl = "(anonymous namespace)::tile_kernel(unsigned char const*, int*)"
    init = "(anonymous namespace)::blob_stats_init_kernel(long long*, unsigned long)"
    stats = "void (anonymous namespace)::blob_stats_kernel<true>(int const*, long long*, int)"
    events = [
        _Event("portbench.call", 0, 40), _Event("aten::cumsum", 10, 30),
        _Event("portbench.wait", 40, 100), _Event("portbench.call", 100, 120),
        _Event("portbench.wait", 120, 200),
        _Event("portbench.call", 5, 60, cuda=True),  # the device copy of a span
        _Event(kernel, 20, 60, cuda=True), _Event(ccl, 50, 80, cuda=True),
        _Event(init, 62, 63, cuda=True), _Event(stats, 65, 75, cuda=True),
        _Event(kernel, 130, 170, cuda=True), _Event(ccl, 165, 190, cuda=True),
        _Event(init, 171, 172, cuda=True), _Event(stats, 172, 187, cuda=True),
    ]
    return _Profile(events, {"aten::cumsum": 5.0})


def test_trace_reduction_on_a_known_timeline():
    t = trace.summarize(_fake_trace(), 2)
    assert t.window_s == pytest.approx(200e-6)
    assert t.busy_s == pytest.approx((80 - 20 + 190 - 130) * 1e-6)
    assert len(t.device_events) == 8
    gaps = dict(t.breakdown["idle_gaps"])
    assert gaps["portbench.call/aten::cumsum"] == pytest.approx(20e-6)  # 0 .. 20
    assert gaps["portbench.call/-"] == pytest.approx(50e-6)  # 80 .. 130
    assert gaps["portbench.wait/-"] == pytest.approx(10e-6)  # 190 .. 200
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)
    # the untraced batches took 100 us each: the device was busy 60 of them
    ctx = types.SimpleNamespace(trace=t, call_s=[0.001, 0.003], batch_wall_s=100e-6,
                                batch_shape=(2, 8, 16), params={"max_blobs": 5})
    values = {name: spec.metric_reader(name).read(ctx)
              for name in [m["name"] for m in BENCH["per_layer"]]}
    for name, value in values.items():
        assert value == values[spec.stem(name)], name
    assert values["host_call_ms"] == pytest.approx(2.0)
    assert values["device_ops_per_batch"] == 4
    assert values["device_idle_pct"] == pytest.approx(40.0)
    k1 = roofline.least_seconds(2 * 2 * 8 * 16 + 1024 * 2, 10 * 2 * 8 * 16)
    assert values["k1_blur_hist_roofline"] == pytest.approx(100 * k1 / 40e-6)
    k9 = roofline.least_seconds(5 * 2 * 8 * 16, 10 * 2 * 8 * 16)
    assert values["k9_ccl_roofline"] == pytest.approx(100 * k9 / 27.5e-6)
    # two calls of K22: (1 + 10) and (1 + 15) us
    k22 = roofline.least_seconds(4 * 2 * 8 * 16 + 56 * 2 * (5 + 1), 0)
    assert values["k22_blob_stats_roofline"] == pytest.approx(100 * k22 / 13.5e-6)
    ctx.params = {}  # no label cap: nothing to count K22's bytes from
    assert spec.metric_reader("k22_blob_stats_roofline").read(ctx) is None


def test_readers_with_nothing_to_read_return_nothing():
    empty = types.SimpleNamespace(trace=None, call_s=[], batch_wall_s=None,
                                  batch_shape=(1, 1, 1), params={})
    for m in BENCH["per_layer"]:
        assert spec.metric_reader(m["name"]).read(empty) is None
    bare = trace.summarize(_Profile([_Event("portbench.call", 0, 1),
                                     _Event("portbench.wait", 1, 2)], {}), 1)
    assert bare is None


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_nothing_under_portbench_imports_jax_or_the_jax_package():
    files = sorted(PORTBENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(run.BANNED), (path, tops & set(run.BANNED))
        text = path.read_text()
        for old in ("bench.py", "chip_smoke", "benchmarks/"):
            assert old not in text or path.name == pathlib.Path(__file__).name, (path, old)


def test_the_references_import_nothing_of_the_port():
    for path in sorted((PORTBENCH / "reference").glob("*.py")) + [PORTBENCH / "plain.py"]:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "torch", "portbench"}, (path, tops)


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    import grayskull_tpu_torch  # noqa: F401  the port, whose name begins with a banned one

    assert "grayskull_tpu_torch" in sys.modules
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "grayskull_tpu.ops", types.ModuleType("grayskull_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert run.banned_modules() == ["grayskull_tpu", "jaxlib"]


def test_run_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "no CUDA device" in err


ADDITION = PORTBENCH / "tests" / "addition"  # a toy configuration, laid out as portbench/ is
TOY_CELL = {"name": "invert.bulk", "config": "invert", "traffic": "bulk", "chips": 1,
            "why": "a toy cell that the benchmark takes from new files and appended entries alone"}


def _files(root):
    return {p.relative_to(root) for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _contents(root):
    return {rel: (root / rel).read_bytes() for rel in _files(root)}


def test_a_configuration_is_added_as_new_files_alone(tmp_path):
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for rel in _files(ADDITION):  # the configuration, traffic, driver and reference
        dest = tmp_path / "portbench" / rel
        assert not dest.exists(), rel
        shutil.copy(ADDITION / rel, dest)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "invert", "source": "https://github.com/zserge/grayskull",
                             "file": "portbench/configs/invert.json", "reduced": [],
                             "why": "a toy configuration: each pixel p becomes 255 - p"})
    bench["workloads"].append(TOY_CELL)
    for m in bench["end_to_end"]:
        if m["name"] in ("frames_per_s", "batch_p95_ms"):
            m["workloads"].append(TOY_CELL["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    added = _contents(tmp_path / "portbench")

    # the copy's root first, the repository's after it for the port
    path = [str(tmp_path), str(spec.ROOT), os.environ.get("PYTHONPATH", "")]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in path if p)}
    generic = "invert or test_a_family_of_cells or test_benchmark_entries"
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "portbench/tests/test_pb_harness.py", "-v",
         "-p", "no:cacheprovider", "--rootdir", str(tmp_path), "-k", generic],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    passed = {line.split(" PASSED")[0].split("::")[-1] for line in proc.stdout.splitlines()
              if " PASSED" in line}
    toy = {"test_every_file_of_a_cell_loads_by_name[invert.bulk]",
           "test_every_configuration_holds_its_cpu_test_size[invert]",
           "test_a_sound_run_on_the_cpu_is_correct[invert.bulk]",
           "test_a_family_of_cells_reads_its_quantity_by_the_stem",
           "test_benchmark_entries_point_at_their_files",
           *(f"test_the_control_and_each_fault_come_out_not_correct[invert-{fault}]"
             for fault in ["control", *pb_faults.FAULTS])}
    assert toy <= passed, sorted(toy - passed)
    assert _contents(tmp_path / "portbench") == added, "the run wrote into portbench/"
