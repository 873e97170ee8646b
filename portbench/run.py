"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s``, from the start of this process to the window's
start): import the port, load its kernel library (built by ``nvcc`` into
``grayskull_tpu_torch/_build/`` inside the checkout the first time), make
the cell's frame pool on the card from the seed, and run the cell's own
batches through the loop to warm them.  Then the window: the closed loop of
``loop.py`` for ``--seconds``.  After it: the peak memory, the comparison
with the plain reference (``compare.py``), and the check that no JAX module
was loaded.  The last line of standard output is one JSON object; the
compared numbers and their limits are also the last lines of standard error.

With ``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from the profiled first batches of
the window and the untraced rest by ``metrics/<name>.py``.  A metric named
``<quantity>.<family>`` (``frames_per_s.sync``) is that quantity, reported
by a family of cells that has bounds of its own.  Without a CUDA card, or with fewer
cards than the cell asks for, it prints no result and exits with 2.
"""

import time

_STARTED = time.perf_counter()  # the process's start, as near as this file gets

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

BANNED = ("jax", "jaxlib", "flax", "grayskull_tpu")  # top-level module names, whole


def banned_modules():
    """The banned top-level names among the loaded modules."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def _power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(name, seed, seconds, trace, *, device="cuda", started=None, call=None,
             sizes=None):
    """One run of the cell ``name``: the result's dict (the JSON line's object).

    ``call(frames, params)`` replaces the driver's call (the control and the
    planted faults of the tests); ``sizes`` overrides the frame geometry and
    the traffic's counts (``height``, ``width``, ``batch``, ``pool_frames``,
    ``check_batches``, ``trace_batches``, ``warmup_batches``) for a run on
    the CPU at a size a test can hold.
    """
    import torch

    from portbench import compare, frames, loop, spec, trace as tracing

    started = time.perf_counter() if started is None else started
    bench = spec.benchmark()
    cell = next((c for c in bench["workloads"] if c["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg, traffic = spec.config(cell["config"]), spec.workload(name)
    sizes = dict(sizes or {})
    height = sizes.pop("height", cfg["frame"]["height"])
    width = sizes.pop("width", cfg["frame"]["width"])
    traffic = {**traffic, **sizes}
    batch, depth = traffic["batch"], traffic["in_flight"]
    params = cfg["params"]
    driver, reference = spec.driver(cell["config"]), spec.reference(cell["config"])
    run_call = driver.call if call is None else call

    pool = frames.make_pool(cfg["content"], traffic["pool_frames"], height, width, seed, device)
    warm = loop.run(lambda f: run_call(f, params), driver.RESULT, pool, batch, depth, 0,
                    max_batches=traffic["warmup_batches"])
    if pool.is_cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started
    window = loop.run(lambda f: run_call(f, params), driver.RESULT, pool, batch, depth, seconds,
                      check_batches=traffic["check_batches"], seed=seed,
                      trace_batches=traffic["trace_batches"] if trace else 0,
                      first_batch=len(warm.latency_s))
    del warm
    peak = torch.cuda.max_memory_allocated() if pool.is_cuda else 0

    traced = None
    if trace:
        if window.profile is None:
            raise RuntimeError("the profiler saw no device event")
        traced = tracing.summarize(window.profile, window.traced)
        window.profile = None

    counts, wrong, checked = compare.compare(
        window, pool, batch, lambda f: reference.reference(f, params), driver.RESULT)
    correct, checks = compare.verdict(counts, cfg["limits"])

    metrics = {}
    if trace:
        untraced = len(window.latency_s) - window.traced
        ctx = types.SimpleNamespace(trace=traced, call_s=window.call_s[window.traced:],
                                    batch_wall_s=window.untraced_s / untraced if untraced else None,
                                    batch_shape=(batch, height, width), params=params)
        for m in spec.per_layer_metrics(bench, name):
            value = spec.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        lat_ms = sorted(1e3 * s for s in window.latency_s)
        e2e = {"frames_per_s": window.frames / window.seconds,
               "batch_p95_ms": _percentile(lat_ms, 95),
               "setup_s": setup_s}
        for m in spec.end_to_end_metrics(bench, name):
            metrics[m["name"]] = {"value": e2e[spec.stem(m["name"])], "unit": m["unit"]}

    dev = {"platform": "gpu" if pool.is_cuda else "cpu",
           "kind": torch.cuda.get_device_name() if pool.is_cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    if pool.is_cuda:
        dev["power_limit_w"] = _power_limit_w()
    if traced is not None:
        dev["busy_s"], dev["window_s"] = traced.busy_s, traced.window_s
    result = {"correct": correct, "attempted": len(window.latency_s), "failed": len(wrong),
              "metrics": metrics, "device": dev,
              "checked": {"batches": checked, "whole_outputs": len(window.kept)}}
    if traced is not None:
        result["breakdown"] = traced.breakdown
    result["checks"] = checks
    return result


def _percentile(sorted_values, q):
    """numpy's default (linear) percentile of sorted values."""
    pos = (len(sorted_values) - 1) * q / 100
    lo = int(pos)
    hi = min(lo + 1, len(sorted_values) - 1)
    return sorted_values[lo] + (sorted_values[hi] - sorted_values[lo]) * (pos - lo)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # the window runs no tensor op on the CPU: few threads in all
    from portbench import spec

    chips = next((c["chips"] for c in spec.benchmark()["workloads"]
                  if c["name"] == args.workload), None)
    if chips is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace, started=_STARTED)
    found = banned_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} = {check['value']} (limit {check['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
