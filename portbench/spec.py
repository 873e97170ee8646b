"""Find a cell's files by name: its entry in ``BENCHMARK.json``, its
configuration and traffic files, and the driver, reference and metric
modules, each loaded from its own file."""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark() -> dict:
    return _load_json(ROOT / "BENCHMARK.json")


def config(name: str) -> dict:
    return _load_json(HERE / "configs" / f"{name}.json")


def workload(name: str) -> dict:
    return _load_json(HERE / "workloads" / f"{name}.json")


def driver(config_name: str):
    return _load_module("drivers", config_name)


def reference(config_name: str):
    return _load_module("reference", config_name)


def stem(metric_name: str) -> str:
    """The quantity a metric measures: its name up to a first dot.  The rest
    names a family of cells (``frames_per_s.sync``) that reports the same
    quantity under bounds of its own."""
    return metric_name.split(".")[0]


def metric_reader(metric_name: str):
    """The reader of the metric's quantity, ``metrics/<stem>.py``."""
    return _load_module("metrics", stem(metric_name))


def per_layer_metrics(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics that ``cell`` reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end_metrics(bench, cell)}
    out = []
    for m in bench["per_layer"]:
        if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in reported):
            out.append(m)
    return out


def end_to_end_metrics(bench: dict, cell: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
