"""The readings that each limit is set from, on the card at each cell's own
size: sound runs of the port on a dozen seeds, the control (the reference
one precision lower) and each planted fault on three, each a short window of
the cell's own traffic compared as a run compares.  Prints one JSON line of
readings a cell.

    python -m pytest portbench/tests/test_pb_chip.py -m cuda -s
"""

from __future__ import annotations

import json

import pytest
import torch

import pb_faults
from portbench import run, spec

BENCH = spec.benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
SOUND_SEEDS = [2**31 + 101 * k for k in range(12)]
FAULT_SEEDS = [3 * 2**30 + 7 * k for k in range(3)]
SECONDS = 1.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _values(result):
    return {name: c["value"] for name, c in result["checks"].items()}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_limits_separate_sound_runs_from_the_control_and_faults(card, cell):
    config = next(c["config"] for c in BENCH["workloads"] if c["name"] == cell)
    readings = {"sound": []}
    for seed in SOUND_SEEDS:
        result = run.run_cell(cell, seed, SECONDS, 0)
        readings["sound"].append(_values(result))
        assert result["correct"], (seed, result["checks"])
    for name, make in {"control": pb_faults.control, **pb_faults.FAULTS}.items():
        readings[name] = []
        for seed in FAULT_SEEDS:
            result = run.run_cell(cell, seed, SECONDS, 0, call=make(config))
            readings[name].append(_values(result))
            assert not result["correct"], (name, seed, result["checks"])
    print(json.dumps({"cell": cell, "device": torch.cuda.get_device_name(),
                      "readings": readings}))
