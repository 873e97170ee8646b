"""The port's ``detect_faces`` against the benchmark's plain reference of the
LBP cascade (``portbench/reference/lbp_faces_vga.py``) on the CPU, exactly:
on the bundled frontal-face cascade and on seeded random cascades, at small
frames (odd widths among them), strides 1 and 2 and caps 5 and 100.  Also: the
reference imports nothing of either package, one window checked by hand, and
the bfloat16 control differs from the reference."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import grayskull_tpu_torch as gt
from grayskull_tpu_torch.core import lbp_cascade_from_arrays
from portbench import frames, spec
from tests.test_torch_cuda import host_arrays_on_cpu  # noqa: F401

REF = spec.reference("lbp_faces_vga")
CONFIG = spec.config("lbp_faces_vga")
PARAMS = CONFIG["params"]
SEED = 2**31 + 977


def _pool(count, h, w, seed=SEED):
    return frames.make_pool(CONFIG["content"], count, h, w, seed, "cpu")


def _port(batch, cascade, params):
    table = gt.detect_faces(batch, cascade, max_rects=params["max_rects"],
                            scale_factor=params["scale_factor"], min_scale=params["min_scale"],
                            max_scale=params["max_scale"], step=params["step"])
    return {"n": table.n, "rects": torch.stack([table.x, table.y, table.w, table.h], -1)}


def _assert_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


def _random_cascade(seed, window_w=24, window_h=24):
    """A seeded cascade: random features inside the window, leaf values and
    subset words, and each stage's threshold drawn between its least and its
    largest sum, so that a fair share of windows passes each stage."""
    rng = np.random.default_rng(seed)
    nfeat, nstages = 10, 4
    fw = rng.integers(1, window_w // 3 + 1, nfeat)
    fh = rng.integers(1, window_h // 3 + 1, nfeat)
    fx = rng.integers(0, window_w - 3 * fw + 1)
    fy = rng.integers(0, window_h - 3 * fh + 1)
    features = np.stack([fx, fy, fw, fh], 1)
    counts = rng.integers(1, 4, nstages)
    nweaks = int(counts.sum())
    left = rng.uniform(-1, 1, nweaks).astype(np.float32)
    right = rng.uniform(-1, 1, nweaks).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    thresholds = []
    for s, c in zip(starts, counts):
        lo = np.minimum(left, right)[s:s + c].sum()
        hi = np.maximum(left, right)[s:s + c].sum()
        thresholds.append(lo + rng.uniform(0.2, 0.45) * (hi - lo))
    return {"window_w": window_w, "window_h": window_h, "features": features.astype(np.int8),
            "weak_feature_idx": rng.integers(0, nfeat, nweaks).astype(np.uint16),
            "weak_left_val": left, "weak_right_val": right,
            "weak_subset_offset": (8 * np.arange(nweaks)).astype(np.uint16),
            "weak_num_subsets": np.full(nweaks, 8, np.uint16),
            "subsets": rng.integers(-2**31, 2**31, 8 * nweaks).astype(np.int32),
            "stage_weak_start": starts.astype(np.uint16), "stage_nweaks": counts.astype(np.uint16),
            "stage_threshold": np.array(thresholds, np.float32)}


@pytest.mark.parametrize("step,cap,shape", [(1, 100, (3, 96, 128)), (1, 5, (2, 97, 131)),
                                            (2, 100, (2, 97, 131)), (2, 5, (3, 96, 128))])
def test_port_equals_the_reference_on_the_frontal_face_cascade(step, cap, shape):
    batch = _pool(*shape)
    params = {**PARAMS, "step": step, "max_rects": cap}
    want = REF.reference(batch, params)
    assert want["n"].sum() > 0
    _assert_equal(_port(batch, gt.load_frontalface(), params), want)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_port_equals_the_reference_on_random_cascades(seed):
    arrays = _random_cascade(seed, *((24, 24), (18, 21), (24, 15))[seed % 3])
    cascade = lbp_cascade_from_arrays(arrays)
    noise = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (2, 61, 83),
                                                                  dtype=np.uint8))
    for batch in (_pool(2, 96, 129, seed), noise):
        for step in (1, 2):
            for cap in (5, 100):
                params = {**PARAMS, "step": step, "max_rects": cap}
                want = REF.detect(batch, arrays, params)
                _assert_equal(_port(batch, cascade, params), want)
        n, h, w = batch.shape
        windows = n * sum((h - wh + 1) * (w - ww + 1)
                          for _, ww, wh in REF.ladder(arrays["window_w"], arrays["window_h"],
                                                      h, w, PARAMS))
        passed = int(REF.detect(batch, arrays, {**PARAMS, "max_rects": windows})["n"].sum())
        assert 5 * n < passed < windows  # the cap of 5 binds; not every window passes


def test_the_reference_imports_nothing_of_either_package():
    code = ("import json, sys, torch; sys.path.insert(0, '.');"
            "from portbench import spec;"
            "ref = spec.reference('lbp_faces_vga');"
            "out = ref.reference(torch.zeros((1, 30, 40), dtype=torch.uint8),"
            " spec.config('lbp_faces_vga')['params']);"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.splitlines()[-1]))
    assert "portbench" in loaded and "torch" in loaded
    assert not {m for m in loaded if m.startswith(("grayskull", "jax", "flax"))}


def test_one_window_checked_by_hand():
    """A 3 x 3 window whose one feature's blocks are single pixels: the centre
    30 against TL 10, TC 50, TR 20, R 40, BR 31, BC 25, BL 30, L 5 gives
    code 0b01011010 = 90, bit 26 of subset word 2."""
    frame = torch.tensor([[[10, 50, 20], [5, 30, 40], [30, 25, 31]]], dtype=torch.uint8)
    arrays = {"window_w": 3, "window_h": 3, "features": np.array([[0, 0, 1, 1]], np.int8),
              "weak_feature_idx": np.array([0], np.uint16),
              "weak_left_val": np.array([0.5], np.float32),
              "weak_right_val": np.array([-0.5], np.float32),
              "weak_subset_offset": np.array([0], np.uint16),
              "weak_num_subsets": np.array([8], np.uint16),
              "subsets": np.array([0, 0, 1 << 26, 0, 0, 0, 0, 0], np.int32),
              "stage_weak_start": np.array([0], np.uint16),
              "stage_nweaks": np.array([1], np.uint16),
              "stage_threshold": np.array([0.25], np.float32)}
    params = {**PARAMS, "max_scale": 1.0, "max_rects": 2}
    want = {"n": torch.tensor([1], dtype=torch.int32),
            "rects": torch.tensor([[[0, 0, 3, 3], [0, 0, 0, 0]]], dtype=torch.int32)}
    _assert_equal(REF.detect(frame, arrays, params), want)
    _assert_equal(_port(frame, lbp_cascade_from_arrays(arrays), params), want)
    arrays["subsets"] = np.array([0, 0, 1 << 25, 0, 0, 0, 0, 0], np.int32)  # bit 26 clear: right
    assert int(REF.detect(frame, arrays, params)["n"][0]) == 0


def test_the_bfloat16_control_differs_from_the_reference():
    batch = _pool(4, 120, 160)
    want = REF.reference(batch, PARAMS)
    control = REF.reference(batch, PARAMS, control=True)
    differ = (want["rects"] != control["rects"]).flatten(1).any(1) | (want["n"] != control["n"])
    assert int(differ.sum()) >= 2
