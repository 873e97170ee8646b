"""The port's pyramid ORB and two-frame tracking against ``grayskull_tpu``'s, on the CPU.

``grayskull_tpu_torch.pipelines``' ``pyramid_levels``, ``extract_pyramid_orb``
and ``track`` are held, with tolerance 0 (angles by their bits), to the JAX
pipelines in the ``exact_host`` trig mode, where both packages call this
process's libm; ``tests/test_features.py`` holds the JAX side to the C chain.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import grayskull_tpu as gs
import grayskull_tpu_torch as gt
from grayskull_tpu import libm32 as jax_libm32
from grayskull_tpu_torch import libm32
from tests.test_torch_cuda import host_arrays_on_cpu  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "tests", "golden", "testdata")


@pytest.fixture(scope="module")
def aruco():
    return gt.io.read_pgm(os.path.join(TESTDATA, "aruco.pgm"))


@pytest.fixture(scope="module", autouse=True)
def exact_libm():
    jax_libm32.use_exact_host_libm(True)
    libm32.use_exact_host_libm(True)
    yield
    jax_libm32.use_exact_host_libm(False)
    libm32.use_exact_host_libm(False)


def _same(port, ref, msg=""):
    for name, a, b in zip(port._fields, port, ref):
        a = a.numpy()
        b = np.asarray(b)
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f"{msg} {name}")


@pytest.mark.parametrize("shape", [(480, 640), (250, 300), (63, 200), (64, 64), (31, 900)])
@pytest.mark.parametrize("n_levels", [1, 3, 4, 7])
def test_pyramid_levels_vs_jax(shape, n_levels):
    assert gt.pipelines.pyramid_levels(shape, n_levels) == gs.pipelines.pyramid_levels(shape,
                                                                                      n_levels)


@pytest.mark.parametrize("nkps,thr,nlv", [(2500, 20, 3), (90, 20, 3), (300, 10, 4)])
def test_extract_pyramid_orb_vs_jax(aruco, nkps, thr, nlv):
    got = gt.extract_pyramid_orb(aruco, nkps, thr, nlv)
    assert got.n.shape == () and got.x.shape == (nkps,) and got.descriptor.dtype == torch.uint32
    _same(got, gs.pipelines.extract_pyramid_orb(aruco, nkps, thr, nlv), f"{nkps} {thr} {nlv}")


def test_extract_pyramid_orb_batch_budgets_vs_jax(aruco):
    """Two frames whose levels fill differently: the last level's budget is per frame."""
    frames = np.stack([aruco[:240, :320], np.ascontiguousarray(aruco[240:, 320:][::-1])])
    got = gt.extract_pyramid_orb(frames, 200, 20)
    ref = gs.pipelines.extract_pyramid_orb(frames, 200, 20)
    _same(got, ref, "batch")
    for i in range(2):
        _same(gt.extract_pyramid_orb(frames[i], 200, 20), [v[i] for v in ref], f"frame {i}")


def test_track_aruco_vs_jax(aruco):
    """Config #4: the template of ``tests/test_features.py``'s track test and the scene."""
    tmpl = aruco[100:350, 150:450].copy()
    got = gt.track(tmpl, aruco)
    ref = gs.pipelines.track(tmpl, aruco)
    for what, a, b in zip(("template", "scene", "matches"), got, ref):
        _same(a, b, what)
    assert [int(got[0].n), int(got[1].n), int(got[2].n)] == [328, 1309, 300]


def test_track_same_shape_pair_vs_jax(aruco):
    """Same-shape frames run one batch-2 pyramid; each side equals its own pyramid."""
    scene = aruco[:240, :320].copy()
    tmpl = np.roll(scene, 7, axis=1)
    got = gt.track(tmpl, scene, max_kps=400)
    for what, a, b in zip(("template", "scene", "matches"), got,
                          gs.pipelines.track(tmpl, scene, max_kps=400)):
        _same(a, b, what)
    for table, frame in ((got[0], tmpl), (got[1], scene)):
        _same(table, gt.extract_pyramid_orb(frame, 400, 20), "vs one pyramid")
    pair = gt.track(tmpl, scene, max_kps=400, force_reference=True)
    for a, b in zip(got, pair):
        _same(a, b, "force_reference")


def test_bench_track_pair_vs_jax(aruco):
    """``benchmarks/bench_all.py``'s pair: aruco and aruco rolled 9 columns, one
    batch-2 ``orb_extract(500, 20)``, then ``match_orb(500, 64)``."""
    frames = np.stack([aruco, np.roll(aruco, 9, axis=1)])
    ks = gt.orb_extract(frames, 500, 20)
    ref = gs.ops.orb_extract(frames, 500, 20)
    _same(ks, ref, "pair tables")
    k1, k2 = (gt.Keypoints(*(v[i] for v in ks)) for i in (0, 1))
    r1, r2 = (type(ref)(*(v[i] for v in ref)) for i in (0, 1))
    m = gt.match_orb(k1, k2, 500, 64)
    _same(m, gs.ops.match_orb(r1, r2, 500, 64), "pair matches")
    assert 0 < int(m.n) < 500


def test_orb_runs_without_jax():
    code = "\n".join([
        "import sys",
        "import numpy as np",
        "import grayskull_tpu_torch as g",
        "img = np.random.default_rng(0).integers(0, 256, (96, 128), dtype=np.uint8)",
        "with g.core.host_arrays_to('cpu'):",
        "    tk, sk, m = g.track(img, np.roll(img, 3, axis=1), max_kps=200)",
        "assert int(tk.n) > 0 and int(m.n) > 0",
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'grayskull_tpu')]",
        "sys.exit(f'imported: {bad}' if bad else 0)",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
