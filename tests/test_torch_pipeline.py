"""The port's preprocess slice against ``grayskull_tpu``'s, on the CPU.

``grayskull_tpu_torch.preprocess`` (blur -> Otsu -> threshold -> Sobel) is held,
with tolerance 0, to the JAX ``preprocess``, to the JAX fused Pallas pair in
interpret mode, and on the five testdata PGMs.  Also checked here: the port
imports no JAX, and its PGM codec matches ``grayskull_tpu.io``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import grayskull_tpu.io as jio
import grayskull_tpu_torch as gt
import grayskull_tpu_torch.io as tio
from grayskull_tpu.pipelines.preproc import _preprocess_pallas
from grayskull_tpu.pipelines.preproc import preprocess as jax_preprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "tests", "golden", "testdata")
PGMS = sorted(f[:-4] for f in os.listdir(TESTDATA) if f.endswith(".pgm"))
NAMES = ("blurred", "binary", "edges", "thresholds")


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _same(port, ref, msg=""):
    assert len(port) == len(ref) == 4
    for name, a, b in zip(NAMES, port, ref):
        if b is None:
            assert a is None, f"{msg} {name}"
            continue
        assert isinstance(a, torch.Tensor) and a.dtype == torch.uint8, f"{msg} {name}"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{msg} {name}")


@pytest.mark.parametrize("radius", [2, 6])
def test_preprocess_matches_jax_and_fused_pallas(radius):
    imgs = _frames((2, 24, 128), 20)
    got = gt.preprocess(imgs, radius)
    _same(got, jax_preprocess(imgs, radius), "vs preprocess")
    _same(got, _preprocess_pallas(imgs, radius, interpret=True), "vs fused pallas")


@pytest.mark.parametrize("name", PGMS)
def test_preprocess_testdata(name):
    img = tio.read_pgm(os.path.join(TESTDATA, name + ".pgm"))
    got = gt.preprocess(img)
    assert got[0].shape == img.shape and got[3].ndim == 0
    _same(got, jax_preprocess(img), name)


def test_preprocess_batched_and_odd_shapes():
    imgs = _frames((3, 37, 53), 21)
    out = gt.preprocess(imgs, 3)
    _same(out, jax_preprocess(imgs, 3), "batch")
    for i in range(3):
        _same(gt.preprocess(imgs[i], 3), [None if v is None else v[i] for v in out], f"frame {i}")
    tiny = _frames((2, 2, 9), 22)  # too small for any interior: edges all 0
    out = gt.preprocess(tiny)
    _same(out, jax_preprocess(tiny), "tiny")
    assert not out[2].any()


def test_want_binary_false_and_force_reference():
    imgs = _frames((2, 40, 60), 23)
    full = gt.preprocess(imgs)
    lean = gt.preprocess(imgs, want_binary=False)
    assert lean[1] is None
    _same(lean, (full[0], None, full[2], full[3]), "want_binary=False")
    _same(gt.preprocess(imgs, force_reference=True), full, "force_reference")
    ref_lean = gt.preprocess(imgs, force_reference=True, want_binary=False)
    _same(ref_lean, (full[0], None, full[2], full[3]), "reference want_binary=False")
    single = gt.preprocess_reference(imgs[0])
    _same(single, [v[0] for v in full], "reference single")


def test_import_leaves_jax_out():
    code = "\n".join([
        "import sys",
        "import numpy as np",
        "import grayskull_tpu_torch as g",
        "g.preprocess(np.zeros((8, 8), np.uint8))",
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'grayskull_tpu')]",
        "sys.exit(f'imported: {bad}' if bad else 0)",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    from grayskull_tpu_torch.profiling import timeit

    with pytest.raises(RuntimeError):
        timeit(lambda: None)


@pytest.mark.parametrize("name", PGMS)
def test_io_matches_jax_io(name, tmp_path):
    path = os.path.join(TESTDATA, name + ".pgm")
    with open(path, "rb") as f:
        buf = f.read()
    img = tio.decode_pgm(buf)
    np.testing.assert_array_equal(img, jio.decode_pgm(buf))
    assert tio.encode_pgm(img) == jio.encode_pgm(img)
    out = str(tmp_path / "out.pgm")
    assert tio.write_pgm(img, out) == 0
    np.testing.assert_array_equal(tio.read_pgm(out), img)


def test_io_edge_cases(tmp_path):
    for buf in (b"P5 3 2 255\n\x00\x01\x02\x03\x04\x05", b"P53 2\n255 \x01\x02\x03\x04\x05\x06",
                b"P5\n3 2\n255\n\x0a\x01\x02\x03\x04\x05\x06", b"P5\n3 2\n16\n123456",
                b"P2\n3 2\n255\n123456", b"P5\n3 2\n255\n12345", b"P5\n# c\n3 2\n255\n123456"):
        got, ref = tio.decode_pgm(buf), jio.decode_pgm(buf)
        assert (got is None) == (ref is None), buf
        if got is not None:
            np.testing.assert_array_equal(got, ref)
    assert tio.read_pgm(str(tmp_path / "missing.pgm")) is None
    assert tio.write_pgm(np.zeros((2, 2), np.int32), str(tmp_path / "x.pgm")) == -1
    a, b = _frames((5, 7), 24), _frames((4, 9), 25)
    paths = [str(tmp_path / "a.pgm"), str(tmp_path / "b.pgm")]
    tio.write_pgm(a, paths[0])
    tio.write_pgm(b, paths[1])
    batch = tio.read_pgm_batch(paths, pad_to=(6, 8))
    assert batch.shape == (2, 6, 8)
    np.testing.assert_array_equal(batch[0, :5, :7], a)
    np.testing.assert_array_equal(batch[1, :4, :8], b[:, :8])
    with pytest.raises(ValueError):
        tio.read_pgm_batch(paths)
