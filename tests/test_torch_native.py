"""The port's native PGM loader (``grayskull_tpu_torch.native``, ctypes over
``csrc/gsio.c``) against ``grayskull_tpu.native`` and the port's Python codec,
on the cases of ``tests/test_native.py``: round trip, probe, batch, padding
larger and smaller than the frame, errors, malformed files, the whitespace
first-pixel quirk, and ``io.read_pgm_batch`` taking the native path.  Arrays
are compared exactly; where one path raises, the other raises the same type.
Skips only where there is no C compiler.
"""

import os
import shutil

import numpy as np
import pytest

from grayskull_tpu import native as jax_native
from grayskull_tpu_torch import io as tio
from grayskull_tpu_torch import native
from tests.test_torch_cuda import host_arrays_on_cpu  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def need_cc():
    if shutil.which("cc") is None:
        pytest.skip("no C compiler (cc) to build csrc/gsio.c")
    assert native.available() and jax_native.available()


def _python_batch(paths, pad_to=None, monkeypatch=None):
    """``io.read_pgm_batch`` through the Python codec (the native path switched off)."""
    monkeypatch.setattr(native, "available", lambda: False)
    try:
        return tio.read_pgm_batch(paths, pad_to=pad_to)
    finally:
        monkeypatch.undo()


def _outcome(fn, *args, **kw):
    """An array, or the type of the exception ``fn`` raised."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e)


def _same_outcome(a, b):
    if isinstance(a, type) or isinstance(b, type):
        assert a is b, (a, b)
    else:
        np.testing.assert_array_equal(a, b)


def test_library_is_the_ports_own():
    path = native.library_path()
    assert path is not None and os.path.isfile(path)
    build = os.path.join(os.path.dirname(os.path.abspath(native.__file__)), "_build")
    assert os.path.dirname(path) == build
    assert os.path.basename(path).startswith("libgsio_")


def test_roundtrip(tmp_path):
    img = np.random.default_rng(1234).integers(0, 256, (37, 53), dtype=np.uint8)
    p = str(tmp_path / "x.pgm")
    assert native.write_pgm(img, p) == 0
    np.testing.assert_array_equal(native.read_pgm(p), img)
    np.testing.assert_array_equal(jax_native.read_pgm(p), img)
    np.testing.assert_array_equal(tio.read_pgm(p), img)
    q = str(tmp_path / "y.pgm")
    assert jax_native.write_pgm(img, q) == 0
    assert open(p, "rb").read() == open(q, "rb").read()


def test_probe(tmp_path):
    img = np.random.default_rng(1234).integers(0, 256, (10, 20), dtype=np.uint8)
    p = str(tmp_path / "x.pgm")
    native.write_pgm(img, p)
    assert native.probe_pgm(p) == jax_native.probe_pgm(p) == (20, 10)
    missing = str(tmp_path / "missing.pgm")
    assert native.probe_pgm(missing) is None and jax_native.probe_pgm(missing) is None


def test_reads_the_test_images():
    tdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "testdata")
    for fn in sorted(os.listdir(tdir)):
        if fn.endswith(".pgm"):
            p = os.path.join(tdir, fn)
            np.testing.assert_array_equal(native.read_pgm(p), tio.read_pgm(p), err_msg=fn)
            np.testing.assert_array_equal(native.read_pgm(p), jax_native.read_pgm(p), err_msg=fn)


def test_batch_loader(tmp_path, monkeypatch):
    rng = np.random.default_rng(1234)
    paths, frames = [], []
    for i in range(20):
        img = rng.integers(0, 256, (24, 32), dtype=np.uint8)
        img[0, 0] = 200  # a first pixel that is not whitespace (test_whitespace_first_pixel_quirk)
        p = str(tmp_path / f"f{i}.pgm")
        native.write_pgm(img, p)
        paths.append(p)
        frames.append(img)
    batch = native.read_pgm_batch(paths, threads=4)
    assert batch.shape == (20, 24, 32) and batch.dtype == np.uint8
    np.testing.assert_array_equal(batch, np.stack(frames))
    np.testing.assert_array_equal(batch, jax_native.read_pgm_batch(paths, threads=4))
    np.testing.assert_array_equal(batch, _python_batch(paths, monkeypatch=monkeypatch))
    empty = native.read_pgm_batch([])
    assert empty.shape == (0, 0, 0) and jax_native.read_pgm_batch([]).shape == (0, 0, 0)


@pytest.mark.parametrize("pad_to", [(16, 16), (5, 7), (8, 20), (3, 12)])
def test_batch_loader_padding(tmp_path, monkeypatch, pad_to):
    """Padding larger and smaller than the 8x12 frame, and one of each."""
    img = np.random.default_rng(1234).integers(0, 256, (8, 12), dtype=np.uint8)
    img[0, 0] = 90
    p = str(tmp_path / "a.pgm")
    native.write_pgm(img, p)
    batch = native.read_pgm_batch([p, p], pad_to=pad_to)
    want = np.zeros((2, *pad_to), np.uint8)
    hh, ww = min(8, pad_to[0]), min(12, pad_to[1])
    want[:, :hh, :ww] = img[:hh, :ww]
    np.testing.assert_array_equal(batch, want)
    np.testing.assert_array_equal(batch, jax_native.read_pgm_batch([p, p], pad_to=pad_to))
    np.testing.assert_array_equal(batch, _python_batch([p, p], pad_to, monkeypatch))


def _bad_files(tmp_path):
    """name -> path: a missing file, 16-bit maxval, a short payload, a bad magic."""
    files = {"missing": str(tmp_path / "nope.pgm")}
    for name, data in (("maxval", b"P5\n4 4\n65535\n" + b"\x01" * 32),
                       ("short", b"P5\n4 4\n255\n" + b"\x01" * 3),
                       ("magic", b"P6\n4 4\n255\n" + b"\x01" * 48)):
        files[name] = str(tmp_path / f"{name}.pgm")
        open(files[name], "wb").write(data)
    return files


def test_errors_and_malformed_files(tmp_path, monkeypatch):
    """Each bad file alone and beside a good one, with and without pad_to:
    both paths raise the same type (IOError); a single read gives None."""
    good = str(tmp_path / "good.pgm")
    native.write_pgm(np.full((4, 4), 60, np.uint8), good)
    for name, p in _bad_files(tmp_path).items():
        assert native.read_pgm(p) is None and jax_native.read_pgm(p) is None, name
        assert tio.read_pgm(p) is None, name
        for paths in ([p], [good, p]):
            for pad_to in (None, (8, 8)):
                got = _outcome(native.read_pgm_batch, paths, pad_to=pad_to)
                _same_outcome(got, _outcome(jax_native.read_pgm_batch, paths, pad_to=pad_to))
                _same_outcome(got, _outcome(_python_batch, paths, pad_to, monkeypatch))
                assert got is OSError, (name, paths, pad_to)


def test_inconsistent_sizes_without_pad_to(tmp_path, monkeypatch):
    a, b = str(tmp_path / "a.pgm"), str(tmp_path / "b.pgm")
    native.write_pgm(np.full((4, 6), 70, np.uint8), a)
    native.write_pgm(np.full((6, 4), 70, np.uint8), b)
    got = _outcome(native.read_pgm_batch, [a, b])
    assert got is ValueError
    _same_outcome(got, _outcome(jax_native.read_pgm_batch, [a, b]))
    _same_outcome(got, _outcome(_python_batch, [a, b], None, monkeypatch))
    both = native.read_pgm_batch([a, b], pad_to=(6, 6))  # padded, they stack
    np.testing.assert_array_equal(both, _python_batch([a, b], (6, 6), monkeypatch))


def test_whitespace_first_pixel_quirk(tmp_path, monkeypatch):
    """``tests/test_native.py``'s quirk without the C oracle: the header's
    trailing whitespace directive eats a whitespace-valued first pixel, so
    every reader fails on such a file, as the reference does; a
    non-whitespace first pixel round-trips everywhere."""
    img = np.full((4, 5), 7, np.uint8)
    p = str(tmp_path / "ws.pgm")
    for first in (0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20):
        img[0, 0] = first
        assert native.write_pgm(img, p) == 0
        assert native.read_pgm(p) is None and jax_native.read_pgm(p) is None
        assert tio.read_pgm(p) is None
        got = _outcome(native.read_pgm_batch, [p])
        assert got is OSError
        _same_outcome(got, _outcome(jax_native.read_pgm_batch, [p]))
        _same_outcome(got, _outcome(_python_batch, [p], None, monkeypatch))
    img[0, 0] = 200
    assert native.write_pgm(img, p) == 0
    np.testing.assert_array_equal(native.read_pgm(p), img)
    np.testing.assert_array_equal(tio.read_pgm(p), img)
    np.testing.assert_array_equal(native.read_pgm_batch([p]), img[None])


def test_io_module_uses_native_batch(tmp_path, monkeypatch):
    img = np.random.default_rng(1234).integers(0, 256, (6, 6), dtype=np.uint8)
    img[0, 0] = 100
    p = str(tmp_path / "z.pgm")
    tio.write_pgm(img, p)
    calls = []
    real = native.read_pgm_batch

    def spy(paths, pad_to=None, threads=8):
        calls.append(list(paths))
        return real(paths, pad_to=pad_to, threads=threads)

    monkeypatch.setattr(native, "read_pgm_batch", spy)
    batch = tio.read_pgm_batch([p, p])
    assert calls == [[p, p]]
    assert batch.shape == (2, 6, 6)
    np.testing.assert_array_equal(batch, np.stack([img, img]))
