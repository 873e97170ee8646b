"""The port's faces slice against ``grayskull_tpu``'s, on the CPU.

``grayskull_tpu_torch``'s cascade loaders, ``integral``, ``integral_sum``,
``scale_ladder``, ``lbp_window``, ``lbp_detect`` and ``detect_faces`` are held,
with tolerance 0 (every output is an integer or a bool), to the JAX functions
on the same inputs, and to the goldens ``integral`` and ``lbp_rects*``.  The
goldens' LBP tables are empty, so the detections that count come from
``lena.pgm``, which detects 20 windows at step 1 and 7 at step 2.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import grayskull_tpu as gs
import grayskull_tpu_torch as gt
from grayskull_tpu.cascade import load_frontalface as jax_load_frontalface
from grayskull_tpu.cascade import load_opencv_xml as jax_load_opencv_xml
from grayskull_tpu.kernels.integral import integral_pallas
from grayskull_tpu.ops.integral import integral_sum as jax_integral_sum
from grayskull_tpu.ops.lbp import lbp_detect as jax_lbp_detect
from grayskull_tpu.ops.lbp import lbp_window as jax_lbp_window
from grayskull_tpu.ops.lbp import scale_ladder as jax_scale_ladder
from grayskull_tpu.pipelines.faces import detect_faces as jax_detect_faces
from grayskull_tpu_torch import kernels as K
from grayskull_tpu_torch.core import host_arrays_to, lbp_cascade_from_arrays
from tests.test_torch_cuda import host_arrays_on_cpu  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "tests", "golden", "testdata")
CASCADE_FIELDS = ("features", "weak_feature_idx", "weak_left_val", "weak_right_val",
                  "weak_subset_offset", "weak_num_subsets", "subsets", "stage_weak_start",
                  "stage_nweaks", "stage_threshold")

TINY_XML = """<?xml version="1.0"?>
<opencv_storage>
<cascade>
  <stageType>BOOST</stageType>
  <featureType>LBP</featureType>
  <height>8</height>
  <width>8</width>
  <stages>
    <_>
      <maxWeakCount>2</maxWeakCount>
      <stageThreshold>-0.5</stageThreshold>
      <weakClassifiers>
        <_>
          <internalNodes>0 -1 1 -67130709 -21569 -1426120013 -1275125205 -21585 -16385 587145899 -24005</internalNodes>
          <leafValues>-0.6 0.7</leafValues>
        </_>
        <_>
          <internalNodes>0 -1 0 1 2 3 4 5 6 7 8</internalNodes>
          <leafValues>0.25 -0.25</leafValues>
        </_>
      </weakClassifiers>
    </_>
  </stages>
  <features>
    <_><rect>0 0 2 2</rect></_>
    <_><rect>1 1 2 2</rect></_>
  </features>
</cascade>
</opencv_storage>"""


@pytest.fixture(scope="module")
def lena():
    return gt.io.read_pgm(os.path.join(TESTDATA, "lena.pgm"))


@pytest.fixture(scope="module")
def goldens():
    return np.load(os.path.join(REPO, "tests", "golden", "goldens.npz"))


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _same_cascade(port, jax_cascade):
    assert (port.window_w, port.window_h) == (jax_cascade.window_w, jax_cascade.window_h)
    for name in CASCADE_FIELDS:
        a, b = getattr(port, name), np.asarray(getattr(jax_cascade, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=name)


def _same_rects(port, ref, msg=""):
    assert isinstance(port, gt.Rects)
    for name, a, b in zip(port._fields, port, ref):
        assert a.dtype == torch.int32, f"{msg} {name}"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{msg} {name}")


def _rows(r):
    n = int(r.n)
    return np.stack([v[:n].numpy() for v in (r.x, r.y, r.w, r.h)], axis=1)


def test_frontalface_matches_jax():
    port = gt.load_frontalface()
    assert port is gt.load_frontalface()  # memoized: the device-table caches key on identity
    _same_cascade(port, jax_load_frontalface())
    _same_cascade(lbp_cascade_from_arrays(jax_load_frontalface()), jax_load_frontalface())
    copy = lbp_cascade_from_arrays(port)
    assert copy != port and copy == copy and hash(copy) == hash(port)


def test_opencv_xml_loader_matches_jax(tmp_path):
    path = tmp_path / "tiny.xml"
    path.write_text(TINY_XML)
    port = gt.load_opencv_xml(str(path))
    _same_cascade(port, jax_load_opencv_xml(str(path)))
    assert port.nweaks == 2 and port.nstages == 1 and port.nfeatures == 2
    assert port.subsets[:2].tolist() == [-67130709, -21569]
    bad = tmp_path / "haar.xml"
    bad.write_text(TINY_XML.replace("<featureType>LBP", "<featureType>HAAR"))
    with pytest.raises(ValueError):
        gt.load_opencv_xml(str(bad))


@pytest.mark.parametrize("shape", [(7, 8), (2, 97, 200), (37, 130), (1, 60, 2049)])
def test_integral_vs_jax(shape):
    img = _frames(shape, 30)
    got = gt.integral(img)
    assert got.dtype == torch.uint32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(gs.integral(img, force_xla=True)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(integral_pallas(img, interpret=True)))


def test_integral_wraps_uint32():
    img = np.full((4200, 4200), 255, np.uint8)  # 255 * 4200^2 = 4.4982e9 > 2^32
    got = gt.integral(img).numpy()
    assert int(got[-1, -1]) == (255 * 4200 * 4200) % 2**32
    np.testing.assert_array_equal(got, np.asarray(gs.integral(img, force_xla=True)))
    np.testing.assert_array_equal(got, np.asarray(integral_pallas(img, interpret=True)))


def _integral_constants():
    """K4's band height, pixels a thread and block cap, from ``csrc/integral.cu``."""
    with open(os.path.join(REPO, "grayskull_tpu_torch", "csrc", "integral.cu")) as f:
        src = f.read()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                 for name in ("kBand", "kPix", "kMaxThreads"))


def _u32_cumsum(a, axis):
    return np.cumsum(a, axis=axis, dtype=np.uint32)


def _integral_replay(imgs, band, pix, max_threads):
    """``csrc/integral.cu``'s K4 in numpy, uint32 with wraparound: (1) each band
    but the last sums its columns, bytes packed as 16-bit pairs of each 4-byte
    word, into its first output row; (2) a walk down the bands turns those rows
    into the column sums above each band; (3) each band's block takes chunks of
    ``threads * pix`` columns: a thread's running column sums from the carry,
    its row totals, the warp's inclusive scan of them, the warps before it
    (their totals through shared memory) and the row's carry from earlier
    chunks, then the thread's own running sum over its ``pix`` columns."""
    n, h, w = imgs.shape
    nb = -(-h // band)
    cols = -(-w // pix)
    threads = max_threads if cols >= max_threads else -(-cols // 32) * 32
    chunk, warps = threads * pix, threads // 32
    out = np.zeros((n, h, w), np.uint32)
    for b in range(nb - 1):  # (1) band totals, a whole band each
        rows = np.zeros((n, band, -(-w // 4) * 4), np.uint8)
        rows[..., :w] = imgs[:, b * band:(b + 1) * band]
        words = rows.view("<u4")
        even = (words & 0x00FF00FF).sum(1, dtype=np.uint32)
        odd = ((words >> 8) & 0x00FF00FF).sum(1, dtype=np.uint32)
        t = np.stack([even & 0xFFFF, odd & 0xFFFF, even >> 16, odd >> 16], -1).reshape(n, -1)
        out[:, b * band] = t[:, :w]
    run = np.zeros((n, w), np.uint32)
    for b in range(nb):  # (2) the carries, in place
        t = out[:, b * band].copy() if b < nb - 1 else 0
        if b > 0:
            out[:, b * band] = run
        run = run + t
    for b in range(nb):  # (3) the band scan
        y0 = b * band
        rows = min(band, h - y0)
        carry = out[:, y0].copy() if b > 0 else np.zeros((n, w), np.uint32)
        row_carry = np.zeros((n, rows), np.uint32)
        for x0 in range(0, w, chunk):
            live = min(chunk, w - x0)
            raw = np.zeros((n, rows, chunk), np.uint32)
            raw[..., :live] = imgs[:, y0:y0 + rows, x0:x0 + live]
            c = np.zeros((n, chunk), np.uint32)
            c[:, :live] = carry[:, x0:x0 + live]
            col = c[:, None] + _u32_cumsum(raw, 1)  # (n, rows, chunk): running column sums
            col = col.reshape(n, rows, warps, 32, pix)
            t = col.sum(-1, dtype=np.uint32)  # a thread's row totals
            v = _u32_cumsum(t, -1)  # the warp's inclusive scan
            warp_total = v[..., 31]
            earlier = _u32_cumsum(warp_total, -1) - warp_total
            start = (v - t) + earlier[..., None] + row_carry[:, :, None, None]
            res = start[..., None] + _u32_cumsum(col, -1)
            out[:, y0:y0 + rows, x0:x0 + live] = res.reshape(n, rows, chunk)[..., :live]
            row_carry = row_carry + warp_total.sum(-1, dtype=np.uint32)
    return out


@pytest.mark.parametrize("config", ["committed", "small"])
@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 1, 40), (1, 40, 1), (2, 33, 129), (2, 97, 200),
                                   (1, 65, 2050), (2, 64, 17), (1, 31, 5)])
def test_integral_band_replay_vs_plain_and_jax(config, shape):
    """K4's band totals, carries and in-band scans, replayed at the committed
    constants and at bands of 4 rows in blocks of 64 threads (many bands and
    chunks at these sizes), equal ``integral_plain`` and the Pallas kernel in
    interpret mode: heights and widths of 1, heights no multiple of a band,
    widths no multiple of 4 or 16, and past one block's chunk."""
    band, pix, max_threads = _integral_constants() if config == "committed" else (4, 4, 64)
    imgs = _frames(shape, 31)
    got = _integral_replay(imgs, band, pix, max_threads)
    np.testing.assert_array_equal(got, K.integral_plain(torch.from_numpy(imgs)).numpy())
    np.testing.assert_array_equal(got, np.asarray(integral_pallas(imgs, interpret=True)))


def test_integral_band_replay_wraps_uint32():
    """The replay on 4200 x 4200 255s (the sums pass 2^32 from row 1,008 on)."""
    imgs = np.full((1, 4200, 4200), 255, np.uint8)
    got = _integral_replay(imgs, *_integral_constants())
    assert int(got[0, -1, -1]) == (255 * 4200 * 4200) % 2**32
    np.testing.assert_array_equal(got, K.integral_plain(torch.from_numpy(imgs)).numpy())
    np.testing.assert_array_equal(got, np.asarray(integral_pallas(imgs, interpret=True)))


def test_integral_golden(goldens):
    np.testing.assert_array_equal(gt.integral(goldens["input"]).numpy(), goldens["integral"])


def test_integral_sum_vs_jax():
    img = _frames((2, 40, 50), 31)
    ii_port = gt.integral(img)
    ii_jax = gs.integral(img)
    rng = np.random.default_rng(32)
    x, y = rng.integers(0, 45, 64), rng.integers(0, 35, 64)
    w, h = rng.integers(1, 6, 64), rng.integers(1, 6, 64)
    x[:4], y[:4] = 0, [0, 3, 0, 9]  # the edge guards
    got = gt.integral_sum(ii_port, torch.from_numpy(x), torch.from_numpy(y),
                          torch.from_numpy(w), torch.from_numpy(h))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_integral_sum(ii_jax, x, y, w, h)))
    scalar = gt.integral_sum(ii_port[0], 3, 0, 7, 5)
    assert int(scalar.view(torch.int32)) == int(jax_integral_sum(ii_jax[0], 3, 0, 7, 5))


@pytest.mark.parametrize("geometry", [(640, 480), (128, 128), (23, 100), (320, 240)])
def test_scale_ladder_float_semantics(geometry):
    iw, ih = geometry
    cascade = gt.load_frontalface()
    ladder = gt.scale_ladder(cascade, iw, ih, 1.2, 1.0, 4.0)
    assert ladder == jax_scale_ladder(jax_load_frontalface(), iw, ih, 1.2, 1.0, 4.0)
    f = np.float32
    expect = []
    s = f(1.0)
    while s <= f(4.0):  # f32 multiplies: 1.2 is inexact, so doubles give another ladder
        if int(f(24) * s) > iw or int(f(24) * s) > ih:
            break
        expect.append(float(s))
        s = f(s * f(1.2))
    assert [scale for scale, _, _ in ladder] == expect


def test_lbp_window_vs_jax(lena):
    cascade, jc = gt.load_frontalface(), jax_load_frontalface()
    ii = gt.integral(lena)
    ii_jax = np.asarray(gs.integral(lena))
    for scale, win_w, win_h in gt.scale_ladder(cascade, 128, 128, 1.2, 1.0, 4.0)[:2]:
        for x, y in [(0, 0), (10, 20), (50, 50), (128 - win_w, 128 - win_h)]:
            got = gt.lbp_window(cascade, ii, x, y, scale)
            assert got.dtype == torch.bool and got.ndim == 0
            assert bool(got) == bool(jax_lbp_window(jc, ii_jax, x, y, scale)), (scale, x, y)
    assert not bool(gt.lbp_window(cascade, ii, 120, 0, 1.0))  # does not fit
    with pytest.raises(ValueError):
        gt.lbp_window(cascade, ii, -1, 0, 1.0)


@pytest.mark.parametrize("step,expected", [(1, 20), (2, 7)])
def test_lbp_detect_lena_vs_jax(lena, step, expected):
    ii = gt.integral(lena)
    got = gt.lbp_detect(gt.load_frontalface(), ii, 100, 1.2, 1.0, 4.0, step)
    assert int(got.n) == expected and got.x.shape == (100,)
    _same_rects(got, jax_lbp_detect(jax_load_frontalface(), np.asarray(ii), 100, 1.2, 1.0, 4.0,
                                    step), f"step {step}")
    _same_rects(gt.detect_faces(lena, step=step), jax_detect_faces(lena, step=step),
                f"detect_faces step {step}")


def test_lbp_detect_max_rects_truncation(lena):
    got = gt.detect_faces(lena, max_rects=5)
    assert int(got.n) == 5
    _same_rects(got, jax_detect_faces(lena, max_rects=5), "max_rects 5")
    full = gt.detect_faces(lena)
    np.testing.assert_array_equal(_rows(got), _rows(full)[:5])  # the first 5 in ladder order


def test_detect_faces_batch_vs_jax(lena):
    frames = np.stack([lena, np.ascontiguousarray(lena[:, ::-1])])
    got = gt.detect_faces(frames, step=2)
    assert got.n.shape == (2,) and got.x.shape == (2, 100)
    _same_rects(got, jax_detect_faces(frames, step=2), "batch")
    for i in range(2):
        _same_rects(gt.detect_faces(frames[i], step=2), [v[i] for v in got], f"frame {i}")
    _same_rects(gt.detect_faces(frames, step=2, force_reference=True), got, "force_reference")


def test_empty_ladder_vs_jax():
    frames = _frames((2, 16, 30), 33)  # smaller than the 24x24 window
    got = gt.detect_faces(frames, max_rects=7)
    assert got.x.shape == (2, 7) and not any(v.any() for v in got)
    _same_rects(got, jax_detect_faces(frames, max_rects=7), "empty ladder")
    single = gt.detect_faces(frames[0], max_rects=7)
    assert single.n.shape == () and single.x.shape == (7,)
    assert gt.lbp_warm_start(gt.load_frontalface(), 16, 16) >= 0.0


@pytest.mark.parametrize("step", [1, 2, 3])
def test_lbp_goldens(goldens, step):
    key = "lbp_rects" if step == 1 else f"lbp_rects_step{step}"
    ii = gt.integral(goldens["lbp_input"])
    got = gt.lbp_detect(gt.load_frontalface(), ii, 50, 1.2, 1.0, 4.0, step)
    np.testing.assert_array_equal(_rows(got), goldens[key].astype(np.int64).reshape(-1, 4))


def test_lbp_detect_inputs(lena):
    cascade = gt.load_frontalface()
    ii = gt.integral(lena)
    from_numpy = gt.lbp_detect(cascade, ii.numpy(), 100, step=3)
    _same_rects(from_numpy, gt.lbp_detect(cascade, ii, 100, step=3), "numpy integral")
    with pytest.raises(TypeError):
        gt.lbp_detect(cascade, ii.numpy().astype(np.int64), 100)
    with pytest.raises(ValueError):
        gt.lbp_detect(cascade, ii, 100, step=0)
    assert gt.pipelines.warm_start(128, 128) >= 0.0


def test_warm_start_needs_a_card_or_the_cpu(monkeypatch):
    """Outside ``host_arrays_to("cpu")`` the warm start prepares the CUDA
    device; with none it raises rather than warm the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cascade = gt.load_frontalface()
    with host_arrays_to(None):
        with pytest.raises(RuntimeError, match="host_arrays_to"):
            gt.lbp_warm_start(cascade, 32, 32)
        with pytest.raises(RuntimeError, match="host_arrays_to"):
            gt.pipelines.warm_start(32, 32)
    assert gt.lbp_warm_start(cascade, 32, 32) >= 0.0  # the tests' fixture asks for the CPU
    assert gt.pipelines.warm_start(32, 32, batch=2) >= 0.0


def test_faces_import_leaves_jax_out():
    code = "\n".join([
        "import sys",
        "import numpy as np",
        "import grayskull_tpu_torch as g",
        "with g.core.host_arrays_to('cpu'):",
        "    r = g.detect_faces(np.zeros((30, 40), np.uint8), step=4)",
        "assert int(r.n) == 0",
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'grayskull_tpu')]",
        "sys.exit(f'imported: {bad}' if bad else 0)",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
