"""The port's quad warp and document scanner against ``grayskull_tpu``'s, on the CPU.

K10's plain version (through ``perspective_correct``), ``preprocess_binarize``
and ``scan`` are held, with tolerance 0 (every output is an integer), to the
JAX functions on the same inputs: random frames made with numpy from a seed,
``document.pgm`` and the golden ``persp``, and once to the JAX Pallas band
sampler in interpret mode.  K10's committed CUDA design (``csrc/warp.cu``:
shared column and row terms, the float tricks in place of type conversions,
the tile walk and the head and tail bytes of its stores) is replayed in numpy
float32 and held to the same.  Also the repair of host arrays: with no card
and no request for the CPU, a numpy input raises.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grayskull_tpu as gs
import grayskull_tpu_torch as gt
from grayskull_tpu.ops.warp import _warp_batched_tpu
from grayskull_tpu.pipelines.scan import preprocess_binarize as jax_preprocess_binarize
from grayskull_tpu.pipelines.scan import scan as jax_scan
from grayskull_tpu_torch import kernels as K
from grayskull_tpu_torch.core import host_arrays_to
from grayskull_tpu_torch.kernels import _build
from tests.test_torch_cuda import host_arrays_on_cpu  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "tests", "golden", "testdata")
# tests/test_integral_template_warp.py:193-197: mild, steep and extreme quads on document.pgm
DOC_QUADS = {
    "mild": [[50, 40], [700, 60], [690, 1000], [40, 980]],
    "steep": [[0, 400], [760, 0], [767, 600], [10, 1010]],
    "extreme": [[10, 700], [1000, 10], [1020, 760], [3, 10]],
    "outside": [[-60, -45], [900, -10], [820, 1200], [-30, 1100]],
}


@pytest.fixture(scope="module")
def document():
    return gt.io.read_pgm(os.path.join(TESTDATA, "document.pgm"))


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _eq(port, ref, msg=""):
    assert isinstance(port, torch.Tensor) and port.device.type == "cpu", msg
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref), err_msg=msg)


def test_perspective_identity_quad():
    img = _rand((20, 30), 1)
    c = np.array([(0, 0), (29, 0), (29, 19), (0, 19)], np.int32)
    _eq(gt.perspective_correct(img, c, (20, 30)), gs.perspective_correct(img, c, (20, 30)))


@pytest.mark.parametrize("trial", range(5))
def test_perspective_random_quads(trial):
    """``tests/test_integral_template_warp.py:108-117``'s cases, corners also outside the frame."""
    rng = np.random.default_rng(100 + trial)
    img = _rand((48, 64), trial)
    size = (int(rng.integers(4, 100)), int(rng.integers(4, 100)))
    for lo, hi in ((0, 64), (-40, 110)):
        c = np.stack([rng.integers(lo, hi, 4), rng.integers(lo * 3 // 4, hi * 3 // 4, 4)],
                     axis=1).astype(np.int32)
        _eq(gt.perspective_correct(img, c, size), gs.perspective_correct(img, c, size), str(c))


def test_perspective_one_row_or_column():
    """0/0 in the grid: the JAX package's page is src[0, 0] everywhere (its
    integer float adder turns the NaN into -inf, which clamps to 0)."""
    img = _rand((48, 64), 7)
    c = np.array([[3, 4], [50, 6], [40, 30], [5, 40]], np.int32)
    for size in ((1, 1), (1, 10), (10, 1)):
        with np.errstate(invalid="ignore"):
            want = gs.perspective_correct(img, c, size)
        _eq(gt.perspective_correct(img, c, size), want, str(size))
        assert (np.asarray(want) == img[0, 0]).all()


def test_perspective_golden():
    g = np.load(os.path.join(REPO, "tests", "golden", "goldens.npz"))
    _eq(gt.perspective_correct(g["input"], g["persp_corners"].astype(np.int32), (50, 70)),
        g["persp"])


def test_perspective_document_quads(document):
    for name, q in DOC_QUADS.items():
        c = np.array(q, np.int32)
        _eq(gt.perspective_correct(document, c, (1000, 800)),
            gs.perspective_correct(document, c, (1000, 800)), name)


def test_perspective_batched(document):
    frames = np.stack([document, document[::-1].copy()])
    quads = np.array([DOC_QUADS["mild"], DOC_QUADS["outside"]], np.int32)
    got = gt.perspective_correct(frames, quads, (97, 61))
    for i in range(2):
        assert torch.equal(got[i], gt.perspective_correct(frames[i], quads[i], (97, 61)))
    shared = gt.perspective_correct(frames, quads[0], (97, 61))
    assert torch.equal(shared[0], got[0])
    assert torch.equal(shared[1], gt.perspective_correct(frames[1], quads[0], (97, 61)))
    with pytest.raises(TypeError):
        gt.perspective_correct(frames[0], quads[0].astype(np.float32), (4, 4))
    with pytest.raises(ValueError):
        gt.perspective_correct(frames[0], quads, (4, 4))
    with pytest.raises(ValueError):
        K.quad_warp(torch.from_numpy(frames), torch.from_numpy(quads), (0, 4))


def test_quad_warp_matches_pallas_band_sampler(document):
    """The odd-height (347, 200) page of ``tests/test_integral_template_warp.py:120-138``
    against ``_warp_batched_tpu`` in interpret mode."""
    h, w = document.shape
    c = np.array([(int(w * 0.1), int(h * 0.15)), (int(w * 0.9), int(h * 0.1)),
                  (int(w * 0.85), int(h * 0.9)), (int(w * 0.12), int(h * 0.88))], np.int32)
    want = _warp_batched_tpu(jnp.asarray(document)[None], jnp.asarray(c)[None], (347, 200),
                             interpret=True)
    got = K.quad_warp(torch.from_numpy(document[None].copy()), torch.from_numpy(c[None]),
                      (347, 200))
    _eq(got, want)


def test_preprocess_binarize_matches_jax(document):
    _eq(gt.preprocess_binarize(document), jax_preprocess_binarize(jnp.asarray(document)))
    # a bright frame: Otsu's threshold is >= 246, so otsu + 10 wraps past 255
    rng = np.random.default_rng(3)
    bright = np.where(rng.random((40, 56)) < 0.5, 248, 255).astype(np.uint8)
    t = int(gs.otsu_threshold(gs.blur(bright, 1)))
    assert t >= 246
    want = jax_preprocess_binarize(jnp.asarray(bright))
    assert np.asarray(want).any()  # the wrapped threshold is small, so most pixels pass
    _eq(gt.preprocess_binarize(bright), want)
    frames = np.stack([bright, _rand((40, 56), 4)])
    got = gt.preprocess_binarize(frames)
    _eq(got[1], jax_preprocess_binarize(jnp.asarray(frames[1])))
    assert torch.equal(got[0], gt.preprocess_binarize(bright))
    assert torch.equal(got, gt.preprocess_binarize(frames, force_reference=True))


def test_scan_document_matches_jax(document):
    page, corners = gt.scan(document)
    want_page, want_corners = jax_scan(jnp.asarray(document))
    assert tuple(page.shape) == (1000, 800) and corners.dtype == torch.int32
    _eq(corners, want_corners)
    _eq(page, want_page)


def test_scan_batch_matches_jax_and_single(document):
    """``benchmarks/bench_all.py:153``'s batch: frame i rolled 3*i columns."""
    frames = np.stack([np.roll(document, 3 * i, axis=1) for i in range(3)])
    pages, corners = gt.scan(frames)
    want_pages, want_corners = jax_scan(jnp.asarray(frames))
    _eq(corners, want_corners)
    _eq(pages, want_pages)
    page, corner = gt.scan(frames[2])
    assert torch.equal(page, pages[2]) and torch.equal(corner, corners[2])
    ref = gt.scan(frames, force_reference=True)
    assert torch.equal(ref[0], pages) and torch.equal(ref[1], corners)


def test_scan_synthetic_quad_and_empty_frame():
    """``tests/test_pipelines.py:37-48``'s bright tilted page, and an all-zero frame."""
    img = np.full((120, 160), 30, np.uint8)
    yy, xx = np.mgrid[0:120, 0:160]
    inside = ((yy > 0.25 * xx - 5) & (yy < 100 - 0.1 * xx) & (xx > 20 + 0.1 * yy)
              & (xx < 140 - 0.05 * yy))
    img[inside] = 220
    zero = np.zeros((120, 160), np.uint8)
    for name, frame in (("quad", img), ("empty", zero)):
        page, corners = gt.scan(frame, out_size=(50, 40))
        want_page, want_corners = jax_scan(jnp.asarray(frame), out_size=(50, 40))
        _eq(corners, want_corners, name)
        _eq(page, want_page, name)
    assert corners.tolist() == [[0, 0]] * 4  # no blob: the zero centroid


def test_host_arrays_need_a_card_or_the_cpu(monkeypatch):
    """Outside ``host_arrays_to("cpu")`` a numpy input goes to the CUDA device;
    with none it raises rather than run on the CPU, and a CPU tensor still runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = _rand((12, 16), 9)
    with host_arrays_to(None):
        with pytest.raises(RuntimeError, match="host_arrays_to"):
            gt.blur(img, 1)
        with pytest.raises(RuntimeError, match="host_arrays_to"):
            gt.scan(img, out_size=(4, 4))
        with pytest.raises(RuntimeError, match="host_arrays_to"):
            gt.otsu_from_histogram(np.ones(256, np.int32), 256)
        out = gt.blur(torch.from_numpy(img), 1)
        assert out.device.type == "cpu"
    assert gt.blur(img, 1).device.type == "cpu"  # the tests' fixture asks for the CPU


# ---- K10's committed design replayed (csrc/warp.cu) ----

F32 = np.float32
TWO23, TWO23_BITS = F32(2.0**23), np.uint32(0x4B000000)


def _warp_constants():
    """The tunable constants of ``csrc/warp.cu`` as it is committed."""
    text = (_build.CSRC_DIR / "warp.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def _fadd_rz(a, b):
    """``__fadd_rz`` of float32 arrays: the exact sum (float64 holds it) rounded toward zero."""
    exact = np.asarray(a, np.float64) + np.asarray(b, np.float64)
    r = exact.astype(F32)
    over = np.abs(r.astype(np.float64)) > np.abs(exact)
    return np.where(over, np.nextafter(r, F32(0)), r).astype(F32)


def _truncate(s, trick=False):
    """(trunc(s), trunc(s) as float32) of clamped coordinates: warp.cu's F2I and
    I2F, or the truncation trick chip_sweep.py times against them."""
    if trick:
        t = _fadd_rz(s, TWO23)
        return (t.view(np.uint32) - TWO23_BITS).astype(np.int64), t - TWO23
    i = s.astype(np.int64)
    return i, i.astype(F32)


def _byte_to_float(b, trick=False):
    """warp.cu's I2F of a byte, or the byte trick chip_sweep.py times against it."""
    if trick:
        return (TWO23_BITS | b.astype(np.uint32)).view(F32) - TWO23
    return b.astype(F32)


def _store_byte(total, trick=True):
    """warp.cu's store: the low byte of __fadd_rz(sum, 2^23), or F2I's."""
    if trick:
        return (_fadd_rz(total, TWO23).view(np.uint32) & 0xFF).astype(np.uint8)
    return total.astype(np.int64).astype(np.uint8)


def _replay_pixels(frame, sx, sy):
    """warp.cu's ``warp_pixel`` from the unclamped coordinates ``sx``, ``sy``
    (float32 arrays of one shape) on one (sh, sw) frame."""
    sh, sw = frame.shape
    with np.errstate(invalid="ignore"):  # fmax takes a NaN to 0, as fmaxf does
        sx = np.fmin(np.fmax(sx, F32(0)), F32(sw) - F32(1))
        sy = np.fmin(np.fmax(sy, F32(0)), F32(sh) - F32(1))
    x0, fx0 = _truncate(sx)
    y0, fy0 = _truncate(sy)
    if sw > 2**24 or sh > 2**24 or sh * sw > 2**31 - 1:  # the kWide template clamps its reads
        xr, yr = np.minimum(x0, sw - 1), np.minimum(y0, sh - 1)
    else:  # (float)sw - 1 is sw - 1 exactly
        assert (x0 <= sw - 1).all() and (y0 <= sh - 1).all()
        xr, yr = x0, y0
    dx, dy = sx - fx0, sy - fy0
    omdx, omdy = F32(1) - dx, F32(1) - dy
    # past the last column (row) dx (dy) is exactly 0, and 0 stands in for the sample
    right, below = x0 < sw - 1, y0 < sh - 1
    assert (dx[~right] == 0).all() and (dy[~below] == 0).all()
    x1, y1 = np.where(right, x0 + 1, xr), np.where(below, y0 + 1, yr)
    b00 = frame[yr, xr]
    b01 = np.where(right, frame[yr, x1], 0)
    b10 = np.where(below, frame[y1, xr], 0)
    b11 = np.where(right & below, frame[y1, x1], 0)
    c00, c01, c10, c11 = (_byte_to_float(b) for b in (b00, b01, b10, b11))
    t1 = (c00 * omdx) * omdy
    t2 = (c01 * dx) * omdy
    t3 = (c10 * omdx) * dy
    t4 = (c11 * dx) * dy
    return _store_byte(((t1 + t2) + t3) + t4)


def _replay_quad_warp(src, corners, size):
    """K10 as warp.cu computes and stores it.

    Column terms (u, 1 - u, the four edge points) once a column, row terms (v,
    1 - v) once a row, then the pixels; then the launch's tiles walked block by block,
    warp by warp and row by row, lane l of a warp storing columns l + 32 j of
    the warp's 32 kCols that lie in the row: every page byte must be written
    once."""
    k = _warp_constants()
    cols, rows, threads = k["kCols"], k["kRows"], k["kThreads"]
    n, sh, sw = src.shape
    dh, dw = size

    def edge(p0, p1, t, omt):
        return p0 * omt + p1 * t

    with np.errstate(invalid="ignore", divide="ignore"):
        u = np.arange(dw, dtype=F32) / F32(dw - 1)
        v = np.arange(dh, dtype=F32) / F32(dh - 1)
    omu, omv = F32(1) - u, F32(1) - v
    q = corners.astype(F32).reshape(n, 8)
    pages = np.empty((n, dh, dw), np.uint8)
    for f in range(n):
        top_x, top_y = edge(q[f, 0], q[f, 2], u, omu), edge(q[f, 1], q[f, 3], u, omu)
        bot_x, bot_y = edge(q[f, 6], q[f, 4], u, omu), edge(q[f, 7], q[f, 5], u, omu)
        sx = edge(top_x[None], bot_x[None], v[:, None], omv[:, None])
        sy = edge(top_y[None], bot_y[None], v[:, None], omv[:, None])
        pages[f] = _replay_pixels(src[f], sx, sy)

    # the launch of gs_quad_warp and its tile walk
    groups = -(-dw // cols)
    gx = -(-groups // 32) * 32 if groups < threads else threads
    ry = threads // gx
    span = ry * rows
    tiles_y, tiles_x = -(-dh // span), -(-groups // gx)
    flat = pages.reshape(-1)
    out = np.full(flat.size, 0xA5, np.uint8)
    writes = np.zeros(out.size, np.int64)
    tx = np.arange(gx)
    lane = tx % 32
    for block in range(n * tiles_y):
        f, tile_y = divmod(block, tiles_y)
        for tile_x in range(tiles_x):
            x_first = (tile_x * gx + tx - lane) * cols + lane
            x_first = x_first[x_first < dw]
            for ty in range(ry):
                for kk in range(rows):
                    y = tile_y * span + ty + kk * ry
                    if y >= dh:
                        break
                    for j in range(cols):
                        x = x_first + 32 * j
                        at = (f * dh + y) * dw + x[x < dw]
                        out[at] = flat[at]
                        writes[at] += 1
    assert (writes == 1).all()
    return out.reshape(n, dh, dw)


# (name, frames, corners, page): DOC_QUADS on document.pgm, the identity, pages
# of one row and one column (a NaN grid), sources of one column and one row,
# coordinates clamped to exactly 0 and sw - 1, odd widths past a warp's 128
# columns.  Each frame takes the quad turned by its index.  Cases share frame
# and page shapes where they can, so that JAX compiles once for them.
REPLAY_CASES = [
    ("mild", "doc", DOC_QUADS["mild"], (61, 47)),
    ("steep", "doc", DOC_QUADS["steep"], (61, 47)),
    ("extreme", "doc", DOC_QUADS["extreme"], (61, 47)),
    ("outside", "doc", DOC_QUADS["outside"], (61, 47)),
    ("identity", (2, 30, 44), [[0, 0], [43, 0], [43, 29], [0, 29]], (30, 44)),
    ("one row", (2, 48, 64), [[3, 4], [50, 6], [40, 30], [5, 40]], (1, 37)),
    ("one column", (2, 48, 64), [[3, 4], [50, 6], [40, 30], [5, 40]], (29, 1)),
    ("one pixel", (3, 20, 30), [[3, 4], [50, 6], [40, 30], [5, 40]], (1, 1)),
    ("sw 1", (2, 40, 1), [[-3, 0], [4, 2], [2, 39], [0, 45]], (23, 17)),
    ("sh 1", (2, 1, 50), [[0, -2], [49, 0], [60, 3], [-5, 1]], (19, 21)),
    ("clamps to 0 and sw - 1", (2, 30, 44), [[-20, -9], [63, 0], [43, 40], [0, 29]], (30, 44)),
    ("odd widths", (2, 33, 41), [[2, 1], [39, 3], [35, 30], [0, 31]], (23, 347)),
]


@pytest.mark.parametrize("case", REPLAY_CASES, ids=[c[0] for c in REPLAY_CASES])
def test_quad_warp_tile_replay_vs_plain_and_jax(case, document):
    """K10's design replayed in numpy, held to ``quad_warp_plain`` and JAX
    ``perspective_correct`` (tolerance 0: uint8 pages)."""
    name, shape, quad, page = case
    if shape == "doc":
        frames = np.stack([document, np.roll(document, 3, axis=1)])
    else:
        frames = _rand(shape, len(name))
    n = frames.shape[0]
    corners = np.array([np.roll(quad, -i, axis=0) for i in range(n)], np.int32)  # turned
    got = _replay_quad_warp(frames, corners, page)
    plain = K.quad_warp_plain(torch.from_numpy(frames), torch.from_numpy(corners), page)
    _eq(plain, got, f"{name}: replay vs quad_warp_plain")
    with np.errstate(invalid="ignore"):
        want = gs.perspective_correct(jnp.asarray(frames), jnp.asarray(corners), page)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"{name}: replay vs JAX")


@pytest.mark.parametrize("tall", [False, True], ids=["wide", "tall"])
def test_quad_warp_past_2_24_matches_jax(tall):
    """A frame of 2^24 + 4 columns (or rows) and a quad past its far edge: the
    clamp's float32 bound ``(float)sw - 1`` rounds to sw, one past the last
    column.  The JAX package's gather clamps the read to the frame; the plain
    version read past the row (past the buffer on the last row, where its
    gather raised), and the kernel now takes its clamping template there."""
    big = 2**24 + 4
    frames = _rand((1, 2, big), 21)
    quad = np.array([[big - 40, -3], [big + 100, 0], [big + 100, 4], [big - 40, 1]], np.int32)
    page = (3, 7)
    if tall:
        frames = np.ascontiguousarray(frames.transpose(0, 2, 1))
        quad, page = np.ascontiguousarray(quad[[0, 3, 2, 1], ::-1]), page[::-1]
    want = np.asarray(gs.perspective_correct(jnp.asarray(frames[0]), jnp.asarray(quad), page))
    plain = K.quad_warp_plain(torch.from_numpy(frames), torch.from_numpy(quad[None]), page)
    _eq(plain[0], want, "quad_warp_plain vs JAX")
    np.testing.assert_array_equal(_replay_quad_warp(frames, quad[None], page)[0], want)


def test_quad_warp_replay_clamps_and_tricks():
    """warp.cu's clamp at its edges: coordinates at and past 0 (also -0.0, NaN,
    infinities) and sw - 1, held to the first port's formula (the plain
    version's: ``where`` clamps, an int cast); its store trick, and the byte
    and truncation tricks that chip_sweep.py times, against their conversions
    over every value they take (the truncation trick only below 2^23)."""
    frame = _rand((5, 9), 11)
    raw = np.array([-0.0, 0.0, -1e-7, 1e-7, 0.5, 7.999999, 8.0, 8.0 + 2**-20, 9.5, np.nan, np.inf,
                    -np.inf, -3.0, 4.0, 3.75], F32)
    sx, sy = np.meshgrid(raw, raw * F32(0.5))
    got = _replay_pixels(frame, sx, sy)
    with np.errstate(invalid="ignore"):
        x = np.where(sx > F32(8), F32(8), sx)
        x = np.where(x >= 0, x, F32(0))
        y = np.where(sy > F32(4), F32(4), sy)
        y = np.where(y >= 0, y, F32(0))
    x0, y0 = x.astype(np.int64), y.astype(np.int64)
    x1, y1 = np.minimum(x0 + 1, 8), np.minimum(y0 + 1, 4)
    dx, dy = x - x0.astype(F32), y - y0.astype(F32)
    c = [frame[a, b].astype(F32) for a, b in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
    total = ((((c[0] * (F32(1) - dx)) * (F32(1) - dy)) + ((c[1] * dx) * (F32(1) - dy)))
             + ((c[2] * (F32(1) - dx)) * dy)) + ((c[3] * dx) * dy)
    np.testing.assert_array_equal(got, total.astype(np.int64).astype(np.uint8))
    # each trick against its conversion, over what it takes
    b = np.arange(256, dtype=np.uint32)
    np.testing.assert_array_equal(_byte_to_float(b, True), b.astype(F32))
    s = np.concatenate([np.array([-0.0, 0.0, 0.5, 2**23 - 1, 2**23 - 0.5], F32),
                        np.random.default_rng(12).uniform(0, 2**23, 4096).astype(F32)])
    for trick in (True, False):
        i, whole = _truncate(s, trick)
        np.testing.assert_array_equal(i, np.trunc(s).astype(np.int64))
        np.testing.assert_array_equal(whole, np.trunc(s))
    past = np.array([2**23 + 1, 2**23 + 3], F32)
    assert (_truncate(past, True)[0] != past.astype(np.int64)).all()
    sums = np.concatenate([np.array([-0.0, 0.0, 254.99998, 255.0, 255.00002], F32),
                           np.random.default_rng(13).uniform(0, 256, 4096).astype(F32)])
    np.testing.assert_array_equal(_store_byte(sums, True), sums.astype(np.int64).astype(np.uint8))


def test_quad_warp_replay_matches_pallas_band_sampler(document):
    """The replay once against ``_warp_batched_tpu`` in interpret mode."""
    h, w = document.shape
    c = np.array([(int(w * 0.1), int(h * 0.15)), (int(w * 0.9), int(h * 0.1)),
                  (int(w * 0.85), int(h * 0.9)), (int(w * 0.12), int(h * 0.88))], np.int32)
    got = _replay_quad_warp(document[None], c[None], (45, 37))
    want = _warp_batched_tpu(jnp.asarray(document)[None], jnp.asarray(c)[None], (45, 37),
                             interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
