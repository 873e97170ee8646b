"""The port's contour tracing against ``grayskull_tpu``'s, on the CPU.

K20's plain version ``contour_plain`` behind ``trace_contour``,
``largest_blob_contour`` and ``find_contours`` is held, with tolerance 0
(every output is an integer), to the JAX functions on the same inputs: the
reference vector and the ``shapes_img`` frames of
``tests/test_blobs_contour.py``, carried masks, single pixels, pixels of
exactly 128, nested and touching blobs, a noise frame whose walk ends at the
step bound, starts outside the frame, and the contour goldens.  K20's ballot
selection, first-pixel search and find mode (walks side by side, resolved in
table order; ``csrc/contour.cu``) are replayed in numpy.

The JAX multi-contour functions build a new ``jax.jit`` on every call (about
1.5 s each here), so each case runs them once.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grayskull_tpu_torch as gt
from grayskull_tpu.ops.blobs import blobs as jax_blobs
from grayskull_tpu.ops.contour import _DX as JAX_DX
from grayskull_tpu.ops.contour import _DY as JAX_DY
from grayskull_tpu.ops.contour import _first_label_pixel
from grayskull_tpu.ops.contour import find_contours as jax_find_contours
from grayskull_tpu.ops.contour import largest_blob_contour as jax_largest_blob_contour
from grayskull_tpu.ops.contour import trace_contour as jax_trace_contour
from grayskull_tpu_torch import kernels as K
from tests.test_blobs_contour import first_boundary_start, shapes_img
from tests.test_torch_cuda import host_arrays_on_cpu, snake, spiral  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 255


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=msg)


def _same_contour(got, want, msg=""):
    for name, a, b in (("box", tuple(got.box), tuple(want.box)),
                       ("start", tuple(got.start), tuple(want.start)),
                       ("length", got.length, want.length)):
        _eq(np.array([int(v) for v in np.atleast_1d(a)] if name != "length" else int(a)),
            np.array([int(v) for v in np.atleast_1d(b)] if name != "length" else int(b)),
            f"{msg} {name}")
    assert got.visited.dtype == torch.uint8
    _eq(got.visited.numpy(), want.visited, f"{msg} visited")


def _same_table(got, want, msg=""):
    assert int(got.n) == int(want.n), msg
    for name, a, b in (("box", got.box, want.box), ("start", got.start, want.start)):
        for field, x, y in zip(("x", "y", "w", "h"), a, b):
            assert x.dtype == torch.int32
            _eq(x.numpy(), y, f"{msg} {name}.{field}")
    _eq(got.length.numpy(), want.length, f"{msg} length")
    _eq(got.visited.numpy(), want.visited, f"{msg} visited")


def _noise(shape, p, seed):
    return ((np.random.default_rng(seed).random(shape) > p) * 255).astype(np.uint8)


def _rects(h, w, rects, value=255):
    img = np.zeros((h, w), np.uint8)
    for y0, x0, y1, x1 in rects:
        img[y0:y1, x0:x1] = value
    return img


def test_trace_contour_reference_vector():
    img = np.array([[0, W, W, W, 0], [0, W, W, W, 0], [0, W, 0, W, W], [0, W, W, W, 0],
                    [0, 0, W, 0, W]], np.uint8)
    c = gt.trace_contour(img, (1, 0))
    _same_contour(c, jax_trace_contour(img, (1, 0)))
    assert int(c.length) == 10
    assert tuple(int(v) for v in c.box) == (1, 0, 4, 5)
    _eq(c.visited.numpy(), [[0, W, W, W, 0], [0, W, 0, W, 0], [0, W, 0, 0, W], [0, W, 0, W, 0],
                            [0, 0, W, 0, 0]])


def _trace_cases():
    """(name, frame, start, visited or None)."""
    rng = np.random.default_rng(5)
    cases = []
    for trial in range(4):
        img = shapes_img(rng, 24, 28)
        if first_boundary_start(img) is not None:
            cases.append((f"shapes_{trial}", img, first_boundary_start(img), None))
    one = np.zeros((7, 9), np.uint8)
    one[3, 4] = W
    cases.append(("single_pixel", one, (4, 3), None))
    cases.append(("single_pixel_corner", _rects(5, 5, [(0, 0, 1, 1)]), (0, 0), None))
    gray = _rects(10, 12, [(2, 2, 8, 9)])
    gray[2, 2:5] = 128  # blob pixels (>= 128) that are not contour foreground (> 128)
    gray[5, 8] = 129
    cases.append(("pixels_of_128_from_128", gray, (2, 2), None))
    cases.append(("pixels_of_128", gray, (5, 2), None))
    cases.append(("all_128", _rects(6, 6, [(1, 1, 5, 5)], 128), (1, 1), None))
    nested = _rects(20, 20, [(2, 2, 18, 18)])
    nested[5:15, 5:15] = 0
    nested[8:12, 8:12] = W
    cases.append(("nested_outer", nested, (2, 2), None))
    cases.append(("nested_inner", nested, (8, 8), None))
    touching = _rects(12, 16, [(1, 1, 6, 8), (6, 8, 11, 15)])  # diagonal touch
    cases.append(("touching", touching, (1, 1), None))
    cases.append(("snake", snake(), (0, 0), None))
    cases.append(("spiral", spiral(40, 64), (0, 0), None))
    noise = _noise((12, 12), 0.45, 0)
    cases.append(("noise_step_bound", noise, first_boundary_start(noise), None))
    carried = np.zeros((10, 12), np.uint8)
    carried[2, 3:7] = 255
    carried[7, 2] = 7  # any non-zero byte counts as visited and keeps its value
    carried[5, 8] = 1
    cases.append(("carried_mask", _rects(10, 12, [(2, 2, 8, 9)]), (2, 2), carried))
    cases.append(("visited_start", _rects(10, 12, [(2, 2, 8, 9)]), (2, 2),
                  _rects(10, 12, [(2, 2, 3, 3)], 9)))
    cases.append(("background_start", _rects(10, 12, [(2, 2, 8, 9)]), (0, 0), None))
    return cases


@pytest.mark.parametrize("case", _trace_cases(), ids=lambda c: c[0])
def test_trace_contour_matches_jax(case):
    name, img, start, visited = case
    got = gt.trace_contour(img, start, visited)
    want = jax_trace_contour(img, start, visited)
    _same_contour(got, want, name)
    if visited is not None:  # the given mask is copied, not changed
        assert int(visited[2, 2]) in (0, 9)


def test_trace_contour_noise_runs_to_the_step_bound():
    """A walk that never returns to its start: all 4 * 12 * 12 + 8 steps."""
    noise = _noise((12, 12), 0.45, 0)
    start = first_boundary_start(noise)
    img = torch.from_numpy(noise)
    vis = torch.zeros_like(img)
    rows, flag, steps = K.contour_plain(img, vis, start=start)
    assert flag is None and steps.tolist() == [4 * 12 * 12 + 8]
    assert rows[:, 0].tolist() == [0, 0, 12, 12, *start, 36]
    _eq(vis.numpy(), jax_trace_contour(noise, start).visited)


@pytest.mark.parametrize("start", [(-1, 0), (0, -1), (6, 0), (-7, 0), (0, 6), (-1, -1)])
def test_trace_contour_starts_outside_the_frame(start):
    """JAX's index rule on the start pixel's mask byte: a negative index adds
    the size once, a read still out of range clamps, a write out of range is
    dropped."""
    img = _rects(6, 6, [(0, 0, 3, 3)])
    got = gt.trace_contour(img, start)
    want = jax_trace_contour(img, start)
    _same_contour(got, want, str(start))
    expect = {(-1, 0): ((-1, 0, 4, 3), 9), (0, -1): ((0, -1, 3, 4), 9), (6, 0): ((6, 0, 1, 1), 1),
              (-7, 0): ((-7, 0, 1, 1), 1)}
    if start in expect:
        assert (tuple(int(v) for v in got.box), int(got.length)) == expect[start]
    if start == (-1, 0):
        assert int(got.visited[0, 5]) == 255
    if start in ((6, 0), (-7, 0)):
        assert int(got.visited.sum()) == 0


def test_trace_contour_start_as_tensors():
    img = _rects(10, 12, [(2, 2, 8, 9)])
    want = gt.trace_contour(img, (2, 2))
    for start in (torch.tensor([2, 2]), (torch.tensor(2), torch.tensor(2)), (np.int64(2), 2)):
        got = gt.trace_contour(img, start)
        for a, b in zip([*got.box, *got.start, got.length, got.visited],
                        [*want.box, *want.start, want.length, want.visited]):
            assert torch.equal(a, b)


def test_trace_contour_rejects_what_jax_rejects():
    img = _rects(6, 6, [(0, 0, 3, 3)])
    with pytest.raises(OverflowError):
        jax_trace_contour(img, (2**31, 0))
    with pytest.raises(OverflowError):
        gt.trace_contour(img, (2**31, 0))
    with pytest.raises(ValueError):
        gt.trace_contour(np.zeros((2, 6, 6), np.uint8), (0, 0))
    with pytest.raises(TypeError):
        gt.trace_contour(img, (0, 0), np.zeros((6, 6), np.int32))


def test_contour_goldens():
    g = np.load(os.path.join(REPO, "tests", "golden", "goldens.npz"))
    img = g["contour_input"]
    c1 = gt.trace_contour(img, (6, 5))
    _eq([*(int(v) for v in c1.box), int(c1.length)], g["contour1"].astype(np.int64))
    c2 = gt.trace_contour(img, (42, 20), visited=c1.visited)
    _eq([*(int(v) for v in c2.box), int(c2.length)], g["contour2"].astype(np.int64))
    _eq(c2.visited.numpy(), g["contour_visited"])
    c, found = gt.largest_blob_contour(img, max_blobs=16)
    assert found.dtype == torch.bool
    want = g["largest_contour"].astype(np.int64)
    _eq([int(found), *(int(v) for v in c.box), int(c.length), int(c.start.x), int(c.start.y)],
        want)


def _twelve_blobs(h=48, w=64):
    """``benchmarks/bench_all.py:255-258``'s 12-rectangle frame at 1/10 scale."""
    return _rects(h, w, [(12 * r + 2, 16 * c + 3, 12 * r + 10, 16 * c + 13)
                         for r in range(3) for c in range(4)])


def _multi_cases():
    """(name, frame, max_contours, max_blobs)."""
    nested = _rects(24, 24, [(1, 1, 23, 23)])
    nested[4:20, 4:20] = 0
    nested[7:17, 7:17] = W
    nested[10:14, 10:14] = 0
    nested[11:13, 11:13] = W  # three nested rings
    # the first two touch diagonally: two blobs (4-connected), one walk (8-connected)
    diagonal = _rects(20, 30, [(2, 2, 12, 12), (12, 12, 18, 25), (2, 14, 8, 20)])
    joined = diagonal.copy()
    joined[12, 11] = W  # now 4-joined: one blob
    gray = _twelve_blobs()
    gray[14:22, 3:13] = 128  # a blob of pixels of exactly 128: labelled, never walked
    gray[2, 3:8] = 128  # a blob whose first pixel is 128
    dots = np.zeros((20, 24), np.uint8)
    dots[1::3, 1::3] = W  # single pixels: more seeds than max_blobs
    return [("twelve", _twelve_blobs(), 16, 64), ("twelve_cap_5", _twelve_blobs(), 5, 64),
            ("nested", nested, 8, 8), ("diagonal_skip", diagonal, 4, 4), ("joined", joined, 4, 4),
            ("gray", gray, 16, 64),
            ("dots_overflow", dots, 6, 10), ("noise", _noise((30, 40), 0.5, 3), 64, 200),
            ("empty", np.zeros((9, 9), np.uint8), 4, 4), ("none", _twelve_blobs(), 0, 0)]


@pytest.mark.parametrize("case", _multi_cases(), ids=lambda c: c[0])
def test_find_contours_matches_jax(case):
    name, img, max_contours, max_blobs = case
    got = gt.find_contours(img, max_contours, max_blobs)
    want = jax_find_contours(img, max_contours, max_blobs)
    _same_table(got, want, name)
    assert got.n.dtype == torch.int32 and got.n.ndim == 0
    if name == "twelve":
        assert int(got.n) == 12
    if name == "diagonal_skip":  # the second blob's start lies on the first walk: skipped
        assert int(got.n) == int(gt.blobs(img, max_blobs)[0].n) - 1


def test_find_contours_raises_as_jax():
    img = _twelve_blobs()
    with pytest.raises(ValueError):
        jax_find_contours(img, 9, 8)
    with pytest.raises(ValueError):
        gt.find_contours(img, 9, 8)
    with pytest.raises(ValueError):
        gt.find_contours(img, -1, 8)


@pytest.mark.parametrize("name", ["found", "too_small", "empty", "first_max"])
def test_largest_blob_contour_matches_jax(name):
    if name == "found":
        img = _rects(40, 50, [(2, 2, 8, 9), (10, 5, 30, 40), (32, 1, 38, 48)])
    elif name == "too_small":
        img = _twelve_blobs()  # 8 x 10 = 80 < 100
    elif name == "empty":
        img = np.zeros((16, 16), np.uint8)
    else:
        img = _rects(30, 50, [(2, 2, 12, 22), (15, 25, 25, 45)])  # equal areas: the first wins
    c, found = gt.largest_blob_contour(img, 8)
    cj, fj = jax_largest_blob_contour(img, 8)
    assert bool(found) == bool(fj) == (name in ("found", "first_max"))
    _same_contour(c, cj, name)
    if not bool(found):
        assert int(c.visited.sum()) == 0 and int(c.length) == 0
    with pytest.raises(ValueError):
        gt.largest_blob_contour(img, 0)


def test_first_pixel_search_matches_first_label_pixel():
    """K20 searches a blob's first pixel from its box's top-left corner
    (``csrc/contour.cu:first_pixel``); JAX takes the first raster pixel of its
    label (``_first_label_pixel``).  Each valid row, and the full search of a
    label map that can wrap (capacity past 65,535)."""
    from grayskull_tpu_torch.kernels.contour import _first_pixel

    for seed, img in enumerate([_noise((25, 31), 0.5, 8), spiral(30, 40), snake(),
                                shapes_img(np.random.default_rng(2), 24, 28)]):
        table, lm, _ = gt.blobs(img, 500)
        jtable, jlm, _ = jax_blobs(img, 500)
        lm = lm.numpy()
        for k in range(int(table.n)):
            label = int(table.label[k])
            lo = int(table.box.y[k]) * img.shape[1] + int(table.box.x[k])
            jx, jy, hit = _first_label_pixel(jlm, label)
            assert bool(hit)
            assert _first_pixel(lm, lo, label) == (int(jx), int(jy)) == _first_pixel(lm, 0, label)
        assert _first_pixel(lm, 0, 501) is None


# csrc/contour.cu's direction tables: dx + 1 and dy + 1, two bits a direction
with open(os.path.join(REPO, "grayskull_tpu_torch", "csrc", "contour.cu")) as _f:
    CONTOUR_CU = _f.read()
_DX_PACKED, _DY_PACKED = (int(re.search(rf"{name} = (0x[0-9A-Fa-f]+)u;", CONTOUR_CU).group(1), 16)
                          for name in ("kDxPacked", "kDyPacked"))
_DX, _DY = (tuple(int(v) for v in np.asarray(t)) for t in (JAX_DX, JAX_DY))


def _packed(table, d):
    return ((table >> (2 * d)) & 3) - 1


def _select(m, ndir):
    """K20's selection: the first direction at or after ``ndir`` in the ballot
    ``m`` (bit l: lane l's fixed direction l), by ``__ffs`` of the doubled
    ballot shifted by ``ndir``; then the next walk step's ``ndir``."""
    rotated = ((m * 0x101) & 0xFFFFFFFF) >> ndir
    sel = (ndir + (rotated & -rotated).bit_length() - 1) & 7
    return sel, (sel + 7) & 7


def _ballot(img, px, py):
    """The warp's ballot: lane l < 8 tests the neighbour in direction l."""
    h, w = img.shape
    m = 0
    for lane in range(32):
        nx, ny = px + _packed(_DX_PACKED, lane & 7), py + _packed(_DY_PACKED, lane & 7)
        if lane < 8 and 0 <= nx < w and 0 <= ny < h and img[ny, nx] > 128:
            m |= 1 << lane
    return m


def test_ballot_selection_replay():
    """K20's step in numpy, as ``csrc/contour.cu:walk`` takes it: lane l tests
    the fixed direction l from ``kDxPacked`` and ``kDyPacked``, the doubled
    ballot ``(m * 0x101) >> ndir`` and ``__ffs`` pick the first foreground
    neighbour, and ``ndir = (sel + 7) & 7``.  Held, for the 256 neighbour
    patterns in each of the 8 directions, to ``contour_plain``'s scan
    (``_walk``: from ``(dir + 1) % 8`` clockwise, then ``dir = (sel + 6) % 8``)."""
    assert "__ffs((m * 0x101u) >> ndir)" in CONTOUR_CU and "ndir = (sel + 7) & 7;" in CONTOUR_CU
    assert [_packed(_DX_PACKED, d) for d in range(8)] == list(_DX)
    assert [_packed(_DY_PACKED, d) for d in range(8)] == list(_DY)
    for d in range(8):
        ndir = (d + 1) % 8
        for pattern in range(256):  # bit k: the neighbour in direction k is foreground
            img = np.zeros((3, 3), np.uint8)
            for k in range(8):
                img[1 + _DY[k], 1 + _DX[k]] = 255 if (pattern >> k) & 1 else 128
            m = _ballot(img, 1, 1)
            assert m == pattern
            scan = [s for s in ((ndir + k) % 8 for k in range(8)) if (pattern >> s) & 1]
            if m == 0:
                assert not scan
                continue
            sel, next_ndir = _select(m, ndir)
            assert sel == scan[0]
            assert next_ndir == ((sel + 6) % 8 + 1) % 8
            assert (_packed(_DX_PACKED, sel), _packed(_DY_PACKED, sel)) == (_DX[sel], _DY[sel])


def _replay_walk(img, vis, sx, sy):
    """``csrc/contour.cu:walk`` for a start in the frame, step for step: the
    visited state read a step before it is counted, the ballot, the selection,
    the packed move and the box; returns (box, length, steps)."""
    h, w = img.shape
    max_steps = 4 * h * w + 8
    old, vis[sy, sx] = vis[sy, sx], 255
    px, py, bx, by, bw, bh, length, ndir, seen, steps = sx, sy, sx, sy, 1, 1, 0, 0, False, 0
    while True:
        m = _ballot(img, px, py)
        length += int(old == 0)
        steps += 1
        if m == 0:
            break
        sel, ndir = _select(m, ndir)
        px, py = px + _packed(_DX_PACKED, sel), py + _packed(_DY_PACKED, sel)
        bx, by = min(bx, px), min(by, py)
        bw, bh = max(bw, px + 1 - bx), max(bh, py + 1 - by)
        at_start = px == sx and py == sy
        if (at_start and seen) or steps >= max_steps:
            break
        seen = seen or at_start
        old, vis[py, px] = vis[py, px], 255
    return (bx, by, bw, bh), length, steps


@pytest.mark.parametrize("name", ["spiral", "snake", "noise_step_bound", "single_pixel",
                                  "gray_128", "carried_mask"])
def test_ballot_walk_replay(name):
    """Whole walks of the replayed kernel step against ``contour_plain``'s
    ``_walk``: box, length, steps and mask, from the first foreground pixel."""
    from grayskull_tpu_torch.kernels.contour import _walk

    vis = None
    if name == "spiral":
        img = spiral(20, 32)
    elif name == "snake":
        img = snake()
    elif name == "noise_step_bound":
        img = _noise((12, 12), 0.45, 0)
    elif name == "single_pixel":
        img = np.zeros((5, 6), np.uint8)
        img[2, 3] = 255
    elif name == "gray_128":
        img = _rects(12, 14, [(2, 2, 9, 11)])
        img[2:9, 5] = 128
        img[4, 2:11] = 128
    else:
        img = _rects(16, 20, [(2, 2, 13, 17)])
        vis = np.zeros(img.shape, np.uint8)
        vis[2:13:3, 2:17:2] = 7
        vis[12, 4:9] = 200
    vis = np.zeros(img.shape, np.uint8) if vis is None else vis
    h, w = img.shape
    sy, sx = (int(v) for v in np.argwhere(img > 128)[0])
    got_vis = vis.copy()
    got = _replay_walk(img, got_vis, sx, sy)
    want_vis = bytearray(vis.tobytes())
    want = _walk(img.tobytes(), want_vis, h, w, sx, sy)
    assert got == want, name
    _eq(got_vis.reshape(-1), np.frombuffer(bytes(want_vis), np.uint8), name)
    if name == "noise_step_bound":
        assert got[2] == 4 * h * w + 8


def test_jax_step_bound_overflows_past_2_29_pixels():
    """JAX counts a walk's steps in int32 against ``4 * h * w + 8``: past 2^29
    pixels that bound is no int32 and JAX cannot trace the walk.  The port
    counts in 64 bits (K20's byte path, ``contour_plain``'s Python ints), so
    the two packages can no longer be compared there."""
    def trace(img):
        return jax_trace_contour(img, (0, 0))

    jax.eval_shape(trace, jax.ShapeDtypeStruct((1, 2**27), jnp.uint8))
    with pytest.raises(OverflowError):
        jax.eval_shape(trace, jax.ShapeDtypeStruct((1, 2**29 + 64), jnp.uint8))


# csrc/contour.cu's find mode: walks side by side, kWindow rows a window
K20_STAGE_THREADS = int(re.search(r"constexpr int kStageThreads = (\d+);", CONTOUR_CU).group(1))
assert "constexpr int kWindow = kStageThreads / 32;" in CONTOUR_CU
K20_WINDOW = K20_STAGE_THREADS // 32


def _path_walk(img, sx, sy):
    """One of find's walks (``csrc/contour.cu:walk`` with ``PathBits``): the
    ballot step of ``_replay_walk`` on no mask; returns (box, steps, the flat
    indices it visited, its span x0, y0, x1, y1)."""
    h, w = img.shape
    max_steps = 4 * h * w + 8
    px, py, bx, by, bw, bh, ndir, seen, steps = sx, sy, sx, sy, 1, 1, 0, False, 0
    visited = [sy * w + sx]
    while True:
        m = _ballot(img, px, py)
        steps += 1
        if m == 0:
            break
        sel, ndir = _select(m, ndir)
        px, py = px + _packed(_DX_PACKED, sel), py + _packed(_DY_PACKED, sel)
        bx, by = min(bx, px), min(by, py)
        bw, bh = max(bw, px + 1 - bx), max(bh, py + 1 - by)
        at_start = px == sx and py == sy
        if (at_start and seen) or steps >= max_steps:
            break
        seen = seen or at_start
        visited.append(py * w + px)
    visited = np.array(visited)
    xs, ys = visited % w, visited // w
    return (bx, by, bw, bh), steps, visited, (xs.min(), ys.min(), xs.max(), ys.max())


def k20_find_replay(img, vis, table, label_map, max_contours):
    """``csrc/contour.cu``'s find mode in numpy: windows of K20_WINDOW rows in
    table order; each row's first pixel and its walk, ORing the walk's bit into
    a map of path words and marking nothing; then, in table order, a row is
    kept when its first pixel's mask byte is 0 and no earlier kept walk of the
    window set a bit there; each pixel with a bit is resolved once, in the
    span of its lowest walk: counted for the lowest kept walk when its mask
    byte is 0, set to 255 where a kept walk reached it, its word cleared; the
    kept rows compacted.  ``vis`` is updated in place; returns (rows, count,
    steps) as ``contour_plain`` does."""
    from grayskull_tpu_torch.kernels.contour import _LABEL_MAP_LIMIT, ROW_FIELDS, _first_pixel

    h, w = img.shape
    flat = vis.reshape(-1)
    labels = table.label.numpy()
    box_x, box_y = table.box.x.numpy(), table.box.y.numpy()
    full_scan = labels.shape[0] >= _LABEL_MAP_LIMIT
    rows = min(int(table.n), max_contours)
    out = np.zeros((len(ROW_FIELDS), max_contours), np.int32)
    out_steps = np.zeros(max_contours, np.int64)
    path = np.zeros(h * w, np.int64)  # a bit a walk of the window
    kept = 0
    for k0 in range(0, rows, K20_WINDOW):
        walks = {}
        for j in range(min(K20_WINDOW, rows - k0)):
            lo = 0 if full_scan else int(box_y[k0 + j]) * w + int(box_x[k0 + j])
            px = _first_pixel(label_map, lo, int(labels[k0 + j]))
            if px is not None:
                box, steps, visited, span = _path_walk(img, *px)
                path[visited] |= 1 << j
                walks[j] = (px, box, steps, span)
        keep = 0
        for j, ((x, y), _, _, _) in sorted(walks.items()):
            if flat[y * w + x] == 0 and path[y * w + x] & keep == 0:
                keep |= 1 << j
        length = dict.fromkeys(walks, 0)
        for j, (_, _, _, (x0, y0, x1, y1)) in sorted(walks.items()):
            at = (np.arange(y0, y1 + 1)[:, None] * w + np.arange(x0, x1 + 1)[None]).reshape(-1)
            word = path[at]
            mine = at[((word >> j) & 1 == 1) & (word & ((1 << j) - 1) == 0)]
            word = path[mine]
            path[mine] = 0
            kept_bits = word & keep
            reached = mine[kept_bits != 0]
            lowest = kept_bits[kept_bits != 0]
            lowest = np.log2(lowest & -lowest).astype(np.int64)
            fresh = flat[reached] == 0
            for lj, n in zip(*np.unique(lowest[fresh], return_counts=True)):
                length[int(lj)] += int(n)
            flat[reached] = 255
        for j in range(K20_WINDOW):
            if (keep >> j) & 1:
                (x, y), box, steps, _ = walks[j]
                out[:, kept] = (*box, x, y, length[j])
                out_steps[kept] = steps
                kept += 1
    assert not path.any()  # the kernel leaves its scratch map zero
    return out, kept, out_steps


def _overlap_cases():
    """(name, frame, max_contours, max_blobs, carried mask or None) built for
    the side-by-side walks: a kept walk crossing the pixels of a skipped walk
    (the first blob's start carried as visited), a walk crossing the first
    pixel of a row past ``max_contours``, and more rows than one window."""
    diagonal = _rects(20, 30, [(2, 2, 12, 12), (12, 12, 18, 25), (2, 14, 8, 20)])
    skip_first = np.zeros_like(diagonal)
    skip_first[2, 2] = 9  # the first blob's start: its walk is skipped, its pixels stay fresh
    dots = np.zeros((40, 48), np.uint8)
    dots[1::3, 1::3] = W  # 208 single pixels
    return [("skipped_crossed", diagonal, 4, 4, skip_first),
            ("past_cap_start", diagonal, 1, 4, None),
            ("dots_100_cap_80", dots, 80, 100, None)]


def _replay_cases():
    cases = [(name, img, mc, mb, None) for name, img, mc, mb in _multi_cases()]
    return cases + _overlap_cases()


@pytest.mark.parametrize("mask", ["zero", "carried"])
@pytest.mark.parametrize("case", _replay_cases(), ids=lambda c: c[0])
def test_k20_side_by_side_replay(case, mask):
    """K20's find mode replayed (walks with no marks, then the in-order
    resolution) against ``contour_plain`` on the same mask, and against the
    JAX ``find_contours`` on a zero mask: rows, count, steps and mask."""
    name, img, max_contours, max_blobs, carried = case
    table, label_map, _ = gt.blobs(img, max_blobs)
    if mask == "zero":
        vis = np.zeros_like(img)
    elif carried is not None:
        vis = carried.copy()
    else:
        vis = np.zeros_like(img)
        vis[::7, ::5] = 8
        vis[3::7, 2::5] = 9  # any non-zero byte counts as visited and keeps its value
    got_vis = vis.copy()
    rows, count, steps = k20_find_replay(img, got_vis, table, label_map.numpy(), max_contours)
    want_vis = torch.from_numpy(vis.copy())
    want = K.contour_plain(torch.from_numpy(img), want_vis, table=table, label_map=label_map,
                           max_contours=max_contours)
    _eq(rows, want[0].numpy(), f"{name} {mask} rows")
    assert count == int(want[1]), name
    _eq(steps, want[2].numpy(), f"{name} {mask} steps")
    _eq(got_vis, want_vis.numpy(), f"{name} {mask} visited")
    if mask == "zero" and max_blobs:
        j = jax_find_contours(img, max_contours, max_blobs)
        assert count == int(j.n)
        want_rows = np.stack([*(np.asarray(v) for v in j.box),
                              *(np.asarray(v) for v in j.start), np.asarray(j.length)])
        _eq(rows[:, :count], want_rows[:, :count], name)
        _eq(got_vis, j.visited, name)
    if name == "skipped_crossed" and mask == "carried":
        # the third blob's walk (the 6 x 13 one) goes round the skipped first
        # blob too: it is kept and counts that blob's boundary as fresh
        assert count == 2 and rows[6, 1] > 2 * (6 + 13) - 4
    if name == "dots_100_cap_80":  # three windows; a carried mask skips some dots
        assert count == 80 > 2 * K20_WINDOW if mask == "zero" else 2 * K20_WINDOW < count < 80
