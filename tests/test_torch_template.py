"""The port's template matching against ``grayskull_tpu``'s, on the CPU.

K19's plain version ``match_template_plain``, ``match_template``,
``find_best_match`` and ``parallel.match_template_sharded`` are held, with
tolerance 0 (every output is an integer), to the JAX functions on the same
inputs (random frames and templates made with numpy from a seed, maps of ties,
the ``match_template`` golden).  The JAX sharded version runs on the 8 virtual
CPU devices of ``tests/conftest.py``; the port's mesh names the CPU device as
many times.  K19's two designs (``csrc/template.cu``), the INT32 word layout
and the tensor-core fragments, are replayed in numpy and held to the plain
version (and the second to JAX).
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

import grayskull_tpu as gs
import grayskull_tpu_torch as gt
from grayskull_tpu.parallel import make_mesh as jax_make_mesh
from grayskull_tpu.parallel import match_template_sharded as jax_match_template_sharded
from grayskull_tpu_torch import kernels as K
from grayskull_tpu_torch import parallel as tp
from tests.test_torch_cuda import host_arrays_on_cpu  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "grayskull_tpu_torch", "csrc", "template.cu")) as _f:
    _TEMPLATE_SOURCE = _f.read()
K19_COLS, K19_ROWS = (int(re.search(rf"constexpr int {name} = (\d+);", _TEMPLATE_SOURCE).group(1))
                      for name in ("kCols", "kRows"))
K19_STAGE_BYTES = 96 * 1024
assert f"kStageBytes = {K19_STAGE_BYTES // 1024} * 1024" in _TEMPLATE_SOURCE


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


# (frame or batch shape, template shape, where a perfect match is planted or None)
MATCH_CASES = [
    ((30, 41), (1, 1), None),
    ((30, 41), (5, 7), (3, 9)),
    ((30, 41), (30, 41), (0, 0)),  # as large as the image: a 1x1 map
    ((30, 41), (30, 1), None),
    ((30, 41), (1, 41), None),
    ((17, 131), (4, 8), (13, 100)),
    ((4, 24, 37), (6, 9), (10, 20)),  # a batch
    ((2, 64, 96), (20, 32), None),
    ((1, 9, 258), (3, 255), None),
]


@pytest.mark.parametrize("shape,tshape,plant", MATCH_CASES)
def test_match_template_matches_jax(shape, tshape, plant):
    img = _frames(shape, sum(shape) + sum(tshape))
    tmpl = _frames(tshape, 7 * sum(tshape))
    if plant is not None:
        y, x = plant
        tmpl = img[..., y:y + tshape[0], x:x + tshape[1]].reshape(-1, *tshape)[0].copy()
    got = gt.match_template(img, tmpl)
    want = gs.match_template(img, tmpl)
    _eq(got, want)
    frames = torch.from_numpy(img.reshape(-1, *shape[-2:]))
    _eq(K.match_template_plain(frames, torch.from_numpy(tmpl)),
        np.asarray(want).reshape(-1, *got.shape[-2:]))
    for a, b in zip(gt.find_best_match(got), gs.find_best_match(want)):
        _eq(a, b)
    if plant is not None:
        first = got.reshape(-1, *got.shape[-2:])[0]
        assert int(first[plant]) == 255


@pytest.mark.parametrize("name", ["ties", "all_zero", "batched_ties", "last_pixel"])
def test_find_best_match_tie_break_matches_jax(name):
    rng = np.random.default_rng(11)
    if name == "ties":
        m = rng.integers(0, 50, (20, 30), dtype=np.uint8)
        m[[3, 3, 7, 19], [29, 4, 0, 5]] = 200  # the first in raster order is (4, 3)
    elif name == "all_zero":
        m = np.zeros((13, 9), np.uint8)
    elif name == "batched_ties":
        m = rng.integers(0, 4, (2, 3, 17, 23), dtype=np.uint8)  # every map full of ties
    else:
        m = np.zeros((6, 7), np.uint8)
        m[5, 6] = 1
    got = gt.find_best_match(m)
    want = gs.find_best_match(m)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        _eq(a, b)
    if name == "all_zero":
        assert (int(got[0]), int(got[1])) == (0, 0)


@pytest.mark.parametrize("ishape,tshape", [((10, 12), (11, 3)), ((10, 12), (3, 13)),
                                           ((2, 10, 12), (10, 13)), ((10, 70000), (4, 16513)),
                                           ((5, 5), (0, 3))])
def test_match_template_raises_as_jax(ishape, tshape):
    img = np.zeros(ishape, np.uint8)
    tmpl = np.zeros(tshape, np.uint8)
    with pytest.raises(ValueError):
        gs.match_template(img, tmpl)
    before = K.launch_counts()
    with pytest.raises(ValueError):
        gt.match_template(img, tmpl)
    assert K.launch_counts() == before


def test_match_template_at_the_pixel_limit_on_cpu():
    """9 x 7339 = 66,051 pixels, the largest exact template; 66,052 raises."""
    img = _frames((12, 7345), 3)
    tmpl = _frames((9, 7339), 4)
    got = gt.match_template(img, tmpl)
    _eq(got, gs.match_template(img, tmpl))
    with pytest.raises(ValueError, match="66051"):
        gt.match_template(np.zeros((10, 16513), np.uint8), np.zeros((4, 16513), np.uint8))


def test_match_template_golden():
    g = np.load(os.path.join(REPO, "tests", "golden", "goldens.npz"))
    _eq(gt.match_template(g["input"], g["tmpl"]), g["match_template"])


@pytest.fixture(scope="module")
def cpu8():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return devs[:8]


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 4), (1, 8)])
def test_match_template_sharded_matches_jax(cpu8, mesh_shape):
    """16-row shards; templates shorter than, as tall as and taller than a
    shard (a multi-hop bottom halo), as ``tests/test_parallel.py`` runs JAX's."""
    rng = np.random.default_rng(sum(mesh_shape))
    n, h = mesh_shape[0], 16 * mesh_shape[1]
    imgs = rng.integers(0, 256, (n, h, 96), dtype=np.uint8)
    jmesh = jax_make_mesh(mesh_shape, devices=cpu8[:int(np.prod(mesh_shape))])
    mesh = tp.make_mesh(mesh_shape, devices=["cpu"] * int(np.prod(mesh_shape)))
    for th, tw in ((5, 7), (16, 16), (40, 24)):
        tmpl = rng.integers(0, 256, (th, tw), dtype=np.uint8)
        got = tp.match_template_sharded(imgs, tmpl, mesh)
        want = jax_match_template_sharded(imgs, tmpl, jmesh)
        _eq(got, want, f"tmpl {th}x{tw}")
        _eq(got, gs.match_template(imgs, tmpl), f"tmpl {th}x{tw} against the single device")
    got = tp.match_template_sharded(imgs, imgs[0, 20:33, 10:30], mesh)
    assert int(got[0, 20, 10]) == 255


@pytest.mark.parametrize("shape,tshape,mesh_shape", [((3, 64, 96), (5, 7), (2, 4)),
                                                     ((2, 62, 96), (5, 7), (1, 4)),
                                                     ((2, 64, 96), (65, 7), (1, 4)),
                                                     ((2, 64, 96), (9, 97), (1, 4)),
                                                     ((2, 64, 80), (257, 258), (1, 4))])
def test_match_template_sharded_raises_as_jax(cpu8, shape, tshape, mesh_shape):
    imgs = np.zeros(shape, np.uint8)
    tmpl = np.zeros(tshape, np.uint8)
    jmesh = jax_make_mesh(mesh_shape, devices=cpu8[:int(np.prod(mesh_shape))])
    mesh = tp.make_mesh(mesh_shape, devices=["cpu"] * int(np.prod(mesh_shape)))
    with pytest.raises(ValueError):
        jax_match_template_sharded(imgs, tmpl, jmesh)
    with pytest.raises(ValueError):
        tp.match_template_sharded(imgs, tmpl, mesh)


def k19_replay(batch: np.ndarray, offset: int, tmpl: np.ndarray, stage_bytes=K19_STAGE_BYTES):
    """``csrc/template.cu`` in numpy: the batch at byte ``offset`` of a buffer
    read as aligned little-endian words, a word index clamped to the last word
    that holds a batch byte; a thread's tile of K19_ROWS x K19_COLS placements,
    each frame row's words funnel-shifted once to its 4 columns and used for
    each of its rows y + j against template row i - j (rows with no template
    row masked), |a - t| of each byte and the squares summed four at a time
    (``__vabsdiffu4``, ``__dp4a``), the last template word masked; the
    template staged ``stage_bytes`` at a time in rows padded to whole words."""
    n, h, w = batch.shape
    th, tw = tmpl.shape
    rh, rw = h - th + 1, w - tw + 1
    kw = (tw + 3) // 4
    buf = np.zeros(offset + batch.size + 8, np.uint8)
    buf[offset:offset + batch.size] = batch.reshape(-1)
    words = buf[:(len(buf) // 4) * 4].view("<u4").astype(np.uint64)
    last_word = (offset + batch.size - 1) // 4
    padded = np.zeros((th, kw * 4), np.uint8)
    padded[:, :tw] = tmpl
    twords = padded.view("<u4").astype(np.uint64)  # (th, kw)
    tail = (1 << (8 * (tw % 4))) - 1 if tw % 4 else 0xFFFFFFFF
    chunk = min(th, stage_bytes // (4 * kw))
    # one thread a tile: rows y .. y + K19_ROWS - 1, columns x0 .. x0 + K19_COLS - 1
    f, y, x0 = np.meshgrid(np.arange(n), np.arange(0, rh, K19_ROWS), np.arange(0, rw, K19_COLS),
                           indexing="ij")
    acc = np.zeros((K19_ROWS, K19_COLS) + f.shape, np.uint64)
    u64 = np.uint64

    def funnel(lo, hi, s):
        return ((hi << u64(32) | lo) >> np.asarray(s, np.uint64)) & u64(0xFFFFFFFF)

    def square_sum(a, t, mask):
        d = np.zeros_like(a)
        byte = [u64(8 * b) for b in range(4)]
        for b in byte:
            ab, tb = (a >> b) & u64(255), (t >> b) & u64(255)
            d |= np.where(ab > tb, ab - tb, tb - ab) << b
        d &= mask
        return sum(((d >> b) & u64(255)) ** 2 for b in byte)

    for c0 in range(0, th, chunk):
        c1 = min(th, c0 + chunk)
        for i in range(c0, c1 + K19_ROWS - 1):
            keep = [(c0 <= i - j < c1) & (y + j < rh) for j in range(K19_ROWS)]
            any_row = np.logical_or.reduce(keep)
            # a tile none of whose rows takes this frame row reads nothing
            addr = offset + (f * h + np.where(any_row, y + i, 0)) * w + x0
            base, shift = addr // 4, (addr % 4) * 8  # int64 word index, bits

            def word(k):
                return words[np.minimum(base + k, last_word)]

            lo, hi = word(0), word(1)
            cur = funnel(lo, hi, shift)
            for k in range(kw):
                lo, hi = hi, word(k + 2)
                nxt = funnel(lo, hi, shift)
                mask = u64(0xFFFFFFFF if k + 1 < kw else tail)
                cols = [cur if p == 0 else funnel(cur, nxt, 8 * p) for p in range(K19_COLS)]
                for j in range(K19_ROWS):
                    t = twords[min(max(i - j, 0), th - 1), k]
                    m = np.where(keep[j], mask, u64(0))
                    for p in range(K19_COLS):
                        acc[j, p] += square_sum(cols[p], t, m)
                cur = nxt
    out = np.zeros((n, rh, rw), np.uint8)
    for j in range(K19_ROWS):
        for p in range(K19_COLS):
            rows, cols = y + j, x0 + p
            live = (rows < rh) & (cols < rw)
            out[f[live], rows[live], cols[live]] = 255 - acc[j, p][live] // (255 * th * tw)
    return out


@pytest.mark.parametrize("shape,tshape,offset,stage", [
    ((2, 9, 33), (3, 5), 0, K19_STAGE_BYTES), ((1, 30, 41), (30, 41), 3, K19_STAGE_BYTES),
    ((3, 17, 31), (4, 8), 1, K19_STAGE_BYTES), ((1, 11, 40), (1, 1), 2, K19_STAGE_BYTES),
    ((2, 12, 21), (5, 6), 1, 40),  # staged two template rows at a time
    ((1, 20, 23), (7, 2), 3, 8),  # one row at a time
    ((2, 23, 19), (9, 3), 2, 36)])  # three rows at a time, row tiles past the last placement
def test_k19_word_replay_matches_plain(shape, tshape, offset, stage):
    rng = np.random.default_rng(sum(shape) + offset)
    batch = rng.integers(0, 256, shape, dtype=np.uint8)
    tmpl = rng.integers(0, 256, tshape, dtype=np.uint8)
    want = K.match_template_plain(torch.from_numpy(batch), torch.from_numpy(tmpl)).numpy()
    np.testing.assert_array_equal(k19_replay(batch, offset, tmpl, stage), want)


def _k19_const(name):
    return int(re.search(rf"constexpr int {name} = (-?\d+);", _TEMPLATE_SOURCE).group(1))


# csrc/template.cu's tensor-core design
K19_MMA = {name: _k19_const(name) for name in ("kMmaMinWidth", "kMmaMaxWidth", "kMmaQ", "kMmaR",
                                                "kMmaWarpsX", "kMmaWarpsY", "kPadLeft")}
K19_MMA_STAGE_BYTES = 64 * 1024
assert f"kMmaStageBytes = {K19_MMA_STAGE_BYTES // 1024} * 1024" in _TEMPLATE_SOURCE
K19_AWORD = tuple(int(v) for v in
                  re.search(r"kAWord\[4\] = \{([^}]*)\}", _TEMPLATE_SOURCE).group(1).split(","))
MASK32 = 0xFFFFFFFF


def _bytes_of(words):
    """(..., 4) little-endian bytes of int64 32-bit words."""
    return (words[..., None] >> (8 * np.arange(4))) & 255


def k19_mma_replay(batch: np.ndarray, offset: int, tmpl: np.ndarray):
    """``csrc/template.cu``'s tensor-core design in numpy, lane by lane.  The
    template rows staged in 4 copies shifted by 0-3 bytes (``kPadLeft`` zero
    bytes before a row, pitch ``copy_words``: the last A word a lane reads, 8
    mod 16) and the band's frame rows beside
    them, in chunks of template rows that fit ``kMmaStageBytes``; a lane's A
    registers read at its word and the ``kAWord`` offsets of tile ``u - q``;
    its B registers the staged words of row ``yw + 8 r + g + i`` at column
    ``16 u + 4 t`` (+ 16), each the frame's 4 bytes there from aligned words
    (an index clamped to the batch's last word) at byte ``offset`` of a
    buffer; the m16n8k32 fragments assembled into A (16 x 32) and B (32 x 8)
    and multiplied in int64, the sums wrapped mod 2^32 as s32 sums do; the
    epilogue's lane (g, t) value e at row ``2 t + (e & 1)``, column ``g + 8 (e
    >> 1)`` of its tile.  win(I^2) by the band's column sums over th rows,
    added chunk by chunk, and runs of kRunCols columns, in uint32; ssd = win -
    2 corr + sum T^2 mod 2^32, divided by 255 th tw by a multiply-high and
    shifts (``udiv``)."""
    n, h, w = batch.shape
    th, tw = tmpl.shape
    rh, rw = h - th + 1, w - tw + 1
    q_tiles, r_tiles = K19_MMA["kMmaQ"], K19_MMA["kMmaR"]
    wx, wy = K19_MMA["kMmaWarpsX"], K19_MMA["kMmaWarpsY"]
    pad_left = K19_MMA["kPadLeft"]
    band_cols, band_rows = 16 * q_tiles * wx, 8 * r_tiles * wy
    threads = 32 * wx * wy
    run_cols = band_cols // (threads // band_rows)
    smax = (tw + 14) // 16
    cw = max(4 * smax + 16, (pad_left + tw + 3) // 4)
    cw += ((8 - cw % 16) + 16) % 16
    fp = 4 * (q_tiles * (wx - 1) + q_tiles + 1 + smax) | 4  # the staged frame rows' pitch
    chunk_rows = min(th, (K19_MMA_STAGE_BYTES // 4 - (band_rows - 1) * fp) // (4 * cw + fp))
    # the batch as the kernel reads it
    buf = np.zeros(offset + batch.size + 8, np.uint8)
    buf[offset:offset + batch.size] = batch.reshape(-1)
    words = buf[:len(buf) // 4 * 4].view("<u4").astype(np.int64)
    last = (offset + batch.size - 1) // 4

    def frame_word(addr):
        lo = np.minimum(addr // 4, last)
        hi = np.minimum(addr // 4 + 1, last)
        return ((words[hi] << 32 | words[lo]) >> ((addr % 4) * 8)) & MASK32

    # the staged rows: copy c, word x holds bytes P[4 x + c .. + 3]
    padded = np.zeros((th, max(4 * cw + 8, pad_left + tw)), np.int64)
    padded[:, pad_left:pad_left + tw] = tmpl
    x4 = 4 * np.arange(cw)
    staged = np.stack([sum(padded[:, x4 + c + b] << (8 * b) for b in range(4)) for c in range(4)],
                      axis=1).reshape(th, 4 * cw)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    lane_word = ((pad_left - g) & 3) * cw + t + ((pad_left - g) >> 2)
    # every warp of every band: its frame and first placement row and column
    col_bands, row_bands = -(-rw // band_cols), -(-rh // band_rows)
    f, rb, cb, wi = (a.reshape(-1) for a in np.meshgrid(np.arange(n), np.arange(row_bands),
                                                        np.arange(col_bands),
                                                        np.arange(wx * wy), indexing="ij"))
    yw = rb * band_rows + wi // wx * 8 * r_tiles
    xw = cb * band_cols + wi % wx * 16 * q_tiles
    acc = np.zeros((len(f), r_tiles, q_tiles, 16, 8), np.int64)
    for c0 in range(0, th, chunk_rows):
        chunk = staged[c0:min(th, c0 + chunk_rows)]
        for i in range(c0, min(th, c0 + chunk_rows)):
            srow = chunk[i - c0]
            rows = [offset + ((f * h + yw + 8 * r + i)[:, None] + g) * w + xw[:, None] + 4 * t
                    for r in range(r_tiles)]
            for u in range(0, q_tiles + smax, 2):
                b_mat = []
                for r in range(r_tiles):
                    b = np.zeros((len(f), 32, 8), np.int64)  # B[k, n]
                    for half in range(2):
                        v = _bytes_of(frame_word(rows[r] + 16 * u + 16 * half))  # (warps, lane, 4)
                        b[:, 16 * half + 4 * t[:, None] + np.arange(4), g[:, None]] = v
                    b_mat.append(b)
                for q in range(q_tiles):
                    sq = u - q
                    if sq < -1 or sq > smax:
                        continue
                    a_reg = [_bytes_of(srow[lane_word + 4 * sq + K19_AWORD[k]]) for k in range(4)]
                    a_mat = np.zeros((16, 32), np.int64)
                    for k, (dm, dk) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
                        a_mat[g[:, None] + dm, dk + 4 * t[:, None] + np.arange(4)] = a_reg[k]
                    for r in range(r_tiles):
                        acc[:, r, q] += np.einsum("mk,wkn->wmn", a_mat, b_mat[r])
    acc &= MASK32  # the s32 sums wrapped
    sum_t2 = int((tmpl.astype(np.int64) ** 2).sum()) & MASK32
    div = 255 * th * tw
    shift = (div - 1).bit_length()  # udiv_magic
    magic = ((1 << 32) * ((1 << shift) - div)) // div + 1
    out = np.full((n, rh, rw), -1, np.int64)
    squares = batch.astype(np.int64) ** 2
    win = {}
    for band in {(int(a), int(b), int(c)) for a, b, c in zip(f, rb, cb)}:
        fb, y0, x0 = band[0], band[1] * band_rows, band[2] * band_cols
        rows_b, cols = min(band_rows, rh - y0), min(band_cols + tw - 1, w - x0)
        vs = np.zeros((rows_b, cols), np.int64)
        v = squares[fb, y0:y0 + th, x0:x0 + cols].sum(0)
        vs[0] = v
        for yy in range(1, rows_b):
            v = (v + squares[fb, y0 + yy + th - 1, x0:x0 + cols]
                 - squares[fb, y0 + yy - 1, x0:x0 + cols])
            vs[yy] = v
        ws = np.full((band_rows, band_cols), -1, np.int64)  # a placement no run covers stays wrong
        for xa in range(0, band_cols, run_cols):
            xb = min(xa + run_cols, rw - x0)
            for x in range(xa, xb):
                ws[:rows_b, x] = vs[:, x:x + tw].sum(1)
        win[band] = ws & MASK32
    for k in range(len(f)):
        band = (int(f[k]), int(rb[k]), int(cb[k]))
        for r in range(r_tiles):
            for q in range(q_tiles):
                for e in range(4):  # lane (g, t)'s value e
                    y = yw[k] + 8 * r + 2 * t + (e & 1)
                    x = xw[k] + 16 * q + g + 8 * (e >> 1)
                    live = (y < rh) & (x < rw)
                    c = acc[k, r, q, g + 8 * (e >> 1), 2 * t + (e & 1)]
                    ws = win[band][y[live] - band[1] * band_rows, x[live] - band[2] * band_cols]
                    ssd = (ws - 2 * c[live] + sum_t2) & MASK32
                    hi = (ssd.astype(np.uint64) * np.uint64(magic)) >> np.uint64(32)
                    hi = hi.astype(np.int64)
                    out[f[k], y[live], x[live]] = 255 - ((hi + ((ssd - hi) >> 1)) >> (shift - 1))
    assert (out >= 0).all()  # every placement written
    return out.astype(np.uint8)


@pytest.mark.parametrize("shape,tshape,offset,fill", [
    ((2, 9, 40), (3, 1), 0, None),  # tw = 1: 1 of the 32 columns of a chunk used
    ((1, 20, 200), (5, 31), 1, None), ((2, 33, 170), (7, 32), 3, None),
    ((1, 30, 150), (4, 33), 2, None),
    ((3, 12, 45), (5, 17), 1, None),  # a chunk's 32 columns straddle each row end
    ((1, 80, 240), (70, 200), 3, None),  # the template staged in two chunks of rows
    ((1, 260, 300), (257, 257), 1, (255, 255)),  # the limit: the correlation passes 2^31
    ((1, 260, 300), (257, 257), 3, (255, 0))])  # the largest SSD
def test_k19_mma_replay_matches_plain(shape, tshape, offset, fill):
    rng = np.random.default_rng(sum(shape) + offset)
    if fill is None:
        batch = rng.integers(0, 256, shape, dtype=np.uint8)
        tmpl = rng.integers(0, 256, tshape, dtype=np.uint8)
    else:
        batch, tmpl = np.full(shape, fill[0], np.uint8), np.full(tshape, fill[1], np.uint8)
    assert tshape[1] <= K19_MMA["kMmaMaxWidth"]
    got = k19_mma_replay(batch, offset, tmpl)
    want = K.match_template_plain(torch.from_numpy(batch), torch.from_numpy(tmpl)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(gs.match_template(batch, tmpl)))
    if fill == (255, 255):
        assert tshape[0] * tshape[1] * 255 * 255 >= 2**31 and (got == 255).all()
    if fill == (255, 0):
        assert (got == 0).all()
