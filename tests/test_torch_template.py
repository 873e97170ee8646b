"""The port's template matching against ``grayskull_tpu``'s, on the CPU.

K19's plain version ``match_template_plain``, ``match_template``,
``find_best_match`` and ``parallel.match_template_sharded`` are held, with
tolerance 0 (every output is an integer), to the JAX functions on the same
inputs (random frames and templates made with numpy from a seed, maps of ties,
the ``match_template`` golden).  The JAX sharded version runs on the 8 virtual
CPU devices of ``tests/conftest.py``; the port's mesh names the CPU device as
many times.  K19's word layout (``csrc/template.cu``) is replayed in numpy and
held to the plain version.
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
