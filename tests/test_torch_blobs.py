"""The port's connected components against ``grayskull_tpu``'s, on the CPU.

K9's plain version ``ccl_plain``, ``label_components``, ``blobs`` and
``blob_corners`` are held, with tolerance 0 (every output is an integer), to
the JAX functions on the same inputs (random frames made with numpy from a
seed, the adversarial frames of ``tests/test_blobs_contour.py`` and the
binarized ``document.pgm``), to the JAX Pallas kernel ``ccl_serpentine`` in
interpret mode, and to the goldens ``blobs_*`` and ``multiblob_*``.  K9's
tiled decomposition (``csrc/ccl.cu``) is replayed in numpy and held to the
same references.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grayskull_tpu_torch as gt
from grayskull_tpu.kernels.ccl import ccl_serpentine
from grayskull_tpu.ops.blobs import blob_corners as jax_blob_corners
from grayskull_tpu.ops.blobs import blobs as jax_blobs
from grayskull_tpu.ops.blobs import label_components as jax_label_components
from grayskull_tpu.pipelines.scan import preprocess_binarize as jax_preprocess_binarize
from grayskull_tpu.pipelines.scan import scan as jax_scan
from grayskull_tpu_torch import kernels as K
from grayskull_tpu_torch.core import blobs_from_arrays
from tests.test_torch_cuda import (BLOB_STATS_CASES, blob_stats_case,  # noqa: F401
                                   host_arrays_on_cpu, snake, spiral)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "tests", "golden", "testdata")
DENSITIES = (0.3, 0.55, 0.6)  # 0.6 is near the site-percolation threshold
with open(os.path.join(REPO, "grayskull_tpu_torch", "csrc", "ccl.cu")) as _f:
    _CCL_SOURCE = _f.read()
# K9's committed tile (kTileH x kTileW), and one small enough that components
# cross many tile borders
CCL_TILES = [tuple(int(re.search(rf"constexpr int {name} = (\d+);", _CCL_SOURCE).group(1))
                   for name in ("kTileH", "kTileW")), (4, 16)]


def _random(shape, density, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) < density) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def document_binary():
    doc = gt.io.read_pgm(os.path.join(TESTDATA, "document.pgm"))
    return np.asarray(jax_preprocess_binarize(jnp.asarray(doc)))


@pytest.fixture(scope="module")
def goldens():
    return np.load(os.path.join(REPO, "tests", "golden", "goldens.npz"))


def _ccl(img):
    return K.ccl_plain(torch.from_numpy(img[None].copy()))[0].numpy()


@pytest.mark.parametrize("name", ["snake", "noise", "spiral"])
def test_ccl_plain_matches_serpentine_kernel(name):
    img = {"snake": snake, "noise": lambda: _random((16, 128), 0.45, 7),
           "spiral": lambda: spiral(40, 128)}[name]()
    h, w = img.shape
    fg = img >= 128
    big = 2**30
    l0 = np.full((-(-h // 8) * 8, -(-w // 128) * 128), big, np.int32)
    l0[:h, :w] = np.where(fg, np.arange(h * w, dtype=np.int32).reshape(h, w), big)
    fixpoint, _ = ccl_serpentine(jnp.asarray(l0[None]), interpret=True)
    want = np.where(fg, np.asarray(fixpoint)[0, :h, :w], -1)
    np.testing.assert_array_equal(_ccl(img), want)
    np.testing.assert_array_equal(gt.label_components(img).numpy(), want)


@pytest.mark.parametrize("shape", [(1, 300), (300, 1), (7, 8), (17, 129), (64, 96)])
def test_ccl_plain_matches_label_components(shape):
    for i, density in enumerate(DENSITIES):
        img = _random(shape, density, 10 + i)
        want = np.asarray(jax_label_components(img))
        np.testing.assert_array_equal(_ccl(img), want, err_msg=f"{shape}@{density}")
        got = gt.label_components(img)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_ccl_document_and_batch(document_binary):
    want = np.asarray(jax_label_components(document_binary))
    np.testing.assert_array_equal(_ccl(document_binary), want)
    frames = np.stack([document_binary, document_binary[::-1].copy(), np.zeros_like(want, np.uint8)])
    got = gt.label_components(frames, force_reference=True).numpy()
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], np.asarray(jax_label_components(frames[1])))
    assert (got[2] == -1).all()


def _chunk_masks(frame, tile_h, tile_w):
    """K9's 16-bit foreground masks of every 16 pixels of each row of the frame
    padded with background to whole tiles, by the 4-byte word trick of the
    16-byte-load path: bit 7 of byte b of ``v & 0x80808080`` moves to bit 28 + b
    of ``v * 0x00204081``.  Held to the byte path's masks."""
    h, w = frame.shape
    hp, wp = -(-h // tile_h) * tile_h, -(-w // tile_w) * tile_w
    pad = np.zeros((hp, wp), np.uint8)
    pad[:h, :w] = frame
    words = pad.view("<u4").astype(np.uint64)
    nib = (((words & 0x80808080) * 0x00204081) & 0xFFFFFFFF) >> 28
    nib = nib.reshape(hp, wp // 16, 4).astype(np.int64)
    masks = nib[..., 0] | nib[..., 1] << 4 | nib[..., 2] << 8 | nib[..., 3] << 12
    by_bytes = ((pad >= 128).reshape(hp, wp // 16, 16) << np.arange(16)).sum(-1)
    np.testing.assert_array_equal(masks, by_bytes)
    return masks


def _run_start(row, c):
    """``run_start``: one past the highest background bit left of column c."""
    j = c // 16
    z = ~row[j] & ((1 << (c % 16)) - 1) & 0xFFFF
    while z == 0:
        j -= 1
        if j < 0:
            return 0
        z = ~row[j] & 0xFFFF
    return j * 16 + int(z).bit_length()  # 32 - __clz(z)


def _find(parent, p):
    """``find_root`` with path halving, on a dict or an array of links."""
    cur = parent[p]
    if cur == p:
        return p
    prev = p
    while cur > (nxt := parent[cur]):
        parent[prev] = nxt
        prev, cur = cur, nxt
    return cur


def _unite(parent, a, b):
    ra, rb = _find(parent, parent[a]), _find(parent, parent[b])  # a and b keep their links
    if ra != rb:  # one thread at a time: the atomicCAS hook always lands
        parent[max(ra, rb)] = min(ra, rb)


def _ccl_replay(frame, tile_h, tile_w):
    """``csrc/ccl.cu`` in numpy on one frame: the tile pass (run starts and
    overlap segments by bit tricks on the 16-bit masks, a union-find of tile
    indices, pointer jumping over the run starts, each pixel's tile root as a
    frame raster index), the border unions in the frame's labels, and the
    flatten by run pieces of 16-pixel chunks, each judged by its last pixel's
    link."""
    h, w = frame.shape
    masks = _chunk_masks(frame, tile_h, tile_w)
    chunks = tile_w // 16
    q = np.arange(masks.shape[1])[None, :]
    r = np.arange(masks.shape[0])[:, None]
    left = np.where(q % chunks > 0, np.roll(masks, 1, axis=1) >> 15, 0)
    up = np.where(r % tile_h > 0, np.roll(masks, 1, axis=0), 0)
    up_left = np.where((q % chunks > 0) & (r % tile_h > 0), np.roll(up, 1, axis=1) >> 15, 0)
    starts = masks & ~((masks << 1) | left) & 0xFFFF
    ov = masks & up
    segs = ov & ~((ov << 1) | (left & up_left)) & 0xFFFF
    label = np.full(h * w, -1, np.int64)
    for ty in range(0, masks.shape[0], tile_h):
        for tx in range(0, masks.shape[1] * 16, tile_w):
            bits = masks[ty:ty + tile_h, tx // 16:tx // 16 + chunks]
            if not bits.any():
                continue
            parent = {}  # tile index rr * tile_w + c
            for rr, qq in zip(*np.nonzero(starts[ty:ty + tile_h, tx // 16:tx // 16 + chunks])):
                m = int(starts[ty + rr, tx // 16 + qq])
                for i in range(16):
                    if m >> i & 1:
                        parent[rr * tile_w + qq * 16 + i] = rr * tile_w + qq * 16 + i
            for rr, qq in zip(*np.nonzero(segs[ty:ty + tile_h, tx // 16:tx // 16 + chunks])):
                m = int(segs[ty + rr, tx // 16 + qq])
                for i in range(16):
                    if m >> i & 1:
                        c = qq * 16 + i
                        _unite(parent, rr * tile_w + _run_start(bits[rr], c),
                               (rr - 1) * tile_w + _run_start(bits[rr - 1], c))
            jumped = True
            while jumped:  # rounds of parent[s] = parent[parent[s]] over the run starts
                jumped = False
                for s_ in list(parent):
                    up = parent[s_]
                    if parent[up] != up:
                        parent[s_] = parent[up]
                        jumped = True
            for rr, qq in zip(*np.nonzero(bits)):
                m = int(bits[rr, qq])
                for i in range(16):
                    if m >> i & 1:
                        c = qq * 16 + i
                        lr = parent[rr * tile_w + _run_start(bits[rr], c)]
                        label[(ty + rr) * w + tx + c] = (ty + lr // tile_w) * w + tx + lr % tile_w
    fg = (frame >= 128).ravel()
    for ty in range(0, h, tile_h):
        for tx in range(0, w, tile_w):
            pairs = []
            if ty > 0:
                pairs += [(ty * w + x, ty * w + x - w) for x in range(tx, min(tx + tile_w, w))]
            if tx > 0:
                pairs += [(y * w + tx, y * w + tx - 1) for y in range(ty, min(ty + tile_h, h))]
            for p, nb in pairs:
                if fg[p] and fg[nb]:
                    _unite(label, p, nb)
    for ty in range(0, h, tile_h):
        for tx in range(0, w, tile_w):
            for yy, qq in zip(*np.nonzero(masks[ty:ty + tile_h, tx // 16:tx // 16 + chunks])):
                m = int(masks[ty + yy, tx // 16 + qq])
                pieces = m & ~(m << 1)
                while pieces:
                    i0 = (pieces & -pieces).bit_length() - 1
                    pieces &= pieces - 1
                    run = m >> i0
                    length = ((~run) & -(~run)).bit_length() - 1  # __ffs(~run) - 1
                    p = (ty + yy) * w + tx + qq * 16 + i0
                    link = label[p + length - 1]
                    root = label[link]
                    if root == link:
                        continue
                    while label[root] != root:  # a walk that writes nothing
                        root = label[root]
                    label[p:p + length] = root
    return label.reshape(h, w).astype(np.int32)


def _ccl_replay_cases(document_binary):
    rng = np.random.default_rng(31)
    th, tw = CCL_TILES[0]
    cases = {"snake": snake(), "spiral": spiral(40, 128),
             "all foreground": np.full((70, 300), 255, np.uint8),
             "empty": np.zeros((33, 129), np.uint8),
             "1x300": _random((1, 300), 0.6, 32), "300x1": _random((300, 1), 0.6, 33),
             "one past a tile": _random((th + 1, tw + 1), 0.55, 34),
             "document": document_binary}
    for i, d in enumerate(DENSITIES):
        cases[f"density {d}"] = _random((40, 200), d, 35 + i)
    return cases


@pytest.mark.parametrize("tile", CCL_TILES)
@pytest.mark.parametrize("case", ["snake", "spiral", "density 0.3", "density 0.55", "density 0.6",
                                  "all foreground", "empty", "1x300", "300x1", "one past a tile",
                                  "document"])
def test_ccl_tile_decomposition_replayed(document_binary, tile, case):
    """K9's tiles, border unions and flatten, replayed,
    equal ``ccl_plain``, JAX ``label_components`` and, on the snake and the
    spiral, ``ccl_serpentine`` in interpret mode."""
    img = _ccl_replay_cases(document_binary)[case]
    want = _ccl(img)
    np.testing.assert_array_equal(want, np.asarray(jax_label_components(img)))
    if case in ("snake", "spiral"):
        h, w = img.shape
        l0 = np.full((-(-h // 8) * 8, -(-w // 128) * 128), 2**30, np.int32)
        l0[:h, :w] = np.where(img >= 128, np.arange(h * w, dtype=np.int32).reshape(h, w), 2**30)
        fixpoint, _ = ccl_serpentine(jnp.asarray(l0[None]), interpret=True)
        np.testing.assert_array_equal(want, np.where(img >= 128, np.asarray(fixpoint)[0, :h, :w], -1))
    np.testing.assert_array_equal(_ccl_replay(img, *tile), want, err_msg=f"{case} tile {tile}")


def test_ccl_wrapper_checks_its_input():
    with pytest.raises(TypeError):
        K.ccl(torch.zeros((1, 4, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        K.ccl(torch.zeros((4, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        K.ccl(torch.zeros((1, 4, 8), dtype=torch.uint8)[:, :, ::2])


def _same_table(port, ref_table, msg=""):
    ref = blobs_from_arrays(ref_table)
    for name, a, b in zip(port._fields, port, ref):
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        for x, y in pairs:
            assert x.dtype == torch.int32, (msg, name)
            np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=f"{msg} {name}")


def _same_blobs(img, cap, msg=""):
    table, labels, overflowed = gt.blobs(img, cap)
    jt, jl, jo = jax_blobs(img, cap)
    _same_table(table, jt, msg)
    assert labels.dtype == torch.uint16
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl), err_msg=f"{msg} label map")
    assert bool(overflowed) == bool(jo), msg
    return table, labels, overflowed


@pytest.mark.parametrize("shape", [(1, 40), (40, 1), (7, 8), (17, 129), (64, 96)])
def test_blobs_match_jax(shape):
    for i, density in enumerate(DENSITIES):
        img = _random(shape, density, 20 + i)
        _same_blobs(img, 4000, f"{shape}@{density}")
        _same_blobs(img, 3, f"{shape}@{density} cap 3")  # fewer labels than seeds


def test_blobs_document(document_binary):
    table, _, _ = _same_blobs(document_binary, 1000, "document")
    assert int(table.n) > 100


def test_blobs_goldens(goldens):
    for key, cap in (("blobs", 500), ("multiblob", 64)):
        table, labels, _ = gt.blobs(goldens[f"{key}_input"], cap)
        n = int(table.n)
        assert n == len(goldens[f"{key}_label"])
        np.testing.assert_array_equal(labels.numpy(), goldens[f"{key}_labels"])
        np.testing.assert_array_equal(table.label[:n].numpy(), goldens[f"{key}_label"])
        np.testing.assert_array_equal(table.area[:n].numpy(), goldens[f"{key}_area"])
        box = torch.stack([v[:n] for v in table.box], 1).numpy()
        np.testing.assert_array_equal(box, goldens[f"{key}_box"].astype(np.int64))
        cen = torch.stack([v[:n] for v in table.centroid], 1).numpy()
        np.testing.assert_array_equal(cen, goldens[f"{key}_centroid"].astype(np.int64))


def test_blobs_past_capacity_is_flagged():
    """``tests/test_blobs_contour.py:324-328``: a column seeded past capacity
    reconnects to component 1; like the JAX package, the port merges it fully
    and flags the overflow (C drops those pixels)."""
    img = np.zeros((6, 12), np.uint8)
    img[0:4, 0] = 255
    img[3, 0:9] = 255
    img[0, 4] = 255
    img[0:3, 8] = 255
    table, labels, overflowed = _same_blobs(img, 2, "past capacity")
    assert bool(overflowed) and int(table.n) == 2
    assert table.label[:2].tolist() == [1, 2] and table.area[:2].tolist() == [15, 1]
    assert int(labels.to(torch.int32).max()) == 2


def test_blobs_edge_cases():
    empty = np.zeros((4, 5), np.uint8)
    table, labels, overflowed = _same_blobs(empty, 5, "empty")
    assert int(table.n) == 0 and int(labels.to(torch.int32).max()) == 0 and not bool(overflowed)
    dot = np.zeros((3, 3), np.uint8)
    dot[1, 1] = 255
    table, _, _ = _same_blobs(dot, 5, "one pixel")
    assert (int(table.n), table.label[0].item(), table.area[0].item()) == (1, 1, 1)
    assert [v[0].item() for v in table.box] == [1, 1, 1, 1]
    checker = (np.indices((6, 7)).sum(0) % 2 * 255).astype(np.uint8)  # 21 one-pixel blobs
    table, labels, overflowed = _same_blobs(checker, 4, "cap below the seeds")
    assert bool(overflowed) and int(table.n) == 4 and int(labels.to(torch.int32).max()) == 4
    with pytest.raises(ValueError):
        gt.blobs(dot, -1)


def test_blobs_capacity_zero(document_binary):
    """``max_blobs=0``: an empty table, an all-zero label map, and
    ``overflowed`` wherever a frame has a seed, as the JAX op returns."""
    img = np.zeros((4, 4), np.uint8)
    img[0, 0] = img[2, 2] = 255
    for frame, seeds in ((img, True), (np.zeros((4, 5), np.uint8), False),
                         (document_binary, True)):
        table, labels, overflowed = _same_blobs(frame, 0, f"capacity 0, seeds={seeds}")
        assert int(table.n) == 0 and tuple(table.label.shape) == (0,)
        assert int(labels.to(torch.int32).max()) == 0 and bool(overflowed) == seeds
    table, labels, overflowed = gt.blobs(np.stack([img, np.zeros_like(img)]), 0)
    assert table.n.tolist() == [0, 0] and tuple(table.area.shape) == (2, 0)
    assert overflowed.tolist() == [True, False] and not labels.any()
    with pytest.raises(ValueError):  # the largest blob of an empty table
        jax_scan(jnp.asarray(img), out_size=(8, 8), max_blobs=0)
    with pytest.raises(ValueError):
        gt.scan(img, out_size=(8, 8), max_blobs=0)


def _leaves(table):
    return [table.n, table.label, table.area, *table.box, *table.centroid]


def test_blobs_batched_equals_per_frame():
    frames = np.stack([_random((33, 47), d, 30 + i) for i, d in enumerate(DENSITIES)])
    frames[1] = 0
    table, labels, overflowed = gt.blobs(frames, 40)
    assert tuple(table.label.shape) == (3, 40) and tuple(table.n.shape) == (3,)
    for i in range(3):
        one, one_labels, one_over = gt.blobs(frames[i], 40)
        for a, b in zip(_leaves(table), _leaves(one)):
            assert torch.equal(a[i], b), i
        assert torch.equal(labels[i], one_labels) and bool(overflowed[i]) == bool(one_over)
    ref = gt.blobs(frames, 40, force_reference=True)
    assert torch.equal(ref[1], labels)


def test_blobs_coordinate_sums_wrap_unsigned():
    """An all-255 1700x1700 frame: the x and y sums (2,455,055,000) pass 2^31,
    so C's unsigned sums divide unsigned (a signed one would go negative)."""
    img = np.full((1700, 1700), 255, np.uint8)
    table, _, _ = _same_blobs(img, 4, "1700x1700")
    assert int(table.n) == 1 and int(table.area[0]) == 1700 * 1700
    assert [int(v[0]) for v in table.centroid] == [849, 849]


def test_blob_corners_match_jax():
    img = _random((24, 32), 0.6, 40)
    table, labels, _ = gt.blobs(img, 2000)
    jt, jl, _ = jax_blobs(img, 2000)
    n = int(table.n)
    box = torch.stack(list(table.box), 1)
    cen = torch.stack(list(table.centroid), 1)
    got = gt.blob_corners(np.stack([img] * n), labels.expand(n, -1, -1), table.label[:n],
                          gt.Rect(*box[:n].T), gt.Point(*cen[:n].T))
    assert tuple(got.shape) == (n, 4, 2) and got.dtype == torch.int32
    for i in range(n):
        want = jax_blob_corners(img, jl, int(table.label[i]), gt.Rect(*box[i].tolist()),
                                gt.Point(*cen[i].tolist()))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want), err_msg=f"blob {i}")
        single = gt.blob_corners(img, labels, table.label[i], gt.Rect(*box[i]), gt.Point(*cen[i]))
        assert torch.equal(single, got[i])


def test_blob_corners_golden_and_no_pixel(goldens):
    img = goldens["multiblob_input"]
    table, labels, _ = gt.blobs(img, 64)
    big = int(table.area.argmax())
    corners = gt.blob_corners(img, labels, table.label[big], gt.Rect(*(v[big] for v in table.box)),
                              gt.Point(*(v[big] for v in table.centroid)))
    np.testing.assert_array_equal(corners.numpy(), goldens["multiblob_corners"].astype(np.int64))
    # a label with no pixel in the box: every corner is the centroid, as in C
    none = gt.blob_corners(img, labels, 999, gt.Rect(0, 0, 5, 5), gt.Point(17, 3))
    want = jax_blob_corners(img, labels.numpy(), 999, gt.Rect(0, 0, 5, 5), gt.Point(17, 3))
    np.testing.assert_array_equal(none.numpy(), np.asarray(want))
    assert none.tolist() == [[17, 3]] * 4


def _blob_stats_numpy(seg, nseg, w, row0):
    """(7, N, nseg) int64: each label's area, coordinate sums and extremes,
    label by label (label 0 left out; 2^62 and -1 where a label is empty)."""
    n, npix = seg.shape
    out = np.zeros((7, n, nseg), np.int64)
    out[3:5], out[5:] = 2**62, -1
    ys, xs = np.divmod(np.arange(npix, dtype=np.int64), w)
    ys += row0
    for f in range(n):
        order = np.argsort(seg[f], kind="stable")
        cuts = np.flatnonzero(np.diff(seg[f][order])) + 1
        for pix in np.split(order, cuts):
            label = int(seg[f, pix[0]])
            if label:
                x, y = xs[pix], ys[pix]
                out[:, f, label] = [pix.size, x.sum(), y.sum(), x.min(), y.min(), x.max(),
                                    y.max()]
    return out


@pytest.mark.parametrize("name", ["document_1", *BLOB_STATS_CASES])
def test_blob_stats_plain_matches_numpy(name):
    seg, nseg, w, row0 = blob_stats_case(name, "cpu")
    want = _blob_stats_numpy(seg.numpy(), nseg, w, row0)
    got = K.blob_stats(seg, nseg, w, row0)  # a CPU tensor: the plain version
    for k, (a, b) in enumerate(zip(got, K.blob_stats_plain(seg, nseg, w, row0))):
        assert a.dtype == torch.int64 and tuple(a.shape) == (seg.shape[0], nseg)
        assert torch.equal(a, b), k
        np.testing.assert_array_equal(a.numpy(), want[k], err_msg=f"{name} field {k}")


def test_blob_stats_path_follows_the_shared_table():
    """36 bytes a label in 227 KB of shared memory: 6456 labels fit a block."""
    assert K.blobs.path(1) == K.blobs.path(1001) == K.blobs.path(6456) == "blob_stats"
    assert K.blobs.path(6457) == K.blobs.path(7000) == "blob_stats_global"


def test_blob_stats_wrapper_checks_its_input():
    seg = torch.zeros((2, 12), dtype=torch.int32)
    with pytest.raises(TypeError):
        K.blob_stats(seg.to(torch.int64), 3, 4)
    with pytest.raises(TypeError):
        K.blob_stats(seg.numpy(), 3, 4)
    with pytest.raises(ValueError):  # rank
        K.blob_stats(seg.view(2, 3, 4), 3, 4)
    with pytest.raises(ValueError):  # rank
        K.blob_stats(seg[0], 3, 4)
    for nseg in (0, -1, 2.0, True, None):
        with pytest.raises(ValueError):
            K.blob_stats(seg, nseg, 4)
    with pytest.raises(ValueError):  # not whole rows
        K.blob_stats(seg, 3, 5)
    with pytest.raises(ValueError):
        K.blob_stats(seg, 3, 0)
    with pytest.raises(ValueError):
        K.blob_stats(seg, 3, 4, row0=-1)
    with pytest.raises(ValueError):  # rows past 2^31
        K.blob_stats(seg, 3, 4, row0=2**31 - 2)
    with pytest.raises(ValueError):
        K.blob_stats(torch.zeros((2, 24), dtype=torch.int32)[:, ::2], 3, 4)
