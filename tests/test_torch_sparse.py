"""The port's sharded sparse stages (``grayskull_tpu_torch.parallel.sparse``)
against ``grayskull_tpu.parallel.sparse``, on the CPU.

The JAX functions run on the 8 virtual CPU devices of ``tests/conftest.py``
(a (1, 4) mesh, (1, 8) for some labels and matches, and (2, 4) for faces);
the port's meshes list the CPU device as many times.  The inputs are those of
``tests/test_parallel_sparse.py`` (the serpentine spine with teeth, noise,
lena, aruco, the document and the receipt), frames made with numpy from a
seed, and shard-boundary cases: components that only a boundary joins, seeds
on a slab's first row, FAST corners on the rows around a boundary, an input
past ``max_blobs``.  Every output is an integer or a bool, angles compared by
their bits, so the tolerance is 0; ORB descriptors in the fast trig mode
follow ``tests/test_torch_orb.py``'s rule (the JAX package may contract the
rBRIEF rotation into an FMA there), and in ``exact_host`` mode they are exact.

The two slab tricks of the port are checked on their own: K6's asymmetric
slabs, whose re-based keys equal ``fast_plain``'s on the whole frame for every
shard count, and K5's band slab launched at origin row 1, whose hits equal
the whole frame's rows; and K10's rows plain version against
``quad_warp_plain``'s rows.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grayskull_tpu as gs
import grayskull_tpu_torch as gt
from grayskull_tpu import libm32 as jax_libm32
from grayskull_tpu import parallel as jp
from grayskull_tpu.cascade import load_frontalface as jax_frontalface
from grayskull_tpu.core import Keypoints as JaxKeypoints
from grayskull_tpu.ops.blobs import blobs as jax_blobs
from grayskull_tpu.parallel import sparse as js
from grayskull_tpu_torch import kernels as K
from grayskull_tpu_torch import libm32
from grayskull_tpu_torch import parallel as tp
from grayskull_tpu_torch.kernels.lbp import _scaled_features
from grayskull_tpu_torch.ops.lbp import _grid_plan
from grayskull_tpu_torch.parallel.sparse import (_band_slab_rows, _fast_slab_rows, _frame_keys,
                                                 _merge_across)
from tests.test_torch_cuda import host_arrays_on_cpu  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "tests", "golden", "testdata")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cpu8():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return devs[:8]


def _meshes(cpu8, shape):
    """The JAX mesh on the virtual devices and the port's on the CPU, both ``shape``."""
    n = int(np.prod(shape))
    return jp.make_mesh(shape, devices=cpu8[:n]), tp.make_mesh(shape, devices=[CPU] * n)


@pytest.fixture(scope="module")
def pgm():
    cache = {}

    def read(name):
        if name not in cache:
            cache[name] = gt.io.read_pgm(os.path.join(TESTDATA, f"{name}.pgm"))
        return cache[name]

    return read


@pytest.fixture(params=["exact_host", "fast"])
def trig(request):
    """Both packages in one trig mode; back to fast mode afterwards."""
    exact = request.param == "exact_host"
    jax_libm32.use_exact_host_libm(exact)
    libm32.use_exact_host_libm(exact)
    yield request.param
    jax_libm32.use_exact_host_libm(False)
    libm32.use_exact_host_libm(False)


def _np(v):
    v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return v.view(np.uint32) if v.dtype == np.float32 else v


def _same(port, ref, msg="", trig_mode="exact_host"):
    """Every leaf of two tables equal; descriptors in fast trig mode by ``test_torch_orb``'s rule."""
    names = getattr(ref, "_fields", None) or range(len(ref))
    for name, a, b in zip(names, jax.tree_util.tree_leaves(port), jax.tree_util.tree_leaves(ref)):
        a, b = _np(a), _np(b)
        if name == "descriptor" and trig_mode == "fast" and not np.array_equal(a, b):
            bad = np.unpackbits((a ^ b.astype(np.uint32)).view(np.uint8)).sum()
            assert bad <= a.size * 32 * 0.001, f"{msg} {bad} descriptor bits differ"
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f"{msg} {name}")


# --- frames ------------------------------------------------------------------


def _spine():
    """``tests/test_parallel_sparse.py``'s serpentine spine with teeth, and a blob."""
    img = np.zeros((64, 48), np.uint8)
    img[:, 2] = 255
    for y in range(0, 64, 7):
        img[y, 2:40] = 255
    img[50:60, 44:47] = 255
    return img


def _noise(density, shape=(64, 48), seed=1234):
    return (np.random.default_rng(seed).random(shape) < density).astype(np.uint8) * 255


def _comb():
    """One component that crosses every boundary of 4 (and 8) shards again and
    again: bars at odd columns joined alternately at the top and bottom rows."""
    img = np.zeros((64, 48), np.uint8)
    img[:, 1:47:2] = 255
    for i, x in enumerate(range(1, 45, 2)):
        img[0 if i % 2 else 63, x:x + 3] = 255
    return img


def _boundary_join():
    """Two bars that meet only on a shard boundary's far side, seeds on slab
    first rows with and without foreground above, and runs cut by a boundary."""
    img = np.zeros((64, 48), np.uint8)
    img[2:16, 5] = img[2:16, 9] = 255      # joined only by row 16, the next shard's first
    img[16, 5:10] = 255
    img[16, 20:24] = 255                   # a seed on shard 1's first row, nothing above
    img[10:32, 30] = 255                   # a run through a boundary, its row-16 pixel no seed
    img[32, 40:44] = img[31, 42] = 255     # joined from above at shard 2's first row
    img[47:49, 12:15] = 255                # a blob cut by the boundary at row 48
    return img


def _hook():
    """A component that leaves shard 1 downwards and comes back into it from
    below, under 28 one-pixel seeds of shard 1: with ``max_blobs`` 2 the JAX
    sharded table drops its shard-1 part (see test_blobs_sharded_past_cap)."""
    img = np.zeros((64, 48), np.uint8)
    img[0:41, 47] = 255
    img[40, 30:48] = 255
    img[20:41, 30] = 255
    for y in (16, 18):
        img[y, 0:28:2] = 255
    return img


FRAMES = {"spine": _spine, "noise35": lambda: _noise(0.35), "noise30": lambda: _noise(0.3),
          "comb": _comb, "boundary_join": _boundary_join, "hook": _hook}


# --- labels and blobs ----------------------------------------------------------


@pytest.mark.parametrize("name,shape", [("spine", (1, 4)), ("noise35", (1, 4)), ("comb", (1, 4)),
                                        ("comb", (1, 8)), ("boundary_join", (1, 4)),
                                        ("noise30", (1, 8))])
def test_label_components_sharded_matches_jax(cpu8, name, shape):
    img = FRAMES[name]()
    jm, tm = _meshes(cpu8, shape)
    ref = np.asarray(js.label_components_sharded(jnp.asarray(img), jm))
    got = tp.label_components_sharded(img, tm)
    assert got.dtype == torch.int32 and got.device == CPU
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tp.label_components_sharded(img, tm, kernels=False).numpy(), ref)


@pytest.mark.parametrize("seed", range(4))
def test_label_components_sharded_dense_noise(seed):
    """Density 0.55 is past the percolation threshold: components cross
    every boundary of 8 shards.  Held to the port's single-device labels
    (held to JAX in tests/test_torch_blobs.py)."""
    img = _noise(0.55, (96, 80), seed)
    tm = tp.make_mesh((1, 8), devices=[CPU] * 8)
    np.testing.assert_array_equal(tp.label_components_sharded(img, tm).numpy(),
                                  gt.label_components(img).numpy())


def test_merge_across_roots_are_minima():
    """The union-find on a chain that must hop through every node, drawn in
    both orders, and on a boundary with no foreground."""
    upper = np.array([[10, -1, 30, 50, -1]], np.int32)
    lower = np.array([[20, 5, 40, 30, 7]], np.int32)
    labels, roots = _merge_across(upper, lower)
    np.testing.assert_array_equal(labels, [20, 40, 50])
    np.testing.assert_array_equal(roots, [10, 30, 30])
    chain = np.arange(0, 40, 2)
    labels, roots = _merge_across(chain[None, 1:][:, ::-1].copy(), chain[None, :-1][:, ::-1].copy())
    np.testing.assert_array_equal(labels, chain[1:])
    assert (roots == 0).all()
    labels, roots = _merge_across(np.full((2, 6), -1, np.int32), np.full((2, 6), 3, np.int32))
    assert labels.size == 0 and roots.size == 0


@pytest.mark.parametrize("name,cap", [("spine", 800), ("noise30", 800), ("boundary_join", 800),
                                      ("comb", 5), ("noise30", 20)])
def test_blobs_sharded_matches_jax(cpu8, name, cap):
    """The table bit for bit, within the cap and past it (noise30 has 286 seeds)."""
    img = FRAMES[name]()
    jm, tm = _meshes(cpu8, (1, 4))
    ref = js.blobs_sharded(jnp.asarray(img), jm, cap)
    got = tp.blobs_sharded(img, tm, cap)
    _same(got, ref, f"{name} cap {cap}")
    if cap == 800:  # and the single-device table, as the JAX test holds
        _same(got, jax_blobs(jnp.asarray(img), cap)[0], f"{name} vs blobs")


def test_blobs_sharded_past_cap():
    """A known difference of the JAX package that the port keeps: past
    ``max_blobs`` the sharded table is ``grayskull_tpu``'s ``blobs_sharded``'s,
    not ``blobs``'.  Here shard 1 holds 28 seeds before the hooked component's
    part in it, past its 2 + 48 // 2 + 1 slab labels, so that part's 12
    pixels are dropped: area 66 where ``blobs`` counts 78."""
    img = _hook()
    jm = jp.make_mesh((1, 4), devices=jax.devices("cpu")[:4])
    tm = tp.make_mesh((1, 4), devices=[CPU] * 4)
    ref = js.blobs_sharded(jnp.asarray(img), jm, 2)
    single, _, overflowed = jax_blobs(jnp.asarray(img), 2)
    got = tp.blobs_sharded(img, tm, 2)
    _same(got, ref, "hook")
    assert bool(overflowed)
    assert int(got.area[0]) == 66 and int(np.asarray(single.area)[0]) == 78
    within = tp.blobs_sharded(img, tm, 40)  # within the cap both agree
    _same(within, jax_blobs(jnp.asarray(img), 40)[0], "hook cap 40")


def test_sharded_shapes_raise_where_jax_raises(cpu8):
    jm, tm = _meshes(cpu8, (1, 4))
    bad = np.zeros((66, 64), np.uint8)
    for jax_fn, port_fn in ((js.blobs_sharded, tp.blobs_sharded),
                            (js.orb_extract_spatial, tp.orb_extract_spatial)):
        args = (10,) if jax_fn is js.blobs_sharded else (10, 20)
        with pytest.raises(ValueError):
            jax_fn(jnp.asarray(bad), jm, *args)
        with pytest.raises(ValueError):
            port_fn(bad, tm, *args)
    with pytest.raises(ValueError):
        js.scan_spatial_shardmap(jnp.asarray(bad), jm)
    with pytest.raises(ValueError):
        tp.scan_spatial_shardmap(bad, tm)
    short = np.zeros((100, 64), np.uint8)  # 25 rows a shard, under the patch halo's 28
    with pytest.raises(ValueError):
        js.orb_extract_spatial(jnp.asarray(short), jm, 10, 20)
    with pytest.raises(ValueError):
        tp.orb_extract_spatial(short, tm, 10, 20)
    with pytest.raises(ValueError):  # the page height must divide too
        js.scan_spatial_shardmap(jnp.zeros((64, 48), jnp.uint8), jm, (10, 8))
    with pytest.raises(ValueError):
        tp.scan_spatial_shardmap(np.zeros((64, 48), np.uint8), tm, (10, 8))
    with pytest.raises(ValueError):
        tp.label_components_sharded(bad, tm)


# --- the scanner -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["document", "receipt"])
def test_scan_spatial_shardmap_matches_jax(cpu8, pgm, name):
    jm, tm = _meshes(cpu8, (1, 4))
    img = pgm(name)
    page_ref, corners_ref = js.scan_spatial_shardmap(jnp.asarray(img), jm)
    page, corners = tp.scan_spatial_shardmap(img, tm)
    assert page.dtype == torch.uint8 and corners.dtype == torch.int32
    np.testing.assert_array_equal(corners.numpy(), np.asarray(corners_ref))
    np.testing.assert_array_equal(page.numpy(), np.asarray(page_ref))
    if name == "document":  # and the single-device scanner, every stage plain
        page1, corners1 = gt.scan(img)
        np.testing.assert_array_equal(page.numpy(), page1.numpy())
        np.testing.assert_array_equal(corners.numpy(), corners1.numpy())
        page2, _ = tp.scan_spatial_shardmap(img, tm, kernels=False)
        np.testing.assert_array_equal(page2.numpy(), page1.numpy())


def test_scan_spatial_shardmap_small_pages_and_no_blob(cpu8):
    """A (1, 8) mesh with 8-row page bands, a frame of one blob and an empty frame."""
    jm, tm = _meshes(cpu8, (1, 8))
    img = np.full((64, 48), 10, np.uint8)
    img[9:50, 7:40] = 200
    blank = np.zeros((64, 48), np.uint8)
    for frame in (img, blank, _boundary_join()):
        page_ref, corners_ref = js.scan_spatial_shardmap(jnp.asarray(frame), jm, (64, 40), 30)
        page, corners = tp.scan_spatial_shardmap(frame, tm, (64, 40), 30)
        np.testing.assert_array_equal(corners.numpy(), np.asarray(corners_ref))
        np.testing.assert_array_equal(page.numpy(), np.asarray(page_ref))


@pytest.mark.parametrize("page,bands", [((1000, 800), [(0, 250), (250, 250), (750, 250)]),
                                        ((37, 29), [(0, 1), (18, 1), (36, 1), (5, 17)]),
                                        ((1, 10), [(0, 1)]), ((10, 1), [(0, 5), (9, 1)])])
def test_quad_warp_rows_plain_is_quad_warp_plains_rows(pgm, page, bands):
    """K10's rows plain version: bands at the top, the middle and the bottom,
    one-row bands, and pages of one row or one column."""
    frames = torch.from_numpy(np.stack([pgm("document"), np.roll(pgm("document"), 5, 1)]))
    corners = torch.tensor([[[50, 40], [700, 60], [690, 1000], [40, 980]],
                            [[10, 700], [1000, 10], [1020, 760], [3, 10]]], dtype=torch.int32)
    whole = K.quad_warp_plain(frames, corners, page)
    for row0, rows in bands:
        got = K.quad_warp_rows(frames, corners, page, row0, rows)
        assert got.shape == (2, rows, page[1])
        assert torch.equal(got, whole[:, row0:row0 + rows]), (row0, rows)
        assert torch.equal(K.quad_warp_rows_plain(frames, corners, page, row0, rows), got)
    for row0, rows in ((-1, 1), (0, 0), (page[0] - 1, 2)):
        with pytest.raises(ValueError):
            K.quad_warp_rows(frames, corners, page, row0, rows)


# --- ORB --------------------------------------------------------------------------


@pytest.mark.parametrize("nk,thr", [(200, 20), (500, 35)])
def test_orb_extract_spatial_matches_jax(cpu8, pgm, trig, nk, thr):
    jm, tm = _meshes(cpu8, (1, 4))
    img = pgm("aruco")  # 480x640: 4 shards of 120 rows
    ref = js.orb_extract_spatial(jnp.asarray(img), jm, nk, thr)
    got = tp.orb_extract_spatial(img, tm, nk, thr)
    assert int(got.n) > 50
    _same(got, ref, f"aruco {nk} {thr}", trig)
    _same(got, gs.orb_extract(jnp.asarray(img), nk, thr), "vs orb_extract", trig)


def _corner_frame(rows, seed=42):
    """``tests/test_parallel_sparse.py:109``'s jittered base with bright 5x5
    squares centred on ``rows``."""
    rng = np.random.default_rng(seed)
    img = rng.integers(20, 40, (480, 640)).astype(np.uint8)
    xs = np.arange(24, 616, 24)
    for i, yy in enumerate(rows):
        for xx in xs[i::7]:
            img[yy - 2:yy + 3, xx - 2:xx + 3] = rng.integers(200, 240, (5, 5))
    return img


@pytest.mark.parametrize("offsets", [(-3, 0, 3), (-1, 0, 119)])
def test_orb_extract_spatial_shard_boundary_corners(cpu8, trig, offsets):
    """Corners on the rows around the 120-row boundaries of 4 shards: at
    ``row0 - 3``, ``row0``, ``row0 + 3`` (the JAX test's), and at ``row0 - 1``,
    ``row0`` and ``row0 + h_loc - 1``, each shard's first and last rows."""
    jm, tm = _meshes(cpu8, (1, 4))
    rows = [b + d for b in (120, 240, 360) for d in offsets if b + d < 478] + [60, 200, 420]
    img = _corner_frame(rows)
    ref = js.orb_extract_spatial(jnp.asarray(img), jm, 300, 20)
    got = tp.orb_extract_spatial(img, tm, 300, 20)
    assert int(ref.n) > 20
    _same(got, ref, f"corners at {offsets}", trig)


def test_fast_slabs_give_the_frames_keys(pgm):
    """K6 on the asymmetric slabs: each shard's re-based keys equal
    ``fast_plain``'s keys of the whole frame at its rows, for every shard
    count that divides H."""
    frame = torch.from_numpy(np.ascontiguousarray(pgm("aruco")[150:246, 100:260]))
    h, w = frame.shape
    _, whole = K.fast_plain(frame[None], 20)
    whole = whole[0].reshape(-1)
    for ns in [k for k in range(1, h + 1) if h % k == 0]:
        h_loc = h // ns
        keys = []
        for s in range(ns):
            lo, hi = _fast_slab_rows(s, ns, h_loc)
            _, key = K.fast_plain(frame[lo:hi][None].contiguous(), 20)
            keys.append(_frame_keys(key[0], lo, s * h_loc, h_loc, h, w))
        assert torch.equal(torch.cat(keys), whole), ns


def test_frame_keys_widen_past_2_23_pixels():
    """A slab whose keys pack in int32, of a frame of 2^23 pixels or more,
    gives int64 frame keys (``kernels/fast.py:42``'s packing)."""
    w, h, lo, r = 4096, 2048, 1000, 40
    slab = torch.zeros((r, w), dtype=torch.int32)
    slab[4, 7] = ((r * w - (4 * w + 7)) << 8) | 9
    got = _frame_keys(slab, lo, lo + 4, 8, h, w)
    assert got.dtype == torch.int64
    gidx = (lo + 4) * w + 7
    assert int(got[7]) == ((h * w - gidx) << 8) | 9 and int((got != 0).sum()) == 1


# --- matching ------------------------------------------------------------------------


@pytest.mark.parametrize("shape,caps", [((1, 4), (64, 32, 64)), ((1, 8), (96, 40, 50))])
def test_match_orb_sharded_matches_jax(cpu8, pgm, shape, caps):
    nk, max_matches, max_distance = caps
    jm, tm = _meshes(cpu8, shape)
    img = pgm("lena")
    k1 = gt.orb_extract(img, nk, 20)
    k2 = gt.orb_extract(np.ascontiguousarray(img[::-1]), nk, 20)
    jk1, jk2 = (JaxKeypoints(*(jnp.asarray(v.numpy()) for v in k)) for k in (k1, k2))
    ref = js.match_orb_sharded(jk1, jk2, jm, max_matches, max_distance)
    got = tp.match_orb_sharded(k1, k2, tm, max_matches, max_distance)
    assert int(got.n) > 0
    _same(got, ref, f"{shape}")
    _same(got, gt.match_orb(k1, k2, max_matches, max_distance), "vs match_orb")


def test_match_orb_sharded_cap_must_divide(cpu8, pgm):
    k = gt.orb_extract(pgm("lena"), 30, 20)
    jm = jp.make_mesh((1, 4), devices=cpu8[:4])
    with pytest.raises(Exception):
        js.match_orb_sharded(JaxKeypoints(*(jnp.asarray(v.numpy()) for v in k)),
                             JaxKeypoints(*(jnp.asarray(v.numpy()) for v in k)), jm, 10, 60)
    with pytest.raises(ValueError):
        tp.match_orb_sharded(k, k, tp.make_mesh((1, 4), devices=[CPU] * 4), 10, 60)


# --- LBP and faces ---------------------------------------------------------------------


def test_lbp_band_slab_at_origin_one_matches_the_frame(pgm):
    """K5 on a band's slab of the integral: from row y0 - 1, at origin row 1
    (band 0 from row 0, origin 0), down to the rows its features reach; its
    hits equal the whole frame's rows, for bands at the top, the middle and
    the bottom at three ladder scales."""
    cascade = gt.load_frontalface()
    frame = torch.from_numpy(pgm("lena").copy())
    ii = K.integral_plain(frame[None])
    ih, iw = frame.shape
    plan = _grid_plan(cascade, ih, iw, 1.2, 1.0, 4.0, 1)
    wi = cascade.weak_feature_idx.astype(np.int64)
    for scale, _, _, ny, nx in (plan[0], plan[3], plan[-1]):
        whole = K.lbp_eval_scale_plain(cascade, ii, scale, ny, nx)
        _, fy, _, fh = _scaled_features(cascade, scale)
        reach = int((fy[wi] + 3 * fh[wi]).max())
        band = -(-ny // 4)
        for y0 in sorted({0, band, ny - band, ny - 1, max(ny - 3, 0)}):
            rows = min(band, ny - y0)
            top, end = _band_slab_rows(y0, rows, reach, ih)
            assert top == max(y0 - 1, 0)
            hits = K.lbp_eval_scale_plain(cascade, ii[:, top:end].contiguous(), scale, rows, nx,
                                          1, (y0 - top, 0))
            assert torch.equal(hits, whole[:, y0:y0 + rows]), (scale, y0)


def test_lbp_detect_sharded_matches_jax(cpu8, pgm):
    jm, tm = _meshes(cpu8, (2, 4))
    img = pgm("lena")
    imgs = np.stack([img, np.roll(img, 9, axis=1)])
    ii = gs.integral(jnp.asarray(imgs))
    ref = js.lbp_detect_sharded(jax_frontalface(), ii, jm, 40)
    got = tp.lbp_detect_sharded(gt.load_frontalface(), torch.from_numpy(np.array(ii)), tm, 40)
    assert int(got.n.min()) > 0
    _same(got, ref, "(2, 4)")


def test_detect_faces_sharded_matches_jax(cpu8, pgm):
    jm, tm = _meshes(cpu8, (2, 4))
    img = pgm("lena")  # 128x128: H divisible by space=4
    batch = np.stack([np.roll(img, 3 * i, axis=1) for i in range(2)])
    ref = js.detect_faces_sharded(jnp.asarray(batch), jm)
    got = tp.detect_faces_sharded(batch, tm)
    _same(got, ref, "(2, 4) batch")
    _same(got, gt.detect_faces(batch), "vs detect_faces")
    one = tp.detect_faces_sharded(img, tp.make_mesh((1, 4), devices=[CPU] * 4), max_rects=7,
                                  kernels=False)
    _same(one, gt.detect_faces(img, max_rects=7), "one frame on (1, 4)")
