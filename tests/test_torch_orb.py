"""The port's ORB ops and kernels against ``grayskull_tpu``'s, on the CPU.

``grayskull_tpu_torch``'s FAST (K6's plain version and the ``fast`` op), the
patch, moment and rBRIEF plain versions (K7, K8), ``compute_orientation``,
``brief_descriptor``, the candidate selection, ``orb_extract``,
``hamming_distance``, ``match_orb``, ``downsample`` and ``libm32`` are held to
the JAX functions on the same numpy inputs, made from a seed.  The Pallas
kernels run in interpret mode, as ``tests/test_features.py`` runs them.

The tolerance is 0: every output is an integer, a bool, or a float32 compared
by its bits.  One exception, in the fast trig mode only: the JAX package may
let XLA contract the rBRIEF rotation ``px*cos - py*sin`` into a fused
multiply-add (``features.py:524-526``), while the port rounds every product
and sum on its own, so a truncated offset can move by one pixel.  There the
descriptors are held to the JAX package's own rule for that mode, >= 99.9 %
equal bits (``tests/test_features.py:81-96``); in ``exact_host`` mode they are
equal bit for bit.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grayskull_tpu as gs
import grayskull_tpu_torch as gt
from grayskull_tpu import libm32 as jax_libm32
from grayskull_tpu.core import Keypoints as JaxKeypoints
from grayskull_tpu.kernels.fast import fast_pallas
from grayskull_tpu.kernels.patches import extract_patches_batched
from grayskull_tpu.ops.features import _brief_single, _select_candidates_sort
from grayskull_tpu_torch import kernels as K
from grayskull_tpu_torch import libm32
from grayskull_tpu_torch.core import keypoints_from_arrays
from grayskull_tpu_torch.ops.features import _select_candidates
from tests.test_torch_cuda import host_arrays_on_cpu  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "tests", "golden", "testdata")


@pytest.fixture(scope="module")
def lena():
    return gt.io.read_pgm(os.path.join(TESTDATA, "lena.pgm"))


@pytest.fixture(scope="module")
def aruco():
    return gt.io.read_pgm(os.path.join(TESTDATA, "aruco.pgm"))


@pytest.fixture(scope="module")
def goldens():
    return np.load(os.path.join(REPO, "tests", "golden", "goldens.npz"))


@pytest.fixture(params=["exact_host", "fast"])
def trig(request):
    """Both packages in one trig mode; back to fast mode afterwards."""
    exact = request.param == "exact_host"
    jax_libm32.use_exact_host_libm(exact)
    libm32.use_exact_host_libm(exact)
    yield request.param
    jax_libm32.use_exact_host_libm(False)
    libm32.use_exact_host_libm(False)


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _np(v):
    v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return v.view(np.uint32) if v.dtype == np.float32 else v


def _same_table(port, ref, msg="", trig_mode="exact_host"):
    """Every field equal, angles by their bits; descriptors by the rule above."""
    for name in ref._fields:
        a, b = _np(getattr(port, name)), _np(getattr(ref, name))
        if name == "descriptor" and trig_mode == "fast" and not np.array_equal(a, b):
            bad = np.unpackbits((a ^ b.astype(np.uint32)).view(np.uint8)).sum()
            assert bad <= a.size * 32 * 0.001, f"{msg} {bad} descriptor bits differ"
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f"{msg} {name}")


def _jax_table(t):
    return JaxKeypoints(*(jnp.asarray(v.numpy()) for v in t))


# --- FAST ------------------------------------------------------------------


@pytest.mark.parametrize("thr", [5, 20])
def test_fast_plain_vs_fast_pallas(aruco, thr):
    for imgs in (aruco[None, :97], _frames((2, 40, 56), 60)):
        score, key = K.fast(torch.from_numpy(np.array(imgs)), thr, want_score=True)
        s_ref, k_ref = fast_pallas(jnp.asarray(imgs), thr, interpret=True)
        np.testing.assert_array_equal(score.numpy(), np.asarray(s_ref))
        assert key.dtype == torch.int32
        np.testing.assert_array_equal(key.numpy(), np.asarray(k_ref))


@pytest.mark.parametrize("thr", [0, 5, 20, 60, 200])
def test_fast_vs_jax_lena(lena, thr):
    kps, score = gt.fast(lena, 5000, thr)
    ref, s_ref = gs.ops.fast(lena, 5000, thr)
    np.testing.assert_array_equal(score.numpy(), np.asarray(s_ref))
    _same_table(kps, ref, f"thr {thr}")
    assert kps.descriptor.dtype == torch.uint32 and kps.descriptor.shape == (5000, 8)
    np.testing.assert_array_equal(gt.fast_scoremap(lena, thr).numpy(), np.asarray(s_ref))


def test_fast_cap_truncation_and_random(lena):
    kps, _ = gt.fast(lena, 50, 10)
    assert int(kps.n) == 50
    _same_table(kps, gs.ops.fast(lena, 50, 10)[0], "cap 50")
    full, _ = gt.fast(lena, 5000, 10)
    np.testing.assert_array_equal(kps.x.numpy(), full.x[:50].numpy())  # the first 50 in raster order
    frames = _frames((3, 40, 56), 61)
    batch, _ = gt.fast(frames, 3000, 15)
    for i in range(3):
        ref, s_ref = gs.ops.fast(frames[i], 3000, 15)
        _same_table(gt.Keypoints(*(v[i] for v in batch)), ref, f"random frame {i}")
        np.testing.assert_array_equal(gt.fast_scoremap(frames, 15)[i].numpy(), np.asarray(s_ref))


def test_fast_quirks(lena):
    kn, sn = gt.fast(lena, 500, -7)  # a negative threshold clamps to 0
    k0, s0 = gt.fast(lena, 500, 0)
    assert torch.equal(sn, s0) and int(kn.n) == int(k0.n)
    dark = _frames((30, 50), 62) // 64  # p < thr everywhere: C's p - thr wraps
    for thr in (5, 60):
        kps, score = gt.fast(dark, 100, thr)
        ref, s_ref = gs.ops.fast(dark, 100, thr)
        np.testing.assert_array_equal(score.numpy(), np.asarray(s_ref))
        _same_table(kps, ref, f"dark thr {thr}")
    checker = (np.indices((40, 64)).sum(0) % 2 * 255).astype(np.uint8)  # every corner ties
    kps, _ = gt.fast(checker, 500, 10)
    _same_table(kps, gs.ops.fast(checker, 500, 10)[0], "checkerboard")
    tiny, _ = gt.fast(_frames((7, 8), 63), 100, 0)  # cap past h*w, no interior
    assert int(tiny.n) == 0 and tiny.x.shape == (100,)


def test_fast_wide_keys_past_2_23():
    """h*w >= 2^23 takes int64 keys; the table is the JAX package's unpacked-key one."""
    img = np.zeros((2900, 2900), np.uint8)
    img[100:140:4, 2800:2840:4] = 255  # a few isolated bright dots near the last columns
    img[2850, 10] = 200
    _, key = K.fast(torch.from_numpy(img[None]), 20)
    assert key.dtype == torch.int64
    kps, _ = gt.fast(img, 40, 20)
    ref, _ = gs.ops.fast(img, 40, 20)
    assert int(kps.n) > 0
    _same_table(kps, ref, "2900x2900")


def test_fast_goldens(goldens):
    kps, score = gt.fast(goldens["input"], 500, 15)
    n = int(kps.n)
    assert n == len(goldens["fast_xy"])
    np.testing.assert_array_equal(score.numpy(), goldens["fast_scoremap"])
    xy = np.stack([kps.x[:n].numpy(), kps.y[:n].numpy()], 1)
    np.testing.assert_array_equal(xy, goldens["fast_xy"].astype(np.int64))
    np.testing.assert_array_equal(kps.response[:n].numpy(), goldens["fast_response"])


# --- patches, moments, rBRIEF ---------------------------------------------------


def _edge_points(h, w, rng, k_random):
    edge = [(0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1), (w // 2, 0), (0, h // 2),
            (w - 1, h // 2), (w // 2, h - 1), (19, 19), (20, 20), (w - 20, h - 20)]
    xs = np.array([p[0] for p in edge] + rng.integers(0, w, k_random).tolist(), np.int32)
    ys = np.array([p[1] for p in edge] + rng.integers(0, h, k_random).tolist(), np.int32)
    return np.stack([xs, xs[::-1]]), np.stack([ys, ys[::-1]])


def test_extract_patches_plain_vs_pallas_edge_keypoints():
    rng = np.random.default_rng(11)
    h, w = 64, 200
    imgs = rng.integers(0, 256, (2, h, w), dtype=np.uint8)
    xs, ys = _edge_points(h, w, rng, 53)
    got = K.extract_patches_plain(torch.from_numpy(imgs), torch.from_numpy(xs),
                                  torch.from_numpy(ys))
    ref = extract_patches_batched(jnp.asarray(imgs), jnp.asarray(xs), jnp.asarray(ys),
                                  interpret=True)
    assert got.shape == (2, 64, 48, 48) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_orb_kernels_plain_match_their_wrappers_and_each_other():
    rng = np.random.default_rng(12)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 40, 70), dtype=np.uint8))
    xs, ys = (torch.from_numpy(np.ascontiguousarray(c)) for c in _edge_points(40, 70, rng, 21))
    before = K.launch_counts()
    m01, m10 = K.orb_moments(imgs, xs, ys)
    assert m01.dtype == torch.int32 and m01.shape == (2, 32)
    patches = K.extract_patches_plain(imgs, xs, ys).to(torch.int64)
    dy, dx = np.mgrid[-20:28, -20:28]
    disc = torch.from_numpy(dx * dx + dy * dy <= 225)
    assert torch.equal(m01, (patches * torch.from_numpy(dy) * disc).sum((-2, -1)).to(torch.int32))
    assert torch.equal(m10, (patches * torch.from_numpy(dx) * disc).sum((-2, -1)).to(torch.int32))
    ang = torch.from_numpy(rng.uniform(-4, 4, (2, 32)).astype(np.float32))
    s, c = libm32.sinf(ang), libm32.cosf_like_reference(ang)
    desc = K.orb_brief(imgs, xs, ys, s, c)
    assert desc.dtype == torch.uint32 and desc.shape == (2, 32, 8)
    assert torch.equal(desc.view(torch.int32), K.orb_brief_plain(imgs, xs, ys, s, c)
                       .view(torch.int32))
    assert K.launch_counts() == before  # the CPU runs the plain versions, uncounted


def test_orb_kernel_wrappers_reject_bad_input():
    imgs = torch.zeros((2, 40, 40), dtype=torch.uint8)
    x = torch.full((2, 5), 20, dtype=torch.int32)
    f = torch.zeros((2, 5), dtype=torch.float32)
    for bad, err in ((x.to(torch.int64), TypeError), (x[0], ValueError), (x[:1], ValueError),
                     (x.t().contiguous().t(), ValueError)):
        with pytest.raises(err):
            K.orb_moments(imgs, bad, x)
        with pytest.raises(err):
            K.orb_brief(imgs, x, bad, f, f)
    with pytest.raises(ValueError):
        K.orb_moments(imgs, x, x, 21)  # past the 48x48 patch
    with pytest.raises(TypeError):
        K.orb_brief(imgs, x, x, f.to(torch.float64), f)
    with pytest.raises(TypeError):
        K.fast(imgs.to(torch.int32), 20)
    with pytest.raises(ValueError):
        K.fast(imgs[:, :, ::2], 20)


def test_compute_orientation_vs_jax(lena, trig):
    img = jnp.asarray(lena)
    rng = np.random.default_rng(13)
    for k in (5, 40):  # JAX: a vmapped patch below 32 keypoints, dense moment maps above
        xs = rng.integers(15, 113, k).astype(np.int32)
        ys = rng.integers(15, 113, k).astype(np.int32)
        got = gt.compute_orientation(lena, xs, ys)
        assert got.dtype == torch.float32 and got.shape == (k,)
        np.testing.assert_array_equal(_np(got), _np(gs.ops.compute_orientation(img, xs, ys)))
    one = gt.compute_orientation(lena, 64, 70)
    assert one.shape == ()
    assert _np(one) == _np(gs.ops.compute_orientation(img, 64, 70))


def test_brief_descriptor_vs_jax_with_keypoints_outside(lena, trig):
    img = jnp.asarray(lena)
    h, w = lena.shape
    xs = np.array([-30, -10, 0, 5, 64, w - 1, w + 4, w + 60, 40, 90], np.int32)
    ys = np.array([-25, 40, -3, h + 2, 64, h - 1, h + 30, -1, 50, 20], np.int32)
    angles = np.concatenate([np.linspace(-3.0, 3.0, 8), [np.pi, 0.0]]).astype(np.float32)
    got = gt.brief_descriptor(lena, xs, ys, angles)
    assert got.dtype == torch.uint32 and got.shape == (10, 8)
    ref = gs.ops.brief_descriptor(img, xs, ys, angles)
    for a, b in ((got, ref),
                 (got, np.stack([_brief_single(img, jnp.int32(x), jnp.int32(y), jnp.float32(a))
                                 for x, y, a in zip(xs, ys, angles)]))):
        _same_descriptors(a, b, trig)
    single = gt.brief_descriptor(lena, 64, 64, 0.5)
    assert single.shape == (8,)
    _same_descriptors(single, gs.ops.brief_descriptor(img, 64, 64, 0.5), trig)


def _same_descriptors(port, ref, trig_mode):
    a, b = _np(port), np.asarray(ref).astype(np.uint32)
    if trig_mode == "fast" and not np.array_equal(a, b):
        bad = np.unpackbits((a ^ b).view(np.uint8)).sum()
        assert bad <= a.size * 32 * 0.001, f"{bad} descriptor bits differ"
    else:
        np.testing.assert_array_equal(a, b)


# --- selection and orb_extract -----------------------------------------------


def _select_both(kps, valid, cap, h, w):
    got = _select_candidates(*(torch.from_numpy(np.array(v))[None] for v in
                               (kps.x, kps.y, kps.response, valid)), cap, 15, h, w)
    ref = _select_candidates_sort(kps, jnp.asarray(valid), cap, 15, h, w)
    for name, a, b in zip(("n", "x", "y", "response"), got, ref):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b), err_msg=f"{name} cap={cap}")


def test_candidate_selection_vs_stable_sort(aruco):
    h, w = aruco.shape
    kps, _ = gs.ops.fast(aruco, 2000, 20)
    for n_cand in (2000, 137, 0):
        valid = np.arange(2000) < n_cand
        for cap in (500, 2000, 7):
            _select_both(kps, valid, cap, h, w)
    rng = np.random.default_rng(14)

    def table(n, lo, hi, rmax):
        return JaxKeypoints(
            n=jnp.int32(n), x=jnp.asarray(rng.integers(lo, w - lo, n, dtype=np.int32)),
            y=jnp.asarray(rng.integers(lo, h - lo, n, dtype=np.int32)),
            response=jnp.asarray(rng.integers(rmax[0], rmax[1], n, dtype=np.int32)),
            angle=jnp.zeros(n, jnp.float32), descriptor=jnp.zeros((n, 8), jnp.uint32))

    _select_both(table(300, 0, 0, (20, 23)), np.arange(300) < 251, 100, h, w)  # heavy ties
    wide = table(5000, 20, 0, (0, 256))  # the full 5,000-candidate budget: ranks past 4095
    for cap in (2000, 4200):
        _select_both(wide, np.ones(5000, bool), cap, h, w)


def test_orb_extract_vs_jax(lena, trig):
    for nk, thr in ((100, 10), (500, 20)):
        got = gt.orb_extract(lena, nk, thr)
        assert got.n.shape == () and got.descriptor.shape == (nk, 8)
        _same_table(got, gs.ops.orb_extract(lena, nk, thr), f"lena {nk} {thr}", trig)


def test_orb_extract_batched_and_limits_vs_jax(lena, trig):
    frames = np.stack([lena, np.ascontiguousarray(lena[::-1, ::-1]), np.roll(lena, 9, axis=1)])
    got = gt.orb_extract(frames, 100, 20)
    _same_table(got, gs.ops.orb_extract(frames, 100, 20), "batch", trig)
    for i in range(3):
        _same_table(gt.orb_extract(frames[i], 100, 20), gt.Keypoints(*(v[i] for v in got)),
                    f"frame {i} alone")
    _same_table(gt.orb_extract(frames, 100, 20, limit=37),
                gs.ops.orb_extract(frames, 100, 20, limit=37), "scalar limit", trig)
    lim = np.array([0, 12, 250], np.int32)
    got = gt.orb_extract(frames, 100, 20, limit=torch.from_numpy(lim))
    assert got.n.tolist() == [0, 12, 100]
    _same_table(got, gs.ops.orb_extract(frames, 100, 20, limit=jnp.asarray(lim)),
                "vector limit", trig)
    _same_table(gt.orb_extract(frames, 100, 20, force_reference=True),
                gt.orb_extract(frames, 100, 20), "force_reference")


# --- matching ------------------------------------------------------------------


def test_hamming_distance_vs_jax():
    rng = np.random.default_rng(15)
    d1 = rng.integers(0, 2**32, (37, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (23, 8), dtype=np.uint32)
    d2[0] = d1[3]
    d2[1] = ~d1[4]
    got = gt.hamming_distance(torch.from_numpy(d1), torch.from_numpy(d2))
    assert got.dtype == torch.int32 and got.shape == (37, 23)
    np.testing.assert_array_equal(got.numpy(), np.asarray(gs.ops.hamming_distance(d1, d2)))
    assert int(got[3, 0]) == 0 and int(got[4, 1]) == 256
    np.testing.assert_array_equal(gt.hamming_distance(d1, d2).numpy(), got.numpy())


def _tables(d, n):
    cap = len(d)
    z = np.zeros(cap, np.int32)
    obj = dict(n=np.int32(n), x=z, y=z, response=z, angle=z.astype(np.float32), descriptor=d)
    return keypoints_from_arrays(obj), JaxKeypoints(**{k: jnp.asarray(v) for k, v in obj.items()})


def _same_matches(port, ref, msg):
    for name, a, b in zip(port._fields, port, ref):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{msg} {name}")


def test_match_orb_vs_jax_sentinels_and_ties():
    rng = np.random.default_rng(16)
    d1 = rng.integers(0, 2**32, (6, 8), dtype=np.uint32)
    d2 = np.concatenate([d1[:1] ^ np.uint32(1), d1[:1] ^ np.uint32(1), d1[1:3] ^ np.uint32(3),
                         rng.integers(0, 2**32, (4, 8), dtype=np.uint32)])  # rows 0, 1 tie
    for n1, n2 in ((6, 8), (4, 1), (6, 0), (0, 8)):  # n2 = 1: second stays at the sentinel
        p1, j1 = _tables(d1, n1)
        p2, j2 = _tables(d2, n2)
        for mm, md in ((10, 60.0), (2, 60.0), (10, 0.5), (10, 1.0), (10, 2.0), (10, 256.0)):
            got = gt.match_orb(p1, p2, mm, md)
            _same_matches(got, gs.ops.match_orb(j1, j2, mm, md), f"n1={n1} n2={n2} {mm} {md}")
    got = gt.match_orb(*(_tables(d, len(d))[0] for d in (d1, d2)), 10, 60.0)
    # a tied best leaves second == best, so the ratio test rejects row 0
    assert got.idx1[: int(got.n)].tolist() == [1, 2] and got.idx2[:2].tolist() == [2, 3]


def test_match_orb_vs_jax_on_real_tables(lena):
    k1 = gs.ops.orb_extract(lena, 500, 20)
    k2 = gs.ops.orb_extract(np.ascontiguousarray(lena[::-1, ::-1]), 500, 20)
    p1, p2 = keypoints_from_arrays(k1), keypoints_from_arrays(k2)
    _same_table(p1, k1, "keypoints_from_arrays")
    for mm, md in ((300, 60.0), (10, 60.0), (300, 5.0), (300, 256.0)):
        _same_matches(gt.match_orb(p1, p2, mm, md), gs.ops.match_orb(k1, k2, mm, md),
                      f"{mm} {md}")


@pytest.mark.parametrize("key,md", [("match_orb_64", 64.0), ("match_orb_200", 200.0)])
def test_match_orb_goldens(goldens, key, md):
    p1 = _tables(goldens["match_d1"], 40)[0]
    p2 = _tables(goldens["match_d2"], 40)[0]
    m = gt.match_orb(p1, p2, 100, md)
    n = int(m.n)
    got = np.stack([m.idx1[:n].numpy(), m.idx2[:n].numpy(), m.distance[:n].numpy()], 1)
    np.testing.assert_array_equal(got, goldens[key].astype(np.int64))


# --- libm32 and downsample --------------------------------------------------------


def test_libm32_vs_jax(trig):
    rng = np.random.default_rng(17)
    y = np.concatenate([rng.integers(-200000, 200000, 300), [0, 0, 5, -5, 0]]).astype(np.float32)
    x = np.concatenate([rng.integers(-200000, 200000, 300), [0, -3, 0, 0, 7]]).astype(np.float32)
    a = np.concatenate([rng.uniform(-7, 7, 300), [0, np.pi, -np.pi, 1.57079, -1e-3]])
    a = a.astype(np.float32)
    assert libm32.trig_mode() == trig and libm32.exact_mode() == (trig == "exact_host")
    for got, ref in ((libm32.atan2f(torch.from_numpy(y), torch.from_numpy(x)),
                      jax_libm32.atan2f(y, x)),
                     (libm32.sinf(torch.from_numpy(a)), jax_libm32.sinf(a)),
                     (libm32.cosf_like_reference(torch.from_numpy(a)),
                      jax_libm32.cosf_like_reference(a))):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_np(got), _np(ref))
    assert float(libm32.atan2f(1.0, 1.0)) == float(jax_libm32.atan2f(1.0, 1.0))


@pytest.mark.parametrize("shape", [(64, 96), (2, 33, 47), (1, 7, 1)])
def test_downsample_vs_jax(goldens, shape):
    img = _frames(shape, 18)
    got = gt.downsample(img)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(gs.ops.downsample(img)))
    np.testing.assert_array_equal(gt.downsample(goldens["input"]).numpy(), goldens["downsample"])
