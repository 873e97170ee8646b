"""The port's ORB ops and kernels against ``grayskull_tpu``'s, on the CPU.

``grayskull_tpu_torch``'s FAST (K6's plain version and the ``fast`` op), the
patch, moment and rBRIEF plain versions (K7, K8), ``compute_orientation``,
``brief_descriptor``, the candidate selection, ``orb_extract``,
``hamming_distance``, ``match_orb``, ``downsample`` and ``libm32`` are held to
the JAX functions on the same numpy inputs, made from a seed.  The Pallas
kernels run in interpret mode, as ``tests/test_features.py`` runs them.
K6's and K7's word-level arithmetic (``csrc/fast.cu``, ``csrc/patches.cu``) is
replayed in numpy and held to the plain versions and the JAX kernels.

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

import jax
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
from grayskull_tpu_torch.kernels.fast import _run9, _threshold
from grayskull_tpu_torch.kernels.patches import BRIEF_PATTERN
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


# --- K6's byte-lane arithmetic (csrc/fast.cu), replayed in numpy --------------

_M32 = np.uint64(0xFFFFFFFF)
_MSB, _LOW7, _ONES = np.uint64(0x80808080), np.uint64(0x7F7F7F7F), np.uint64(0x01010101)
_CIRCLE = [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
           (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3)]


def _bytewise(fn, a, b):
    out = np.zeros(np.broadcast(a, b).shape, np.uint64)
    for i in range(4):
        sh = np.uint64(8 * i)
        z = fn(((a >> sh) & np.uint64(0xFF)).astype(np.int64), ((b >> sh) & np.uint64(0xFF)).astype(np.int64))
        out |= z.astype(np.uint64) << sh
    return out


def _gt_msb(a, b, x):
    """``gt_msb``: bit 7 of each byte is a > b, given x = (a | 0x80) - (b & 0x7f) - 1."""
    return ((a & ~b) | (~(a ^ b) & x)) & _M32


def _byte_perm(x, y, sel):
    both = (y << np.uint64(32)) | x
    out = np.zeros_like(x)
    for n in range(4):
        out |= ((both >> np.uint64(8 * ((sel >> (4 * n)) & 7))) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out


def _u16x2(fn, *words):
    """A DPX ``__vimin3_u16x2`` / ``__vimax3_u16x2``: ``fn`` of each 16-bit half."""
    out = np.zeros_like(words[0])
    for sh in (np.uint64(0), np.uint64(16)):
        out |= fn.reduce([(w >> sh) & np.uint64(0xFFFF) for w in words]) << sh
    return out


def _by_u16(fn, *words):
    """The bytewise ``fn`` of words by the u16 trick: the high byte of each
    half of fn over the words (bytes 1, 3) and over them shifted up a byte
    (bytes 0, 2), put together by ``__byte_perm(even, odd, 0x7351)``."""
    odd = _u16x2(fn, *words)
    even = _u16x2(fn, *((w << np.uint64(8)) & _M32 for w in words))
    return _byte_perm(even, odd, 0x7351)


def _centre(p, thr):
    """score_row's per-word constants for centre words p and threshold thr."""
    t4 = np.uint64(min(thr, 255) * 0x01010101)
    wrap_all = _M32 if thr > 255 else np.uint64(0)
    hi = _bytewise(lambda a, b: np.minimum(a + b, 255), p, t4)
    lo = _bytewise(lambda a, b: np.maximum(a - b, 0), p, t4)
    wrap = wrap_all | _gt_msb(t4, p, ((t4 | _MSB) - ((p & _LOW7) + _ONES)) & _M32)
    return hi, (hi & _LOW7) + _ONES, lo, ((lo | _MSB) + _MSB - _ONES) & _M32, wrap


def _bright_dark(v, centre):
    hi, hi_l1, lo, kd, wrap = centre
    vh = v | _MSB
    bright = _gt_msb(v, hi, (vh - hi_l1) & _M32)
    dark = _gt_msb(lo, v, (kd - vh) & _M32) | (wrap & ~bright & _M32)
    return bright, dark


def _run9_tree(m):
    """The AND-tree of ``csrc/fast.cu:run9`` over 16 words, bitwise."""
    a2 = [m[k] & m[(k + 1) % 16] for k in range(16)]
    a4 = [a2[k] & a2[(k + 2) % 16] for k in range(16)]
    run = np.zeros_like(m[0])
    for k in range(16):
        run |= a4[k] & a4[(k + 4) % 16] & m[(k + 8) % 16]
    return run


def test_fast_run9_tree_over_every_mask():
    """The AND-tree equals ``kernels/fast.py:_run9`` (the shift-and fold) and
    the definition, 9 consecutive set bits of 16 read circularly, on all
    65,536 masks; packed with other masks and garbage bits, as the kernel
    packs a lane's words, each mask's bit still reads its own run."""
    masks = np.arange(1 << 16, dtype=np.int64)
    bits = [(masks >> k) & 1 for k in range(16)]
    direct = np.zeros(masks.shape, bool)
    for start in range(16):
        run = np.ones(masks.shape, bool)
        for j in range(9):
            run &= bits[(start + j) % 16] == 1
        direct |= run
    fold = _run9(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(fold, direct)
    np.testing.assert_array_equal(_run9_tree([b.astype(np.uint64) for b in bits]) == 1, direct)
    # 16 masks a word: 4 positions in each of 4 bytes (bits 7, 6, 5, 4), the
    # other 16 bits random garbage in every sample's word
    rng = np.random.default_rng(70)
    perm = rng.permutation(masks)
    words = []
    for k in range(16):
        word = rng.integers(0, 1 << 32, masks.size // 16, dtype=np.uint64)
        for slot in range(16):
            pos = np.uint64(8 * (slot // 4) + 7 - slot % 4)
            word = (word & ~(np.uint64(1) << pos)) | ((((perm[slot::16] >> k) & 1).astype(np.uint64)) << pos)
        words.append(word)
    run = _run9_tree(words)
    for slot in range(16):
        pos = np.uint64(8 * (slot // 4) + 7 - slot % 4)
        np.testing.assert_array_equal((run >> pos) & np.uint64(1) == 1, direct[perm[slot::16]])


@pytest.mark.parametrize("thr", [0, 1, 20, 254, 255, 256, 1000, 2**31 - 1])
def test_fast_byte_lane_compares_over_every_pair(thr):
    """K6's bright and dark bytes (bit 7 of each byte, four pixels a word) and
    the u16 trick's minimum, over all 256 x 256 (p, v) pairs: bright is uint32
    v > p + thr, dark is not bright and v < p - thr mod 2^32 (C's wrap), as
    ``kernels/fast.py:fast_plain`` and the JAX kernel compute them."""
    p64, v64 = (a.ravel() for a in np.meshgrid(np.arange(256), np.arange(256), indexing="ij"))
    bright_ref = v64 > p64 + thr
    dark_ref = ~bright_ref & (v64 < (p64 - thr) % (1 << 32))
    pw, vw = (np.bitwise_or.reduce(a.reshape(-1, 4).astype(np.uint64) << np.arange(0, 32, 8, dtype=np.uint64),
                                   axis=1) for a in (p64, v64))
    bright, dark = _bright_dark(vw, _centre(pw, thr))
    msb = lambda m: ((m[:, None] >> np.arange(7, 32, 8, dtype=np.uint64)) & np.uint64(1)).ravel() == 1
    np.testing.assert_array_equal(msb(bright), bright_ref)
    np.testing.assert_array_equal(msb(dark), dark_ref)
    # the plain version's own compares agree (its dark is the JAX kernel's `~br & ((d < 0) | (v < d))`)
    t = torch.from_numpy
    hi, lo = t(p64) + _threshold(thr), (t(p64) - _threshold(thr)) % (1 << 32)
    np.testing.assert_array_equal((t(v64) > hi).numpy(), bright_ref)
    np.testing.assert_array_equal((~(t(v64) > hi) & (t(v64) < lo)).numpy(), dark_ref)
    if thr == 20:  # the minimum and maximum of 16 samples' bytes by the u16 trick
        rng = np.random.default_rng(71)
        d = rng.integers(0, 1 << 32, (16, 4096), dtype=np.uint64)
        d[:, :256] &= np.uint64(0x0101FF00)  # ties, zeros and 255s
        want_min = _bytewise(np.minimum, d[0], d[0])
        want_max = want_min.copy()
        for row in d[1:]:
            want_min = _bytewise(np.minimum, want_min, row)
            want_max = _bytewise(np.maximum, want_max, row)
        np.testing.assert_array_equal(_by_u16(np.minimum, *d), want_min)
        np.testing.assert_array_equal(_by_u16(np.maximum, *d), want_max)


def _fast_replay(frames, thr):
    """``csrc/fast.cu`` in numpy on whole rows of words: each sample's word by
    ``__byte_perm`` of neighbouring words, the byte-lane compares, two words'
    bright and dark bits packed by bit-selects into one word a sample (garbage
    elsewhere), the AND-tree, the u16-trick minimum and NMS maximum, the keep
    bits and the packed keys.  Returns (score, key) as the plain version does."""
    n, h, w = frames.shape
    wp = -(-(w + 8) // 8) * 8  # 4 zero columns left, then whole pairs of words
    pad = np.zeros((n, h + 6, wp), np.uint8)
    pad[:, 3:h + 3, 4:w + 4] = frames
    words = pad.view(np.uint32).astype(np.uint64)  # words[..., i] holds columns 4i - 4 .. 4i - 1
    nw = words.shape[-1]
    col = np.arange(4 * nw).reshape(nw, 4) - 4
    colmask = np.bitwise_or.reduce(np.where((col >= 3) & (col < w - 3), 0xFF, 0).astype(np.uint64)
                                   << np.arange(0, 32, 8, dtype=np.uint64), axis=1)

    def sample(rows, dx):  # rows: (..., nw) words; the word of each word's pixels dx columns right
        prev = np.concatenate([np.zeros_like(rows[..., :1]), rows[..., :-1]], -1)
        nxt = np.concatenate([rows[..., 1:], np.zeros_like(rows[..., :1])], -1)
        if dx == 0:
            return rows
        return (_byte_perm(prev, rows, 0x3210 + (4 + dx) * 0x1111) if dx < 0
                else _byte_perm(rows, nxt, 0x3210 + dx * 0x1111))

    centre = words[:, 3:h + 3]
    cst = _centre(centre, thr)
    packed, dmin = [], []
    for dx, dy in _CIRCLE:
        v = sample(words[:, 3 + dy:h + 3 + dy], dx)
        bright, dark = _bright_dark(v, cst)
        acc = np.zeros(v.shape[:-1] + (nw // 2,), np.uint64)
        for k in range(2):  # a lane's two words into one
            for m, sh in ((bright[..., k::2], 2 * k), (dark[..., k::2], 2 * k + 1)):
                pos = _MSB >> np.uint64(sh)
                acc = (acc & ~pos & _M32) | ((m >> np.uint64(sh)) & pos)
        packed.append(acc)
        dmin.append(_bytewise(lambda a, b: np.abs(a - b), v, centre))
    run = _run9_tree(packed)
    corner = np.zeros_like(centre)
    for k in range(2):
        c = (((run << np.uint64(2 * k)) | (run << np.uint64(2 * k + 1))) & _MSB)
        corner[..., k::2] = _bytewise(lambda a, b: np.where(a >= 128, 255, 0), c, c)
    rows = np.arange(h)[None, :, None]
    score = _by_u16(np.minimum, *dmin) & corner & colmask & np.where((rows >= 3) & (rows < h - 3), _M32, 0)

    zero = np.zeros_like(score[:, :1])
    up = np.concatenate([zero, score[:, :-1]], 1)
    down = np.concatenate([score[:, 1:], zero], 1)
    ud = _by_u16(np.maximum, up, down, down)
    c3 = _by_u16(np.maximum, up, score, down)
    nb = _by_u16(np.maximum, sample(c3, -1), sample(c3, 1), ud)
    greater = _gt_msb(nb, score, ((nb | _MSB) - ((score & _LOW7) + _ONES)) & _M32)
    keep = (((score & _LOW7) + _LOW7) | score) & ~greater & _MSB
    s8 = score.astype(np.uint32).view(np.uint8).reshape(n, h, -1)[..., 4:w + 4]
    k8 = keep.astype(np.uint32).view(np.uint8).reshape(n, h, -1)[..., 4:w + 4] >= 128
    inv = h * w - np.arange(h * w, dtype=np.int64).reshape(h, w)
    return s8, np.where(k8, (inv << 8) | s8, 0)


@pytest.mark.parametrize("shape", [(2, 24, 37), (1, 9, 7), (1, 6, 40), (1, 40, 64)])
def test_fast_word_replay_vs_plain_and_jax(aruco, shape):
    """The whole of K6's word-level arithmetic, replayed, equals the plain
    version on random, checkerboard, two-level and dark frames at thresholds
    0 .. 2^31 - 1, and the JAX kernel (interpret mode) on aruco and random frames."""
    n, h, w = shape
    rng = np.random.default_rng(72)
    checker = np.broadcast_to((np.indices((h, w)).sum(0) % 2 * 255).astype(np.uint8), shape)
    cases = [rng.integers(0, 256, shape, dtype=np.uint8), checker,
             (rng.integers(0, 2, shape) * 255).astype(np.uint8), rng.integers(0, 4, shape, dtype=np.uint8)]
    for frames, thr in [(f, t) for f in cases for t in (0, 20, 255, 256, 2**31 - 1)]:
        frames = np.ascontiguousarray(frames)
        score, key = _fast_replay(frames, thr)
        s_ref, k_ref = K.fast(torch.from_numpy(frames.copy()), thr, want_score=True)
        np.testing.assert_array_equal(score, s_ref.numpy(), err_msg=f"thr {thr} score")
        np.testing.assert_array_equal(key, k_ref.numpy(), err_msg=f"thr {thr} key")
    if h >= 24:
        for imgs in (np.ascontiguousarray(aruco[None, 100:100 + h, 150:150 + w]), cases[0]):
            score, key = _fast_replay(imgs, 20)
            s_ref, k_ref = fast_pallas(jnp.asarray(imgs), 20, interpret=True)
            np.testing.assert_array_equal(score, np.asarray(s_ref))
            np.testing.assert_array_equal(key, np.asarray(k_ref))


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


def _bytes_of(words):
    return [(words >> (8 * b)) & 0xFF for b in range(4)]


def _dp4a(a, b, signed_b):
    """dp4a of the unsigned bytes of ``a`` and the (int8 or uint8) bytes of ``b``."""
    total = 0
    for pa, pb in zip(_bytes_of(a), _bytes_of(b)):
        total = total + pa * (((pb + 128) % 256) - 128 if signed_b else pb)
    return total


def _k7_row_weights(r):
    """``word_weights`` for every disc row i (dy = i - r) and word j: the packed
    int8 dx weights of the bytes with dx^2 <= r^2 - dy^2, and their mask of ones."""
    wx = np.zeros((2 * r + 1, 12), np.int64)
    ones = np.zeros_like(wx)
    for i in range(2 * r + 1):
        room = r * r - (i - r) ** 2
        for j in range(12):
            for b in range(4):
                dx = 4 * j + b - r
                if dx * dx <= room:
                    wx[i, j] |= (dx & 0xFF) << (8 * b)
                    ones[i, j] |= 1 << (8 * b)
    return wx, ones


def _orb_moments_replay(imgs, xs, ys, r, offset):
    """``csrc/patches.cu``'s K7 in numpy, lane by lane: a keypoint's warp
    splits as 8 lanes a row; lane (rq, c) takes rows rq, rq + 4, ... and words
    c and c + 8.  Inside the frame a word is two
    aligned 4-byte words of the batch (which starts ``offset`` bytes past a
    word boundary) funnel-shifted by the row's misalignment, reading only words
    that hold a byte of the row; near a border it is four bounds-tested bytes.
    Two dp4a a word against the weight table, m01 = sum dy * rowsum."""
    n, h, w = imgs.shape
    buf = np.zeros(-(-(offset + imgs.size) // 4) * 4, np.uint8)
    buf[offset:offset + imgs.size] = imgs.ravel()
    words = buf.view("<u4").astype(np.int64)
    wx, ones = _k7_row_weights(r)
    rows, nw = 2 * r + 1, (2 * r + 4) // 4
    frame = np.arange(n)[:, None] + np.zeros_like(xs)
    x, y, f = xs.astype(np.int64), ys.astype(np.int64), frame.astype(np.int64)
    inside = (x >= r) & (x + r < w) & (y >= r) & (y + r < h)

    def pixel(xx, yy):
        ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        return np.where(ok, imgs[f, np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)], 0).astype(np.int64)

    s01 = np.zeros(xs.shape, np.int64)
    s10 = np.zeros(xs.shape, np.int64)
    for lane in range(32):
        rq, c = divmod(lane, 8)
        for i in range(rq, rows, 4):
            start = offset + f * h * w + (y + i - r) * w + (x - r)
            mis = start & 3
            aligned = np.where(inside, (start - mis) // 4, 0)
            last = (mis + 2 * r) >> 2
            rowsum = np.zeros(xs.shape, np.int64)
            for j in (c, c + 8):
                if j >= nw:
                    continue
                lo = np.where(inside & (j <= last), words[np.clip(aligned + j, 0, len(words) - 1)], 0)
                hi = np.where(inside & (j + 1 <= last),
                              words[np.clip(aligned + j + 1, 0, len(words) - 1)], 0)
                v = ((hi << 32 | lo) >> (8 * mis)) & 0xFFFFFFFF
                guarded = sum(pixel(x - r + 4 * j + b, y + i - r) << (8 * b) for b in range(4))
                v = np.where(inside, v, guarded)
                rowsum = rowsum + _dp4a(v, ones[i, j], False)
                s10 = s10 + _dp4a(v, wx[i, j], True)
            s01 = s01 + (i - r) * rowsum
    return s01.astype(np.int32), s10.astype(np.int32)


@pytest.mark.parametrize("r", [0, 1, 15, 20])
@pytest.mark.parametrize("shape,offset", [((2, 64, 200), 0), ((2, 47, 61), 3)])
def test_orb_moments_word_replay_vs_plain_and_jax(r, shape, offset):
    """K7's words, funnel shifts and dp4a weights, replayed, equal
    ``orb_moments_plain`` and JAX's Pallas patches (interpret mode) reduced by
    the disc, on keypoints at every x mod 4 (and, with the odd width and the
    batch 3 bytes off a word, at every row misalignment) and at, near and past
    each border."""
    n, h, w = shape
    rng = np.random.default_rng(73 + r)
    imgs = rng.integers(0, 256, shape, dtype=np.uint8)
    xs, ys = _edge_points(h, w, rng, 8)
    near = [(r, r), (w - 1 - r, h - 1 - r), (r - 1, h // 2), (w - r, h // 2), (w // 2, r - 1),
            (w // 2, h - r), (-1, -1), (w, h), (-40, h // 2), (w + 25, 3)]
    every_mod = [(24 + i, 22 + i % 3) for i in range(8)]
    extra = np.array(near + every_mod, np.int32)
    xs = np.ascontiguousarray(np.concatenate([xs, np.stack([extra[:, 0], extra[::-1, 0]])], 1))
    ys = np.ascontiguousarray(np.concatenate([ys, np.stack([extra[:, 1], extra[::-1, 1]])], 1))
    m01, m10 = _orb_moments_replay(imgs, xs, ys, r, offset)
    p01, p10 = K.orb_moments_plain(torch.from_numpy(imgs), torch.from_numpy(xs),
                                   torch.from_numpy(ys), r)
    np.testing.assert_array_equal(m01, p01.numpy())
    np.testing.assert_array_equal(m10, p10.numpy())
    patches = np.asarray(extract_patches_batched(jnp.asarray(imgs), jnp.asarray(xs),
                                                 jnp.asarray(ys), interpret=True)).astype(np.int64)
    dy, dx = np.mgrid[-20:28, -20:28]
    disc = dx * dx + dy * dy <= r * r
    # the Pallas helper clips a patch's start into its padded frame, so it
    # keeps the zero-padding contract for keypoints inside the frame only (its
    # callers clamp: features.py:650-669)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    np.testing.assert_array_equal(m01[ok], (patches * dy * disc).sum((-2, -1))[ok])
    np.testing.assert_array_equal(m10[ok], (patches * dx * disc).sum((-2, -1))[ok])


def _orb_brief_replay(imgs, xs, ys, sin, cos, offset, split):
    """``csrc/patches.cu``'s K8 in numpy: a keypoint's eight words split over
    ``split`` warps, lane l of a warp rotating pair 32 j + l of each of its
    words.  A warp whose endpoints all lie within 20 of a keypoint whose 41 x 41
    window is in the frame reads each sample at ``centre + dy * w + dx`` of the
    batch (which starts ``offset`` bytes into its buffer) with no bounds test;
    any other warp reads through ``pixel()`` with the 48 x 48 patch's bounds.
    Bit i of word j compares pair 32 j + i."""
    n, h, w = imgs.shape
    buf = np.zeros(offset + imgs.size, np.uint8)
    buf[offset:] = imgs.ravel()
    frame = (np.arange(n)[:, None] + np.zeros_like(xs)).astype(np.int64)[..., None]
    x, y = xs.astype(np.int64)[..., None], ys.astype(np.int64)[..., None]
    pat = BRIEF_PATTERN.astype(np.float32)
    px = np.concatenate([pat[:, 0], pat[:, 2]])
    py = np.concatenate([pat[:, 1], pat[:, 3]])
    s, c = sin[..., None], cos[..., None]
    dx = np.trunc(px * c - py * s).astype(np.int64)  # float32: each operation rounds
    dy = np.trunc(px * s + py * c).astype(np.int64)
    far = (np.abs(dx) > 20) | (np.abs(dy) > 20)  # (n, k, 512): both endpoints of each pair
    part = (np.arange(256) // 32) // (8 // split)  # the warp of each pair
    far_pair = far[..., :256] | far[..., 256:]
    outside = np.stack([far_pair[..., part == q].any(-1) for q in range(split)], -1)[..., part]
    inside = (x >= 20) & (x + 20 < w) & (y >= 20) & (y + 20 < h)
    direct = np.tile(inside & ~outside, 2)  # (n, k, 512)
    centre = offset + frame * h * w + y * w + x
    flat = np.where(direct, centre + dy * w + dx, 0)
    in_patch = (dx >= -20) & (dx < 28) & (dy >= -20) & (dy < 28)
    gx, gy = x + dx, y + dy
    in_frame = in_patch & (gx >= 0) & (gx < w) & (gy >= 0) & (gy < h)
    guarded = np.where(in_frame, imgs[frame, np.clip(gy, 0, h - 1), np.clip(gx, 0, w - 1)], 0)
    vals = np.where(direct, buf[np.clip(flat, 0, buf.size - 1)], guarded).astype(np.int64)
    bits = (vals[..., :256] > vals[..., 256:]).reshape(n, -1, 8, 32).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


@pytest.mark.parametrize("trig", ["exact_host"], indirect=True)
@pytest.mark.parametrize("split", [1, 4])
@pytest.mark.parametrize("shape,offset", [((2, 64, 200), 0), ((2, 47, 61), 3), ((1, 45, 30), 1),
                                          ((2, 61, 203), 2)])
def test_orb_brief_gather_replay_vs_plain_and_jax(trig, shape, offset, split):
    """K8's gathers (unchecked inside the frame, bounds-tested near or past a
    border) with a keypoint's words on one warp or split over four, replayed,
    equal ``orb_brief_plain`` and JAX's ``_brief_single`` (exact-host trig in
    both packages) at, near and past each border, at every x mod 4, at angles
    0, +-pi, +-pi/2 and random; and equal ``orb_brief_plain`` for sin and cos
    off the unit circle, where endpoints pass 20."""
    n, h, w = shape
    rng = np.random.default_rng(91 + offset)
    imgs = rng.integers(0, 256, shape, dtype=np.uint8)
    pts = [(0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1), (w // 2, 0), (0, h // 2), (19, 19),
           (20, 20), (21, 21), (w - 20, h - 20), (w - 21, h - 21), (-1, -1), (w, h), (-20, 5),
           (-21, 5), (w + 20, 7), (w + 19, 7), (-30, -25), (w + 60, -1), (5, h + 2), (15, 15),
           (w - 16, h - 16)] + [(24 + i, 22 + i % 3) for i in range(8)]
    xs = np.array([p[0] for p in pts] + rng.integers(-25, w + 25, 18).tolist(), np.int32)
    ys = np.array([p[1] for p in pts] + rng.integers(-25, h + 25, 18).tolist(), np.int32)
    xs, ys = np.stack([xs, xs[::-1]])[:n].copy(), np.stack([ys, ys[::-1]])[:n].copy()
    special = np.float32([0.0, np.pi, -np.pi, np.pi / 2, -np.pi / 2])
    angles = np.concatenate([special, rng.uniform(-np.pi, np.pi, xs.shape[1] - len(special))])
    angles = np.stack([angles, angles[::-1]])[:n].astype(np.float32)
    a = torch.from_numpy(angles)
    sin, cos = libm32.sinf(a).numpy(), libm32.cosf_like_reference(a).numpy()
    got = _orb_brief_replay(imgs, xs, ys, sin, cos, offset, split)
    t = [torch.from_numpy(v) for v in (imgs, xs, ys, sin, cos)]
    np.testing.assert_array_equal(got, K.orb_brief_plain(*t).view(torch.int32).numpy()
                                  .view(np.uint32))
    single = jax.vmap(_brief_single, in_axes=(None, 0, 0, 0))
    for f in range(n if split == 1 else 0):  # the split changes no sample: JAX once
        ref = single(jnp.asarray(imgs[f]), jnp.asarray(xs[f]), jnp.asarray(ys[f]),
                     jnp.asarray(angles[f]))
        np.testing.assert_array_equal(got[f], np.asarray(ref).astype(np.uint32))
    scale = np.float32([1.0, 1.45, 0.5, 1.02, 2.0])[np.arange(xs.shape[1]) % 5]
    s2, c2 = (sin * scale).astype(np.float32), (cos * scale[::-1]).astype(np.float32)
    got = _orb_brief_replay(imgs, xs, ys, s2, c2, offset, split)
    t = [torch.from_numpy(v) for v in (imgs, xs, ys, s2, c2)]
    np.testing.assert_array_equal(got, K.orb_brief_plain(*t).view(torch.int32).numpy()
                                  .view(np.uint32))


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
