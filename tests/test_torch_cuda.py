"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without a CUDA device.  The file imports no
JAX, so it also runs where only PyTorch is installed::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Every output is an integer or a bool (angles are compared by their bits) and
the Otsu sweep is bit-exact, so the tolerance is 0.

``host_arrays_on_cpu`` is the autouse fixture of every ``tests/test_torch_*.py``
file (the others import it): numpy inputs to the port run on the CPU there.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

import grayskull_tpu_torch as gt
from grayskull_tpu_torch import kernels as K
from grayskull_tpu_torch import libm32, profiling
from grayskull_tpu_torch.core import LbpCascade, host_arrays_to
from grayskull_tpu_torch.ops.lbp import _grid_plan

SHAPES = [(2, 24, 128), (1, 97, 200), (1, 7, 8), (1, 17, 129), (2, 816, 612)]
NO_DENSE = {"adaptive": 0, "morph": 0, "filter3": 0, "resize": 0}  # K11-K14 not launched
NO_SHARDED = {"blur_hist_window": 0, "threshold_sobel_window": 0, "copy": 0,  # K15-K18 neither
              "triad": 0, "match_template": 0, "contour": 0,  # nor K19, K20
              "quad_warp_rows": 0,  # nor K10's rows entry
              "freestanding": 0}  # nor K21
COPY_SIZES = [1, 15, 16, 17, 63, 64, 65, 2047, 2048, 2049, 4095, 4096, 4097, 12295, 16383, 16384,
              16385, 2**20 + 3, 2**26]
COPY_OFFSETS = (0, 1, 4, 8)  # bytes the operands start past a 16-byte boundary


def otsu_edge_histograms():
    """(name, hist, total): the sweep's corner cases, total = sum of counts."""
    cases = {}
    one = np.zeros(256, np.int64)
    one[77] = 1000  # all pixels in one bin: the wf == 0 break on the first live bin
    cases["one_bin"] = one
    zero = np.zeros(256, np.int64)
    zero[0] = 500  # everything black
    cases["bin_0"] = zero
    top = np.zeros(256, np.int64)
    top[255] = 321  # everything white: 255 leading empty bins
    cases["bin_255"] = top
    lead = np.zeros(256, np.int64)
    lead[120:140] = 7  # empty leading bins, then a block
    cases["leading_empty"] = lead
    tie = np.zeros(256, np.int64)
    tie[[10, 20, 30]] = 5  # symmetric: tied variances, first max wins
    cases["tie3"] = tie
    two = np.zeros(256, np.int64)
    two[[0, 255]] = 9
    cases["two_ends"] = two
    big = np.zeros(256, np.int64)
    big[[3, 200]] = [1 << 24 | 1, 5]  # counts past float32's exact integers
    cases["big_counts"] = big
    return [(k, v, int(v.sum())) for k, v in cases.items()]


def otsu_batch_histograms():
    """(name, (N, 256) int32 counts, total), each with its own total: 1 MP
    multinomial frames, the same with totals the counts do not sum to, counts
    whose running weight wraps past 2^32 (the bin where it reaches 0 is
    skipped though its term is not 0), and all-zero frames."""
    rng = np.random.default_rng(73)
    total = 1 << 20
    random = rng.multinomial(total, rng.dirichlet(np.full(256, 0.3), size=40)).astype(np.int32)
    big = 2**31 - 1
    wrap = np.zeros((4, 256), np.int64)
    wrap[0, [0, 1, 2]] = [big, big, 2]
    wrap[1, [0, 1, 2, 100]] = [big, big, 2, 5]
    wrap[2, [5, 9, 30, 31, 200]] = [big, big, 1, 1, 7]
    wrap[3, [10, 11, 12, 13]] = [big, big, 2, 9]
    wrap = wrap.astype(np.int32)
    zero = np.zeros((3, 256), np.int32)
    return [("multinomial_1MP", random, total), ("total_below_counts", random, total - 1),
            ("total_above_counts", random, total + 4099), ("wrap_total_1000", wrap, 1000),
            ("wrap_total_9", wrap, 9), ("wrap_total_0", wrap, 0), ("wrap_total_max", wrap, big),
            ("all_zero", zero, 0), ("all_zero_total_77", zero, 77)]


def synthetic_cascade():
    """``tests/test_lbp.py``'s 8x8 cascade: 3 features, 4 weaks, a back-loaded stage split."""
    rng = np.random.default_rng(5)
    nweaks = 4
    return LbpCascade(
        window_w=8, window_h=8,
        features=np.array([[0, 0, 2, 2], [1, 1, 2, 2], [2, 0, 1, 2]], np.int8),
        weak_feature_idx=np.array([0, 2, 1, 0], np.uint16),
        weak_left_val=rng.uniform(-1, 0, nweaks).astype(np.float32),
        weak_right_val=rng.uniform(0, 1, nweaks).astype(np.float32),
        weak_subset_offset=np.arange(0, 8 * nweaks, 8, dtype=np.uint16),
        weak_num_subsets=np.full(nweaks, 8, np.uint16),
        subsets=rng.integers(-2**31, 2**31, 8 * nweaks, dtype=np.int64).astype(np.int32),
        stage_weak_start=np.array([0, 1], np.uint16),
        stage_nweaks=np.array([1, 3], np.uint16),
        stage_threshold=np.array([-0.2, 0.1], np.float32),
    )


@pytest.fixture(autouse=True)
def host_arrays_on_cpu():
    """Host arrays handed to the port go to the CPU for the test's duration."""
    with host_arrays_to("cpu"):
        yield


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _frames(shape, seed, device):
    frames = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    return torch.from_numpy(frames).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_on_card(cuda_device, shape):
    imgs = _frames(shape, 16, cuda_device)
    for r in (0, 1, 2, 6, 7, 16, 300):
        got = K.blur_hist(imgs, r)
        ref = K.blur_hist_plain(imgs, r)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), r
    t = torch.from_numpy(np.arange(shape[0], dtype=np.uint8) * 60 + 70).to(cuda_device)
    for thr, wb in ((None, True), (t, True), (t, False)):
        got = K.threshold_sobel(imgs, thr, wb)
        ref = K.threshold_sobel_plain(imgs, thr, wb)
        assert torch.equal(got[1], ref[1])
        assert (got[0] is None) == (ref[0] is None)
        if got[0] is not None:
            assert torch.equal(got[0], ref[0])
    hists = K.frame_histograms(imgs)
    total = shape[1] * shape[2]
    assert torch.equal(K.otsu(hists, total), K.otsu_plain(hists, total))


@pytest.mark.cuda
def test_otsu_edge_cases_on_card(cuda_device):
    """The sweep's corner cases, wrapped weights and totals the counts do not
    sum to, each with 16-byte-aligned rows and with rows 4 bytes off."""
    cases = [(name, hist[None], tot) for name, hist, tot in otsu_edge_histograms()]
    for name, hists, total in cases + otsu_batch_histograms():
        h = torch.from_numpy(hists.astype(np.int32)).to(cuda_device)
        off = torch.zeros(h.numel() + 1, dtype=torch.int32, device=cuda_device)[1:].view(h.shape)
        off.copy_(h)
        for x in (h, off):
            assert torch.equal(K.otsu(x, total), K.otsu_plain(x, total)), (name, x.data_ptr() % 16)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [1, 8, 33, 65537])
def test_otsu_frame_counts_on_card(cuda_device, frames):
    """A part of one block, whole blocks and a part, and many blocks."""
    _, random, total = otsu_batch_histograms()[0]
    h = torch.from_numpy(np.resize(random, (frames, 256))).to(cuda_device)
    assert torch.equal(K.otsu(h, total), K.otsu_plain(h, total))


@pytest.mark.cuda
def test_preprocess_launches_every_kernel_on_card(cuda_device):
    imgs = _frames((4, 300, 260), 17, cuda_device)
    K.reset_launch_counts()
    out = gt.preprocess(imgs)
    counts = K.launch_counts()
    assert counts == {"blur_hist": 1, "otsu": 1, "threshold_sobel": 1, "integral": 0,
                      "lbp_eval_scale": 0, "fast": 0, "orb_moments": 0, "orb_brief": 0,
                      "ccl": 0, "quad_warp": 0, "blob_stats": 0, "blob_stats_global": 0,
                      **NO_DENSE, **NO_SHARDED}
    ref = gt.preprocess(imgs, force_reference=True)
    assert K.launch_counts() == counts
    for a, b in zip(out, ref):
        assert a.is_cuda and torch.equal(a, b)
    on_cpu = gt.preprocess(imgs.cpu())
    for a, b in zip(out, on_cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_wrappers_raise_on_card(cuda_device):
    imgs = _frames((2, 8, 8), 18, cuda_device)
    with pytest.raises(ValueError):
        K.threshold_sobel(imgs, torch.zeros(2, dtype=torch.uint8))  # thresholds on the CPU
    with pytest.raises(ValueError):
        K.blur_hist(imgs[:, :, ::2], 1)


def _bits(ii):
    return ii.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 7, 8), (2, 97, 200), (3, 1, 40), (1, 17, 129),
                                   (4, 480, 640)])
def test_integral_matches_plain_on_card(cuda_device, shape):
    imgs = _frames(shape, 30, cuda_device)
    got = K.integral(imgs)
    assert got.dtype == torch.uint32 and got.is_cuda
    assert torch.equal(_bits(got), _bits(K.integral_plain(imgs)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 15, 64), (2, 16, 64), (2, 17, 64), (1, 33, 3), (3, 1, 1),
                                   (1, 1, 1025), (1, 40, 1), (1, 9, 5), (1, 9, 17), (2, 70, 1024),
                                   (1, 70, 1028), (1, 33, 2049), (32, 120, 640)])
def test_integral_bands_and_chunks_on_card(cuda_device, shape):
    """K4's shape classes: one band and several, a last band of 1 to 15 rows,
    widths around a thread's 4 columns (the 4-byte path or the byte path) and
    past a block's 1024, one row, one column, integral_sharded's shard."""
    imgs = _frames(shape, 33, cuda_device)
    assert torch.equal(_bits(K.integral(imgs)), _bits(K.integral_plain(imgs)))


@pytest.mark.cuda
def test_integral_unaligned_batches_on_card(cuda_device):
    """K4's byte path for frames that start 1 .. 4 bytes into their buffer, and
    for ``[1:]`` of a contiguous batch of 479 x 639 frames (an odd offset)."""
    for shape in ((2, 65, 640), (3, 33, 129)):
        for off in (1, 2, 3, 4):
            imgs = _unaligned(shape, off, 34 + off, cuda_device)
            assert torch.equal(_bits(K.integral(imgs)), _bits(K.integral_plain(imgs))), (shape, off)
    imgs = _frames((33, 479, 639), 39, cuda_device)[1:]
    assert imgs.is_contiguous() and imgs.data_ptr() % 2 == 1
    assert torch.equal(_bits(K.integral(imgs)), _bits(K.integral_plain(imgs)))


@pytest.mark.cuda
def test_integral_wraps_on_card(cuda_device):
    imgs = torch.full((1, 4200, 4200), 255, dtype=torch.uint8, device=cuda_device)
    got = K.integral(imgs)
    assert torch.equal(_bits(got), _bits(K.integral_plain(imgs)))
    assert int(_bits(got)[0, -1, -1]) % 2**32 == (255 * 4200 * 4200) % 2**32


@pytest.mark.cuda
@pytest.mark.parametrize("step", [1, 2, 3])
def test_lbp_eval_scale_matches_plain_on_card(cuda_device, step):
    cas = gt.load_frontalface()
    ii = K.integral(_frames((2, 90, 130), 31, cuda_device))
    for scale, _, _, ny, nx in _grid_plan(cas, 90, 130, 1.2, 1.0, 4.0, step):
        got = K.lbp_eval_scale(cas, ii, scale, ny, nx, step)
        assert got.dtype == torch.bool and got.is_cuda
        assert torch.equal(got, K.lbp_eval_scale_plain(cas, ii, scale, ny, nx, step)), scale
    for origin in ((0, 0), (33, 70), (66, 106)):
        assert torch.equal(K.lbp_eval_scale(cas, ii, 1.0, 1, 1, 1, origin),
                           K.lbp_eval_scale_plain(cas, ii, 1.0, 1, 1, 1, origin)), origin
    syn = synthetic_cascade()
    sii = K.integral(_frames((2, 40, 256), 32, cuda_device))
    for scale in (1.0, 1.5):
        win = int(np.float32(8) * np.float32(scale))
        ny, nx = (40 - win) // step + 1, (256 - win) // step + 1
        assert torch.equal(K.lbp_eval_scale(syn, sii, scale, ny, nx, step),
                           K.lbp_eval_scale_plain(syn, sii, scale, ny, nx, step)), scale


@pytest.mark.cuda
def test_lbp_eval_scale_edge_cases_on_card(cuda_device):
    """A frame smaller than one tile, 97x200 at steps 1-3, the full 640x480
    ladder (its last scales stage more than 48 KB of integral), the four
    corner windows through lbp_window, and cascades that every window passes
    (full queues) or fails at stage 0 (empty queues)."""
    cas = gt.load_frontalface()
    lena = gt.io.read_pgm(__file__.rsplit("/", 1)[0] + "/golden/testdata/lena.pgm")
    big = torch.from_numpy(np.stack([np.tile(lena, (4, 5))[:480, :640]] * 2)).to(cuda_device)
    cases = [(_frames((2, 30, 40), 34, cuda_device), (1, 2)),
             (_frames((2, 97, 200), 35, cuda_device), (1, 2, 3)), (big, (1, 2, 3))]
    for frames, steps in cases:
        ii = K.integral(frames)
        h, w = frames.shape[1:]
        for step in steps:
            for scale, _, _, ny, nx in _grid_plan(cas, h, w, 1.2, 1.0, 4.0, step):
                assert torch.equal(K.lbp_eval_scale(cas, ii, scale, ny, nx, step),
                                   K.lbp_eval_scale_plain(cas, ii, scale, ny, nx, step)), (h, step)
    plan = _grid_plan(cas, 480, 640, 1.2, 1.0, 4.0, 1)
    for scale, win_w, win_h, _, _ in (plan[0], plan[-1]):
        for y, x in ((0, 0), (0, 640 - win_w), (480 - win_h, 0), (480 - win_h, 640 - win_w)):
            got = gt.lbp_window(cas, ii[0], x, y, scale)
            assert got.is_cuda and bool(got) == bool(gt.lbp_window(cas, ii[0].cpu(), x, y, scale))
    for threshold, expect in ((-np.inf, True), (np.inf, False)):
        uniform = dataclasses.replace(cas, stage_threshold=np.full(cas.nstages, threshold,
                                                                   np.float32))
        for scale, _, _, ny, nx in plan:
            got = K.lbp_eval_scale(uniform, ii, scale, ny, nx, 1)
            assert torch.equal(got, K.lbp_eval_scale_plain(uniform, ii, scale, ny, nx, 1))
            assert bool(got.all()) == expect and bool(got.any()) == expect


# K11's offsets: both ends of int32 and where (int)(mean - c) starts and stops wrapping
ADAPTIVE_CS = (-2**31, -2**31 + 255, -2**31 + 256, -3, 0, 5, 2**31 - 1)
EDGE_SHAPES = [(1, 9, 1), (1, 9, 15), (1, 9, 16), (1, 9, 17), (1, 9, 31), (1, 9, 33), (1, 1, 1),
               (1, 1, 9), (2, 5, 1)]


def _sobel_cases(imgs, t):
    """K2 without thresholds, with them, and with them but no binary map."""
    for thr, wb in ((None, True), (t, True), (t, False)):
        got, ref = K.threshold_sobel(imgs, thr, wb), K.threshold_sobel_plain(imgs, thr, wb)
        assert torch.equal(got[1], ref[1]) and (got[0] is None) == (ref[0] is None), thr is None
        assert got[0] is None or torch.equal(got[0], ref[0])


def _adaptive_cases(imgs, radii=(0, 15, 16, 300)):
    for r in radii:
        for c in ADAPTIVE_CS:
            got = K.adaptive(imgs, r, c)
            assert got.is_cuda and torch.equal(got, K.adaptive_plain(imgs, r, c)), (r, c)


def _window_sobel_cases(imgs, t, h_total):
    """K16 at the first, a middle and the last row offset, with and without binary."""
    h = imgs.shape[1]
    for row0 in (-1, 4, h_total + 1 - h):
        for want_binary in (True, False):
            got = K.threshold_sobel_window(imgs, t, row0, h_total=h_total, want_binary=want_binary)
            ref = K.threshold_sobel_window_plain(imgs, t, row0, h_total=h_total,
                                                 want_binary=want_binary)
            assert torch.equal(got[1], ref[1]) and (got[0] is None) == (ref[0] is None), row0
            assert got[0] is None or torch.equal(got[0], ref[0]), row0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 7), (1, 40, 129), (2, 816, 612), (1, 70, 1000)]
                         + EDGE_SHAPES)
def test_blur_kernels_on_widths_past_16_byte_words_on_card(cuda_device, shape):
    """K1 and K15 where rows are no whole 16-byte words, at radii 1 to 40; K15
    at the first, a middle and the last row offset with random halo rows; K11,
    K2 and K16 on the same frames."""
    n, h, w = shape
    imgs = _frames(shape, 74, cuda_device)
    h_total = h + 8
    for r in (1, 2, 6, 16, 40):
        for with_hist in (True, False):
            got, ref = K.blur_hist(imgs, r, with_hist), K.blur_hist_plain(imgs, r, with_hist)
            assert torch.equal(got[0], ref[0]) and (got[1] is None) == (ref[1] is None), r
            assert got[1] is None or torch.equal(got[1], ref[1]), r
        kw = {"h_total": h_total, "row_lo": min(r, h), "row_hi": max(min(r, h), h - r)}
        for row0 in (-r, 4, h_total + r - h):
            got = K.blur_hist_window(imgs, row0, r, **kw)
            ref = K.blur_hist_window_plain(imgs, row0, r, **kw)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (r, row0)
    t = torch.from_numpy(np.arange(n, dtype=np.uint8) * 70 + 60).to(cuda_device)
    _adaptive_cases(imgs)
    _sobel_cases(imgs, t)
    _window_sobel_cases(imgs, t, h_total)


@pytest.mark.cuda
def test_stencil_kernels_on_an_unaligned_batch_on_card(cuda_device):
    """``x[1:]`` of a contiguous (3, 7, 9) batch starts 63 bytes in: K1, K11,
    K2, K15, K16, K12 and K13 take their byte paths on it."""
    x = _frames((3, 7, 9), 75, cuda_device)[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    t = torch.tensor([200, 31], dtype=torch.uint8, device=cuda_device)
    for r in (1, 2, 6):
        got, ref = K.blur_hist(x, r), K.blur_hist_plain(x, r)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), r
        kw = {"h_total": 15, "row_lo": 1, "row_hi": 6}
        got, ref = K.blur_hist_window(x, 4, r, **kw), K.blur_hist_window_plain(x, 4, r, **kw)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), r
    _adaptive_cases(x)
    _sobel_cases(x, t)
    _window_sobel_cases(x, t, 15)
    _stencil3_cases(x)


@pytest.mark.cuda
def test_detect_faces_launches_its_kernels_on_card(cuda_device):
    lena = gt.io.read_pgm(__file__.rsplit("/", 1)[0] + "/golden/testdata/lena.pgm")
    frames = torch.from_numpy(np.stack([lena, lena[:, ::-1].copy()])).to(cuda_device)
    K.reset_launch_counts()
    out = gt.detect_faces(frames, step=2)
    nscales = len(_grid_plan(gt.load_frontalface(), 128, 128, 1.2, 1.0, 4.0, 2))
    assert K.launch_counts() == {"blur_hist": 0, "otsu": 0, "threshold_sobel": 0,
                                 "integral": 1, "lbp_eval_scale": nscales, "fast": 0,
                                 "orb_moments": 0, "orb_brief": 0, "ccl": 0, "quad_warp": 0,
                                 "blob_stats": 0, "blob_stats_global": 0, **NO_DENSE,
                                 **NO_SHARDED}
    ref = gt.detect_faces(frames, step=2, force_reference=True)
    assert K.launch_counts()["lbp_eval_scale"] == nscales
    on_cpu = gt.detect_faces(frames.cpu(), step=2)
    for a, b, c in zip(out, ref, on_cpu):
        assert a.is_cuda and torch.equal(a, b) and torch.equal(a.cpu(), c)
    assert out.n.tolist()[0] == 7  # lena at step 2
    window = gt.lbp_window(gt.load_frontalface(), gt.integral(frames[0]), 65, 57, 1.2)
    assert window.is_cuda and K.launch_counts()["lbp_eval_scale"] == nscales + 1


@pytest.mark.cuda
def test_faces_wrappers_raise_on_card(cuda_device):
    imgs = _frames((2, 30, 30), 33, cuda_device)
    with pytest.raises(ValueError):
        K.integral(imgs[:, :, ::2])
    with pytest.raises(TypeError):
        K.integral(imgs.to(torch.int32))
    ii = K.integral(imgs)
    cas = gt.load_frontalface()
    with pytest.raises(ValueError):
        K.lbp_eval_scale(cas, ii[:, :, ::2], 1.0, 1, 1)
    with pytest.raises(TypeError):
        K.lbp_eval_scale(cas, ii.view(torch.int32), 1.0, 1, 1)


def _orb_frames(shape, seed, device):
    """Random bytes, a period-2 checkerboard (every corner ties) and a dark frame
    (p < thr: C's unsigned p - thr wraps), stacked on the frame axis."""
    n, h, w = shape
    rng = np.random.default_rng(seed)
    checker = (np.indices((h, w)).sum(0) % 2 * 255).astype(np.uint8)
    frames = [rng.integers(0, 256, shape, dtype=np.uint8),
              np.broadcast_to(checker, shape), rng.integers(0, 4, shape, dtype=np.uint8)]
    return torch.from_numpy(np.concatenate(frames)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 24, 128), (1, 97, 200), (1, 7, 8), (1, 17, 129),
                                   (2, 480, 640)])
def test_fast_matches_plain_on_card(cuda_device, shape):
    imgs = _orb_frames(shape, 40, cuda_device)
    for thr in (0, 5, 20, 60, 200, -4):
        score, key = K.fast(imgs, thr, want_score=True)
        ref_score, ref_key = K.fast_plain(imgs, thr, want_score=True)
        assert key.dtype == torch.int32 and key.is_cuda
        assert torch.equal(score, ref_score) and torch.equal(key, ref_key), thr
    assert K.fast(imgs, 20)[0] is None


@pytest.mark.cuda
def test_fast_wide_keys_on_card(cuda_device):
    imgs = _orb_frames((1, 2900, 2900), 41, cuda_device)[:1]
    key = K.fast(imgs, 20)[1]
    assert key.dtype == torch.int64
    assert torch.equal(key, K.fast_plain(imgs, 20)[1])


def _unaligned(shape, offset, seed, device):
    """Frames of ``shape`` that start ``offset`` bytes into a larger buffer."""
    flat = _frames((int(np.prod(shape)) + 16,), seed, device)
    return flat[offset:offset + int(np.prod(shape))].view(shape)


@pytest.mark.cuda
def test_fast_edges_on_card(cuda_device):
    """K6 at widths 7 .. 40 and 641 (segments of 240 columns, rows no multiple
    of 4 or 16), frames under 7 rows, frames at byte offsets 1 .. 15 (the byte
    path), 65,537 frames and the int64 keys of an unaligned frame; keys alone
    equal the keys made beside the score map."""
    cases = [_orb_frames((1, 20, w), 42 + w, cuda_device) for w in range(7, 41)]
    cases += [_orb_frames((2, 30, 641), 43, cuda_device), _orb_frames((2, 6, 50), 44, cuda_device),
              _orb_frames((1, 3, 9), 45, cuda_device)]
    cases += [_unaligned((2, 33, 100), off, 46 + off, cuda_device) for off in range(1, 16)]
    cases.append(_frames((65537, 7, 9), 48, cuda_device))  # past the old grid's z
    for imgs in cases:
        for thr in (0, 20, 256):
            score, key = K.fast(imgs, thr, want_score=True)
            ref_score, ref_key = K.fast_plain(imgs, thr, want_score=True)
            assert torch.equal(score, ref_score) and torch.equal(key, ref_key), (imgs.shape, thr)
            assert torch.equal(K.fast(imgs, thr)[1], key), (imgs.shape, thr)
    wide = _unaligned((1, 2900, 2900), 3, 47, cuda_device)
    key = K.fast(wide, 20)[1]
    assert key.dtype == torch.int64 and torch.equal(key, K.fast_plain(wide, 20)[1])


@pytest.mark.cuda
def test_orb_moments_and_brief_match_plain_on_card(cuda_device):
    rng = np.random.default_rng(42)
    h, w = 64, 200
    imgs = _frames((2, h, w), 43, cuda_device)
    edge = [(0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1), (19, 19), (20, 20), (w - 20, h - 20),
            (-30, -25), (w + 4, h + 30), (w + 60, -1)]
    xs = np.array([p[0] for p in edge] + rng.integers(0, w, 54).tolist(), np.int32)
    ys = np.array([p[1] for p in edge] + rng.integers(0, h, 54).tolist(), np.int32)
    x = torch.from_numpy(np.stack([xs, xs[::-1]])).to(cuda_device)
    y = torch.from_numpy(np.stack([ys, ys[::-1]])).to(cuda_device)
    for r in (15, 0, 20):
        for a, b in zip(K.orb_moments(imgs, x, y, r), K.orb_moments_plain(imgs, x, y, r)):
            assert a.is_cuda and torch.equal(a, b), r
    angles = np.concatenate([[0.0, np.pi, -np.pi], rng.uniform(-np.pi, np.pi, 61)])
    a = torch.from_numpy(np.stack([angles, angles[::-1]]).astype(np.float32)).to(cuda_device)
    s, c = libm32.sinf(a), libm32.cosf_like_reference(a)
    got = K.orb_brief(imgs, x, y, s, c)
    assert got.dtype == torch.uint32 and got.is_cuda
    assert torch.equal(got.view(torch.int32), K.orb_brief_plain(imgs, x, y, s, c).view(torch.int32))


def _brief_keypoints(rng, h, w, k, device):
    """(2, k) int32 keypoints: at, near and past each border, at every x mod 4,
    then random ones from 25 pixels before the frame to 25 past it."""
    pts = [(0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1), (19, 19), (20, 20), (21, 21),
           (w - 20, h - 20), (w - 21, h - 21), (-1, -1), (w, h), (-20, 5), (-21, 5), (w + 20, 7),
           (w + 19, 7), (-30, -25), (w + 60, -1), (5, h + 2), (15, 15), (w - 16, h - 16)]
    pts += [(24 + i, 22 + i % 3) for i in range(8)]
    xs = np.array([p[0] for p in pts] + rng.integers(-25, w + 25, k - len(pts)).tolist(), np.int32)
    ys = np.array([p[1] for p in pts] + rng.integers(-25, h + 25, k - len(pts)).tolist(), np.int32)
    return (torch.from_numpy(np.stack([xs, xs[::-1]]).copy()).to(device),
            torch.from_numpy(np.stack([ys, ys[::-1]]).copy()).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_orb_brief_every_misalignment_on_card(cuda_device, offset):
    """K8 on frames of odd width in batches that start 0 .. 3 bytes into their
    buffer (every row misalignment), keypoints at every x mod 4 and at, near
    and past each border (windows in the frame or not), angles 0, +-pi, +-pi/2
    and random; then sin and cos off the unit circle (endpoints past 20, read
    as the 48 x 48 patch reads them)."""
    rng = np.random.default_rng(48 + offset)
    h, w = 61, 203
    imgs = _unaligned((2, h, w), offset, 49, cuda_device) if offset else _frames((2, h, w), 49,
                                                                                 cuda_device)
    x, y = _brief_keypoints(rng, h, w, 64, cuda_device)
    angles = np.concatenate([[0.0, np.pi, -np.pi, np.pi / 2, -np.pi / 2],
                             rng.uniform(-np.pi, np.pi, 59)])
    a = torch.from_numpy(np.stack([angles, angles[::-1]]).astype(np.float32)).to(cuda_device)
    s, c = libm32.sinf(a), libm32.cosf_like_reference(a)
    scale = torch.tensor([1.0, 1.45, 0.5, 1.02, 2.0], device=cuda_device).repeat(13)[:64]
    for s_, c_ in ((s, c), (s * scale, c * scale.flip(0))):
        got = K.orb_brief(imgs, x, y, s_, c_)
        assert torch.equal(got.view(torch.int32),
                           K.orb_brief_plain(imgs, x, y, s_, c_).view(torch.int32))


@pytest.mark.cuda
def test_orb_brief_past_the_grid_cap_on_card(cuda_device):
    """K8 with a warp a keypoint (32 keypoints an SM or more) and more keypoints
    than its capped grid has warps (8 blocks of 4 warps an SM), so warps walk
    over several keypoints; the other tests' calls split each keypoint over
    four warps."""
    rng = np.random.default_rng(50)
    h, w = 61, 203
    imgs = _frames((2, h, w), 51, cuda_device)
    x, y = _brief_keypoints(rng, h, w, 5000, cuda_device)
    assert x.numel() > 2 * 32 * torch.cuda.get_device_properties(cuda_device).multi_processor_count
    a = torch.from_numpy(rng.uniform(-np.pi, np.pi, (2, 5000)).astype(np.float32)).to(cuda_device)
    s, c = libm32.sinf(a), libm32.cosf_like_reference(a)
    got = K.orb_brief(imgs, x, y, s, c)
    assert torch.equal(got.view(torch.int32), K.orb_brief_plain(imgs, x, y, s, c).view(torch.int32))


def _bits_of(table):
    return [v.view(torch.int32) if v.dtype in (torch.float32, torch.uint32) else v for v in table]


@pytest.mark.cuda
def test_orb_extract_on_card_matches_cpu_exact_host(cuda_device):
    lena = gt.io.read_pgm(__file__.rsplit("/", 1)[0] + "/golden/testdata/lena.pgm")
    frames = torch.from_numpy(np.stack([lena, np.roll(lena, 9, axis=1)])).to(cuda_device)
    K.reset_launch_counts()
    out = gt.orb_extract(frames, 300, 20)
    counts = K.launch_counts()
    assert {k: counts[k] for k in ("fast", "orb_moments", "orb_brief")} == {
        "fast": 1, "orb_moments": 1, "orb_brief": 1}
    ref = gt.orb_extract(frames, 300, 20, force_reference=True)
    for a, b in zip(_bits_of(out), _bits_of(ref)):
        assert a.is_cuda and torch.equal(a, b)
    libm32.use_exact_host_libm(True)
    try:
        on_card = gt.orb_extract(frames, 300, 20)
        on_cpu = gt.orb_extract(frames.cpu(), 300, 20)
        tk, sk, m = gt.track(frames[0, :100, :120], frames[1], max_kps=400)
        ck = gt.track(frames[0, :100, :120].cpu(), frames[1].cpu(), max_kps=400)
    finally:
        libm32.use_exact_host_libm(False)
    for a, b in zip(_bits_of(on_card), _bits_of(on_cpu)):
        assert torch.equal(a.cpu(), b)
    for got, want in zip((tk, sk, m), ck):
        for a, b in zip(_bits_of(got), _bits_of(want)):
            assert torch.equal(a.cpu(), b)


def snake():
    """A snake zigzagging between 8-row strips (``tests/test_blobs_contour.py:427``)."""
    sn = np.zeros((16, 128), np.uint8)
    for i, x in enumerate(range(0, 128, 8)):
        sn[:, x] = 255
        sn[15 if i % 2 == 0 else 0, x: x + 9] = 255
    return sn


def spiral(h, w, gap=4):
    """A one-arm rectangular spiral whose minimum must flow down and up
    repeatedly (``tests/test_blobs_contour.py:440-450``)."""
    sp = np.zeros((h, w), np.uint8)
    top, bot, lef, rig = 0, h - 1, 0, w - 1
    while top <= bot and lef <= rig:
        sp[top, lef:rig + 1] = 255
        sp[top:bot + 1, rig] = 255
        sp[bot, lef:rig + 1] = 255
        sp[top:bot + 1, lef] = 255
        top += gap
        bot -= gap
        lef += gap
        rig -= gap
        if lef <= rig:
            sp[top - gap + 1:top + 1, lef] = 255
    return sp


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 4096), (1, 4096, 1), (1, 7, 8), (2, 17, 129),
                                   (3, 768, 1024)])
def test_ccl_matches_plain_on_card(cuda_device, shape):
    rng = np.random.default_rng(50)
    for density in (0.3, 0.55, 0.6):
        imgs = torch.from_numpy(((rng.random(shape) < density) * 255).astype(np.uint8))
        got = K.ccl(imgs.to(cuda_device))
        assert got.dtype == torch.int32 and got.is_cuda
        assert torch.equal(got.cpu(), K.ccl_plain(imgs)), density


@pytest.mark.cuda
def test_ccl_spiral_and_full_frames_on_card(cuda_device):
    frames = torch.from_numpy(np.stack([spiral(512, 512), np.full((512, 512), 255, np.uint8),
                                        np.zeros((512, 512), np.uint8)])).to(cuda_device)
    got = K.ccl(frames)
    assert torch.equal(got, K.ccl_plain(frames))
    assert int(got[1].max()) == 0 and int(got[2].min()) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 67, 129), (2, 67, 257), (1, 67, 1023), (65537, 4, 8)])
def test_ccl_past_tile_widths_and_frame_grid_on_card(cuda_device, shape):
    """K9 at widths one past one and two of its 128-wide tiles and odd, and on
    65,537 frames (past grid.y's 65,535)."""
    rng = np.random.default_rng(51)
    for density in (0.3, 0.55, 0.6):
        imgs = torch.from_numpy(((rng.random(shape) < density) * 255).astype(np.uint8))
        assert torch.equal(K.ccl(imgs.to(cuda_device)).cpu(), K.ccl_plain(imgs)), density


@pytest.mark.cuda
def test_ccl_comb_across_every_tile_border_on_card(cuda_device):
    comb = np.zeros((520, 1000), np.uint8)
    comb[:, ::2] = 255
    comb[::37, :] = 255
    bars_removed = np.where(np.arange(520)[:, None] % 37 == 0, 0, comb).astype(np.uint8)
    frames = torch.from_numpy(np.stack([comb, bars_removed])).to(cuda_device)
    got = K.ccl(frames)
    assert torch.equal(got, K.ccl_plain(frames))
    assert int(got[0].max()) == 0  # one component, every tile border crossed


@pytest.mark.cuda
@pytest.mark.parametrize("r", [0, 1, 15, 20])
def test_orb_moments_every_x_mod_4_and_edges_on_card(cuda_device, r):
    """K7's words on a frame of odd width (every row misalignment), keypoints
    at every x mod 4 and at, near and past each border."""
    rng = np.random.default_rng(44)
    h, w = 61, 203
    imgs = _frames((2, h, w), 45, cuda_device)
    pts = [(0, 0), (w - 1, h - 1), (r, r), (w - 1 - r, h - 1 - r), (r - 1, 30), (w - r, 30),
           (100, r - 1), (100, h - r), (-1, -1), (w, h), (-40, 30), (w + 25, 3)]
    pts += [(24 + i, 25 + i % 5) for i in range(16)] + [(164 + i, 21 + i % 7) for i in range(8)]
    xs = np.array([p[0] for p in pts] + rng.integers(0, w, 20).tolist(), np.int32)
    ys = np.array([p[1] for p in pts] + rng.integers(0, h, 20).tolist(), np.int32)
    x = torch.from_numpy(np.stack([xs, xs[::-1]])).to(cuda_device)
    y = torch.from_numpy(np.stack([ys, ys[::-1]])).to(cuda_device)
    for a, b in zip(K.orb_moments(imgs, x, y, r), K.orb_moments_plain(imgs, x, y, r)):
        assert a.is_cuda and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [0, 1, 15, 20])
def test_orb_moments_large_call_every_x_mod_4_and_edges_on_card(cuda_device, r):
    """K7's instance for calls with a 1024-thread block for every SM (weights
    from the block's shared table): 2 x 2,500 keypoints on a frame of odd width,
    at every x mod 4, at, near and past each border, and a third of them with
    the whole r = 20 disc inside."""
    rng = np.random.default_rng(46)
    h, w, k = 61, 203, 2500
    imgs = _frames((2, h, w), 47, cuda_device)
    pts = [(0, 0), (w - 1, h - 1), (r, r), (w - 1 - r, h - 1 - r), (r - 1, 30), (w - r, 30),
           (100, r - 1), (100, h - r), (-1, -1), (w, h), (-40, 30), (w + 25, 3)]
    pts += [(24 + i, 25 + i % 5) for i in range(16)] + [(164 + i, 21 + i % 7) for i in range(8)]
    inner = (k - len(pts)) // 3
    xs = np.concatenate([[p[0] for p in pts], rng.integers(20, w - 20, inner),
                         rng.integers(-25, w + 25, k - len(pts) - inner)]).astype(np.int32)
    ys = np.concatenate([[p[1] for p in pts], rng.integers(20, h - 20, inner),
                         rng.integers(-25, h + 25, k - len(pts) - inner)]).astype(np.int32)
    x = torch.from_numpy(np.stack([xs, xs[::-1]]).copy()).to(cuda_device)
    y = torch.from_numpy(np.stack([ys, ys[::-1]]).copy()).to(cuda_device)
    assert x.numel() >= torch.cuda.get_device_properties(cuda_device).multi_processor_count * 32
    for a, b in zip(K.orb_moments(imgs, x, y, r), K.orb_moments_plain(imgs, x, y, r)):
        assert a.is_cuda and torch.equal(a, b)


@pytest.mark.cuda
def test_quad_warp_matches_plain_on_card(cuda_device):
    src = _frames((2, 300, 260), 51, cuda_device)
    quads = [[[20, 15], [240, 30], [230, 280], [10, 290]], [[0, 0], [259, 0], [259, 299], [0, 299]],
             [[-50, -40], [400, -10], [300, 500], [-30, 350]], [[200, 10], [10, 20], [30, 250], [250, 270]]]
    for q in quads:
        c = torch.tensor([q, q[::-1]], dtype=torch.int32, device=cuda_device)
        for size in ((1000, 800), (347, 200), (1, 10), (10, 1), (1, 1), (37, 3)):
            got = K.quad_warp(src, c, size)
            assert got.is_cuda and torch.equal(got, K.quad_warp_plain(src, c, size)), (q, size)


@pytest.mark.cuda
def test_quad_warp_rows_matches_plain_on_card(cuda_device):
    """K10's rows entry: bands at the top, the middle and the bottom, one-row
    bands, pages of one row or one column, a band of a page's last tile."""
    src = _frames((2, 300, 260), 58, cuda_device)
    c = torch.tensor([[[20, 15], [240, 30], [230, 280], [10, 290]],
                      [[200, 10], [10, 20], [30, 250], [250, 270]]], dtype=torch.int32,
                     device=cuda_device)
    for size, bands in (((1000, 800), ((0, 250), (250, 250), (750, 250), (999, 1), (0, 1))),
                        ((347, 200), ((0, 347), (100, 247), (346, 1))), ((1, 10), ((0, 1),)),
                        ((10, 1), ((0, 10), (3, 4)))):
        whole = K.quad_warp(src, c, size)
        for row0, rows in bands:
            got = K.quad_warp_rows(src, c, size, row0, rows)
            assert got.is_cuda and torch.equal(got, whole[:, row0:row0 + rows]), (size, row0)
            assert torch.equal(got, K.quad_warp_rows_plain(src, c, size, row0, rows))


@pytest.mark.cuda
def test_quad_warp_tiles_and_tails_on_card(cuda_device):
    """K10's tiles and stores: page widths 1 .. 17 and 4k +- 1 (rows that start
    on every byte offset mod 16, tails of a warp's 128 columns), sources of one
    row and one column, 65,537 frames (past grid.y's 65,535), a frame wider
    than 2^23, frames of 2^24 + 4 columns and rows with quads past their far
    edge (the template with clamped reads) and a frame of 2^31 + 1 bytes."""
    rng = np.random.default_rng(53)

    def quads(n, sh, sw):
        lo, hi = (-(sw // 2) - 2, -(sh // 2) - 2), (sw + sw // 2 + 2, sh + sh // 2 + 2)
        return torch.from_numpy(rng.integers(lo, hi, (n, 4, 2)).astype(np.int32)).to(cuda_device)

    cases = [(_frames((2, 97, 200), 54, cuda_device), (37, w))
             for w in list(range(1, 18)) + [4 * k + d for k in (8, 50, 200) for d in (-1, 1)]]
    for shape in ((2, 1, 300), (2, 300, 1)):
        cases += [(_frames(shape, 55, cuda_device), page) for page in ((37, 61), (1, 9), (9, 1))]
    cases.append((_frames((65537, 7, 9), 56, cuda_device), (3, 5)))
    for src, size in cases:
        c = quads(*src.shape)
        got = K.quad_warp(src, c, size)
        assert got.is_cuda and torch.equal(got, K.quad_warp_plain(src, c, size)), (src.shape, size)
    gen = torch.Generator(device=cuda_device).manual_seed(57)
    for shape in ((1, 3, 2**23 + 5), (1, 2, 2**24 + 4), (1, 2**24 + 4, 2), (1, 3, 715827883)):
        wide = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8, device=cuda_device)
        sh, sw = shape[1:]
        for q, size in (([[0, 0], [sw - 1, 0], [sw - 1, sh - 1], [0, sh - 1]], (5, 1001)),
                        ([[max(sw - 40, 0), max(sh - 40, 0)], [sw + 100, max(sh - 40, 0)],
                          [sw + 100, sh + 100], [max(sw - 40, 0), sh + 100]], (7, 203))):
            c = torch.tensor([q], dtype=torch.int32, device=cuda_device)
            got = K.quad_warp(wide, c, size)
            assert torch.equal(got, K.quad_warp_plain(wide, c, size)), (shape, q, size)
        del wide


@pytest.mark.cuda
def test_scan_launches_its_kernels_on_card(cuda_device):
    doc = gt.io.read_pgm(__file__.rsplit("/", 1)[0] + "/golden/testdata/document.pgm")
    frames = torch.from_numpy(np.stack([np.roll(doc, 3 * i, axis=1) for i in range(3)]))
    K.reset_launch_counts()
    pages, corners = gt.scan(frames.to(cuda_device))
    assert K.launch_counts() == {"blur_hist": 1, "otsu": 1, "threshold_sobel": 0, "integral": 0,
                                 "lbp_eval_scale": 0, "fast": 0, "orb_moments": 0,
                                 "orb_brief": 0, "ccl": 1, "quad_warp": 1, "blob_stats": 1,
                                 "blob_stats_global": 0, **NO_DENSE, **NO_SHARDED}
    ref = gt.scan(frames.to(cuda_device), force_reference=True)
    on_cpu = gt.scan(frames)
    for a, b, c in zip((pages, corners), ref, on_cpu):
        assert a.is_cuda and torch.equal(a, b) and torch.equal(a.cpu(), c)


# K22's cases: named label maps (each an (N, P) int32 map of labels below nseg)
BLOB_STATS_CASES = ["noise_500_labels", "past_the_cap_zeroed", "nseg_1", "all_background",
                    "slab_row0_700", "sums_past_2_32", "nseg_past_the_shared_table",
                    "width_7_scalar_loads", "dense_page_blob"]


def document_labels(n, device):
    """``scan``'s label map of ``n`` document pages rolled 3*i columns, 1000 labels."""
    doc = gt.io.read_pgm(__file__.rsplit("/", 1)[0] + "/golden/testdata/document.pgm")
    frames = torch.from_numpy(np.stack([np.roll(doc, 3 * i, axis=1) for i in range(n)]))
    labels = gt.blobs(gt.preprocess_binarize(frames.to(device)), 1000)[1]
    return labels.to(torch.int32).view(n, -1), 1001, doc.shape[1], 0


def blob_stats_case(name, device):
    """(seg, nseg, w, row0) of one of K22's cases (``BLOB_STATS_CASES``, or
    ``document_<pages>``) on ``device``."""
    if name.startswith("document_"):
        return document_labels(int(name.split("_")[1]), device)
    rng = np.random.default_rng(BLOB_STATS_CASES.index(name) + 60)
    if name == "noise_500_labels":  # hundreds of labels, most of them small
        seg, nseg, w, row0 = rng.integers(0, 500, (3, 61 * 83)), 500, 83, 0
    elif name == "past_the_cap_zeroed":  # labels past a cap of 600 dropped to 0, as blobs does
        seg = rng.integers(0, 2000, (2, 90 * 120))
        seg, nseg, w, row0 = np.where(seg <= 600, seg, 0), 601, 120, 0
    elif name == "nseg_1":
        seg, nseg, w, row0 = np.zeros((2, 33 * 47)), 1, 47, 0
    elif name == "all_background":
        seg, nseg, w, row0 = np.zeros((2, 64 * 96)), 1001, 96, 0
    elif name == "slab_row0_700":  # a sparse slab: n = 1, rows counted from 700, runs of 8
        seg = np.repeat(rng.integers(0, 40, (1, 256 * 768 // 8)), 8, axis=1)
        seg, nseg, w, row0 = seg, 40, 768, 700
    elif name == "sums_past_2_32":  # one label on 2100 x 2100: sum_x, sum_y past 2^32
        seg, nseg, w, row0 = np.ones((1, 2100 * 2100)), 2, 2100, 0
    elif name == "nseg_past_the_shared_table":  # 7000 labels: the global-atomics path
        seg, nseg, w, row0 = rng.integers(0, 7000, (2, 100 * 128)), 7000, 128, 0
    elif name == "width_7_scalar_loads":  # P % 4 != 0: quads cross rows and frames
        seg = np.repeat(rng.integers(0, 6, (3, 11 * 7 // 3 + 1)), 3, axis=1)[:, :11 * 7]
        seg, nseg, w, row0 = seg, 6, 7, 0
    elif name == "dense_page_blob":  # one label under most pixels, holes and other blobs
        page = np.ones((1024, 768), np.int64)
        page[::9, ::7] = 0
        page[100:300, 50:400] = 2
        page[600:, 500:] = 3
        seg, nseg, w, row0 = np.stack([page, np.roll(page, 5, 1)]).reshape(2, -1), 1001, 768, 0
    else:
        raise KeyError(name)
    return torch.from_numpy(np.ascontiguousarray(seg, np.int32)).to(device), nseg, w, row0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["document_1", "document_16", "document_32", *BLOB_STATS_CASES])
def test_blob_stats_matches_plain_on_card(cuda_device, name):
    """K22 against its plain version, all seven outputs equal, at a 16-byte-aligned
    label map and at one 4 bytes off (scalar loads); the launch counted under
    its path's key."""
    seg, nseg, w, row0 = blob_stats_case(name, cuda_device)
    key = K.blobs.path(nseg)
    assert (key == "blob_stats_global") == (name == "nseg_past_the_shared_table")
    want = K.blob_stats_plain(seg, nseg, w, row0)
    off = torch.zeros(seg.numel() + 1, dtype=torch.int32, device=cuda_device)[1:].view(seg.shape)
    off.copy_(seg)
    for x in (seg, off):
        got, counts = _no_sync(K.blob_stats, x, nseg, w, row0)
        assert counts == {key: 1}, x.data_ptr() % 16
        for field, a, b in zip(("area", "sum_x", "sum_y", "min_x", "min_y", "max_x", "max_y"),
                               got, want):
            assert a.dtype == torch.int64 and torch.equal(a, b), (field, x.data_ptr() % 16)
    if name == "sums_past_2_32":
        assert int(want[1][0, 1]) >= 2**32


@pytest.mark.cuda
def test_scan_reduces_its_blobs_in_one_launch_without_a_sync_on_card(cuda_device):
    doc = gt.io.read_pgm(__file__.rsplit("/", 1)[0] + "/golden/testdata/document.pgm")
    frames = torch.from_numpy(np.stack([np.roll(doc, 7 * i, axis=1) for i in range(5)]))
    frames = frames.to(cuda_device)
    want = gt.scan(frames, force_reference=True)
    got, counts = _no_sync(gt.scan, frames)
    assert counts == {"blur_hist": 1, "otsu": 1, "ccl": 1, "blob_stats": 1, "quad_warp": 1}
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_spans_count_the_launches_of_a_scan_call_on_card(cuda_device):
    """In a profiled ``scan`` call on the card each kernel's ``gs.kernels.<key>``
    spans equal its launch counter's rise; the call's output is unchanged."""
    doc = gt.io.read_pgm(__file__.rsplit("/", 1)[0] + "/golden/testdata/document.pgm")
    frames = torch.from_numpy(np.stack([np.roll(doc, 5 * i, axis=1) for i in range(4)]))
    frames = frames.to(cuda_device)
    want = gt.scan(frames)
    profiling.clear_spans()
    K.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        got = gt.scan(frames)
        torch.cuda.synchronize()
    counts = {k: v for k, v in K.launch_counts().items() if v}
    spans = collections.Counter(s.name.removeprefix("gs.kernels.") for s in profiling.spans()
                                if s.name.startswith("gs.kernels."))
    assert counts == dict(spans) == {"blur_hist": 1, "otsu": 1, "ccl": 1, "blob_stats": 1,
                                     "quad_warp": 1}
    assert len({s.call for s in profiling.spans()}) == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_spans_count_the_launches_of_a_detect_faces_call_on_card(cuda_device):
    """In a profiled ``detect_faces`` call on the card K4's and K5's
    ``gs.kernels.<key>`` spans equal their launch counters' rise, under one
    ``gs.pipelines.detect_faces`` span; the windows counter rises by the
    ladder's windows; the call's output is unchanged."""
    from grayskull_tpu_torch.ops import lbp as lbp_ops

    frames = _frames((3, 120, 161), 71, cuda_device)
    want = gt.detect_faces(frames)
    plan = _grid_plan(gt.load_frontalface(), 120, 161, 1.2, 1.0, 4.0, 1)
    profiling.clear_spans()
    K.reset_launch_counts()
    windows = lbp_ops.counters["windows"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        got = gt.detect_faces(frames)
        torch.cuda.synchronize()
    counts = {k: v for k, v in K.launch_counts().items() if v}
    spans = collections.Counter(s.name.removeprefix("gs.kernels.") for s in profiling.spans()
                                if s.name.startswith("gs.kernels."))
    assert counts == dict(spans) == {"integral": 1, "lbp_eval_scale": len(plan)}
    assert len({s.call for s in profiling.spans()}) == 1
    assert lbp_ops.counters["windows"] - windows == 3 * sum(ny * nx for *_, ny, nx in plan)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_chip_smoke_profiles_the_same_device_work_with_spans_as_without(cuda_device,
                                                                         monkeypatch):
    """``chip_smoke.profile_calls`` on ``preprocess`` counts the same device
    events a call, and the same kernels, with the ``gs.`` spans recording as
    with them turned off: the spans' device copies are not counted."""
    import types

    import chip_smoke

    batch = _frames((8, 256, 320), 61, cuda_device)
    profiling.clear_spans()
    on = chip_smoke.profile_calls(gt.preprocess, batch, 2)
    assert {s.name for s in profiling.spans()} >= {"gs.pipelines.preprocess",
                                                    "gs.kernels.blur_hist"}
    monkeypatch.setattr(profiling, "_autograd_profiler",
                        types.SimpleNamespace(_is_profiler_enabled=False))
    profiling.clear_spans()
    off = chip_smoke.profile_calls(gt.preprocess, batch, 2)
    assert profiling.spans() == []
    assert on["device_launches_a_call"] == off["device_launches_a_call"]
    assert on["device_kernels"] == off["device_kernels"]
    assert ({name for name, _ in on["device_ms_by_kernel"]}
            == {name for name, _ in off["device_ms_by_kernel"]})


@pytest.mark.cuda
def test_host_arrays_go_to_the_card(cuda_device):
    img = np.random.default_rng(52).integers(0, 256, (2, 40, 56), dtype=np.uint8)
    with host_arrays_to(None):
        assert gt.as_image(img).is_cuda
        out = gt.blur(img, 1)
        pages, corners = gt.scan(img, out_size=(20, 10))
    assert out.is_cuda and pages.is_cuda and corners.is_cuda
    assert torch.equal(out.cpu(), gt.blur(img, 1))


DENSE_TAPS = [(((0, -1, 0), (-1, 5, -1), (0, -1, 0)), 1), (((-2, -1, 0), (-1, 1, 1), (0, 1, 2)), 1),
              (((1, 1, 1),) * 3, 9), (((1, 2, 1), (2, 4, 2), (1, 2, 1)), 16),
              (((-1, -2, -1), (0, 0, 0), (1, 2, 1)), 1), (((-1, -2, -1), (0, 0, 0), (1, 2, 1)), 7),
              (((300, -1000, 5), (0, 70000, 0), (1, 2, -99999)), 3),
              # the int8 edge (K13's dp4a path) and just past it (its multiply-add path)
              (((127, -128, 127), (-128, 127, -128), (127, -128, 127)), 2),
              (((128, -129, 0), (1, 2, 3), (-129, 0, 128)), 5)]


def _stencil3_cases(imgs):
    """K12 both ways and K13 with every DENSE_TAPS entry."""
    for op in ("erode", "dilate"):
        assert torch.equal(K.morph(imgs, op), K.morph_plain(imgs, op)), op
    for taps, norm in DENSE_TAPS:
        assert torch.equal(K.filter3(imgs, taps, norm), K.filter3_plain(imgs, taps, norm)), taps


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(1, 40, 1024), (2, 64, 7), (1, 70, 1000), (1, 1, 1),
                                            (1, 1, 9), (2, 5, 1)])
def test_dense_kernels_match_plain_on_card(cuda_device, shape):
    """K11-K13; K12 and K13 on their 16-byte (1024 and 128 wide), 4-byte (612,
    1000, 200 and 8) and byte paths (7, 129 and the one-pixel, one-row and
    one-column frames)."""
    imgs = _frames(shape, 60, cuda_device)
    for r in (0, 1, 2, 6, 15, 40, 300):
        for c in (-3, 0, 5, 40, -2**31):
            got = K.adaptive(imgs, r, c)
            assert got.is_cuda and torch.equal(got, K.adaptive_plain(imgs, r, c)), (r, c)
    _stencil3_cases(imgs)


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", [((1024, 1024), (480, 640)), ((480, 640), (768, 1024)),
                                     ((480, 640), (347, 200)), ((200, 256), (200, 256)),
                                     ((816, 612), (100, 40)), ((1, 1), (5, 7)), ((7, 1), (3, 9))])
def test_resize_matches_plain_on_card(cuda_device, src, dst):
    imgs = _frames((2,) + src, 61, cuda_device)
    got = K.resize(imgs, dst)
    assert got.is_cuda and tuple(got.shape) == (2,) + dst
    assert torch.equal(got, K.resize_plain(imgs, dst))
    assert torch.equal(got.cpu(), K.resize_plain(imgs.cpu(), dst))


@pytest.mark.cuda
def test_resize_edges_on_card(cuda_device):
    """K14 on sources at byte offsets 1 .. 15 (the L1 path), output widths no
    multiple of 4 or 16, outputs wider than a block's tile and sources wider
    than a staged segment, 65,537 frames (past the grid's z) and, through the
    C entry, destinations at byte offsets 1 .. 15."""
    from grayskull_tpu_torch.kernels import _build

    for off in range(1, 16):
        imgs = _unaligned((2, 64, 1008), off, 63 + off, cuda_device)
        for dst in ((30, 630), (40, 1000), (13, 7), (70, 1501)):
            assert torch.equal(K.resize(imgs, dst), K.resize_plain(imgs, dst)), (off, dst)
    for src in ((2, 97, 200), (2, 480, 640)):
        imgs = _frames(src, 64, cuda_device)
        for dw in (1, 2, 3, 5, 17, 33, 639, 641, 1001):
            assert torch.equal(K.resize(imgs, (35, dw)), K.resize_plain(imgs, (35, dw))), (src, dw)
    for src, dst in (((1, 4, 16000), (3, 9000)), ((1, 4, 16384), (3, 2000)),
                     ((1, 3, 5000), (2, 20000)), ((65537, 3, 5), (2, 7)),
                     ((65537, 2, 16), (3, 32))):
        imgs = _frames(src, 65, cuda_device)
        assert torch.equal(K.resize(imgs, dst), K.resize_plain(imgs, dst)), (src, dst)
    lib, imgs = _build.library(), _frames((3, 96, 160), 66, cuda_device)
    ref = K.resize_plain(imgs, (50, 97)).view(-1)
    for off in range(1, 16):
        out = torch.zeros(ref.numel() + 16, dtype=torch.uint8, device=cuda_device)
        _build.check(lib.gs_resize(imgs.data_ptr(), out.data_ptr() + off, 3, 96, 160, 50, 97,
                                   _build.stream_of(imgs)), "resize")
        assert torch.equal(out[off:off + ref.numel()], ref), off
        assert not out[:off].any() and not out[off + ref.numel():].any(), off


@pytest.mark.cuda
def test_adaptive_morph_launches_its_kernels_on_card(cuda_device):
    """BASELINE config #2 on two receipt frames: K11 once, K12 twice, no other kernel."""
    rec = gt.io.read_pgm(__file__.rsplit("/", 1)[0] + "/golden/testdata/receipt.pgm")
    frames = torch.from_numpy(np.stack([rec, np.roll(rec, 5, axis=1)]))
    K.reset_launch_counts()
    out = gt.erode(gt.dilate(gt.adaptive_threshold(frames.to(cuda_device), 15, 5)))
    assert K.launch_counts() == {"blur_hist": 0, "otsu": 0, "threshold_sobel": 0, "integral": 0,
                                 "lbp_eval_scale": 0, "fast": 0, "orb_moments": 0,
                                 "orb_brief": 0, "ccl": 0, "quad_warp": 0, "adaptive": 1,
                                 "morph": 2, "filter3": 0, "resize": 0, "blob_stats": 0,
                                 "blob_stats_global": 0, **NO_SHARDED}
    on_cpu = gt.erode(gt.dilate(gt.adaptive_threshold(frames, 15, 5)))
    assert out.is_cuda and torch.equal(out.cpu(), on_cpu)


@pytest.mark.cuda
def test_cli_on_card_matches_cpu(cuda_device, tmp_path):
    from grayskull_tpu_torch import cli

    lena = __file__.rsplit("/", 1)[0] + "/golden/testdata/lena.pgm"
    for args in (["adaptive", "15", "5"], ["morph", "dilate", "2"], ["sobel"],
                 ["resize", "100", "40"], ["blobs", "50"], ["scan"]):
        paths = []
        for where in (None, "cpu"):
            out = tmp_path / f"{args[0]}_{where}.pgm"
            with host_arrays_to(where):
                assert cli.main(["nanomagick", *args, lena, str(out)]) == 0
            paths.append(out)
        assert paths[0].read_bytes() == paths[1].read_bytes(), args


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + EDGE_SHAPES + [(2, 258, 1024)])
def test_window_kernels_match_plain_on_card(cuda_device, shape):
    """K15 and K16 at the first, a middle and the last row offset of a frame 8
    rows taller than the array (random halo rows: K15's means pass 255 there);
    K11 and K2 on the same frames."""
    n, h, w = shape
    imgs = _frames(shape, 70, cuda_device)
    t = torch.from_numpy(np.arange(n, dtype=np.uint8) * 70 + 60).to(cuda_device)
    h_total = h + 8
    for r in (1, 2, 6, 16):
        kw = {"h_total": h_total, "row_lo": min(r, h), "row_hi": max(min(r, h), h - r)}
        for row0 in (-r, 4, h_total + r - h):
            got = K.blur_hist_window(imgs, row0, r, **kw)
            ref = K.blur_hist_window_plain(imgs, row0, r, **kw)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (r, row0)
    _window_sobel_cases(imgs, t, h_total)
    _adaptive_cases(imgs)
    _sobel_cases(imgs, t)


@pytest.mark.cuda
@pytest.mark.parametrize("size", COPY_SIZES)
def test_copy_and_triad_match_plain_on_card(cuda_device, size):
    """Sizes around one thread's vector (16 bytes) and one 256-thread block's
    (4096: K17's and K18's span a block; 12295 is three blocks and a 7-byte
    tail), and the 64, 2048 and 16384 bytes of chip_sweep.py's chunked
    variants, the pointers 16-byte aligned, then 1, 4 and 8 bytes off."""
    x, y = (_frames((size + 8,), 71 + i, cuda_device) for i in range(2))
    for off in COPY_OFFSETS:
        a, b = x[off:off + size], y[off:off + size]
        assert torch.equal(K.copy(a), K.copy_plain(a)), off
        assert torch.equal(K.triad(a, b), K.triad_plain(a, b)), off


@pytest.mark.cuda
def test_sharded_preprocess_launches_on_card(cuda_device):
    """A (1, 4) mesh of one card: K15 4 times, K3 once, K16 4 times, the
    single-device result; the same on a CPU mesh."""
    imgs = _frames((3, 256, 200), 72, cuda_device)
    mesh = gt.parallel.make_mesh((1, 4), devices=[cuda_device] * 4)
    K.reset_launch_counts()
    out = gt.parallel.preprocess_spatial_shardmap(imgs, mesh, 3)
    counts = {k: v for k, v in K.launch_counts().items() if v}
    assert counts == {"blur_hist_window": 4, "otsu": 1, "threshold_sobel_window": 4}
    on_cpu = gt.parallel.preprocess_spatial_shardmap(
        imgs.cpu(), gt.parallel.make_mesh((1, 4), devices=["cpu"] * 4), 3)
    for a, b, c in zip(out, gt.preprocess(imgs, 3), on_cpu):
        assert a.is_cuda and torch.equal(a, b) and torch.equal(a.cpu(), c)
    ii = gt.parallel.integral_sharded(imgs, mesh)
    assert torch.equal(ii.view(torch.int32), gt.integral(imgs).view(torch.int32))


def _offset_frames(shape, offset, seed, device):
    """Random frames that start ``offset`` bytes into a larger buffer on ``device``."""
    size = int(np.prod(shape))
    flat = np.random.default_rng(seed).integers(0, 256, size + 16, dtype=np.uint8)
    return torch.from_numpy(flat).to(device)[offset:offset + size].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tshape", [((2, 30, 41), (5, 7)), ((3, 17, 131), (4, 8)),
                                          ((1, 30, 41), (30, 41)), ((2, 9, 258), (1, 1)),
                                          ((2, 40, 300), (13, 17)), ((1, 260, 300), (257, 257)),
                                          ((1, 12, 7400), (9, 7339)), ((70000, 3, 5), (2, 3)),
                                          ((1, 24600, 2), (24577, 1))])
def test_match_template_matches_plain_on_card(cuda_device, shape, tshape):
    """K19 at odd byte offsets, at the template limit (66,049 and 66,051 pixels,
    past the default 48 KB of shared memory), with a template staged in two
    chunks, past 65,535 frames, and a 1x1 map."""
    for offset in (0, 1, 3):
        frames = _offset_frames(shape, offset, sum(shape) + offset, cuda_device)
        tmpl = _offset_frames(tshape, 0, 7, cuda_device)
        got = K.match_template(frames, tmpl)
        assert got.is_cuda and torch.equal(got, K.match_template_plain(frames, tmpl)), offset
    big = torch.zeros((1, 10, 20000), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        K.match_template(big, torch.zeros((4, 16513), dtype=torch.uint8, device=cuda_device))


def _no_sync(fn, *args):
    """``fn(*args)`` with the counts at 0 and any host sync raising; the counts after."""
    torch.cuda.synchronize()
    K.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, {k: v for k, v in K.launch_counts().items() if v}


@pytest.mark.cuda
def test_match_template_and_best_match_on_card(cuda_device):
    lena = gt.io.read_pgm(__file__.rsplit("/", 1)[0] + "/golden/testdata/lena.pgm")
    frames = torch.from_numpy(np.stack([np.roll(lena, 11 * i, axis=1) for i in range(6)]))
    tmpl = frames[0, 100:132, 60:92].contiguous()
    scores, counts = _no_sync(gt.match_template, frames.to(cuda_device), tmpl.to(cuda_device))
    assert counts == {"match_template": 1}
    assert torch.equal(scores.cpu(), gt.match_template(frames, tmpl))
    x, y = gt.find_best_match(scores)
    assert x.is_cuda and x.dtype == torch.int32
    for a, b in zip((x, y), gt.find_best_match(gt.match_template(frames, tmpl))):
        assert torch.equal(a.cpu(), b)
    assert int(scores[0, y[0], x[0]]) == 255
    ties = np.random.default_rng(3).integers(0, 3, (4, 2, 37, 53), dtype=np.uint8)
    ties[1, 1] = 0
    for a, b in zip(gt.find_best_match(torch.from_numpy(ties).to(cuda_device)),
                    gt.find_best_match(torch.from_numpy(ties))):
        assert torch.equal(a.cpu(), b)


def _twelve_blobs():
    """``benchmarks/bench_all.py:255-258``: 12 rectangles on 480 x 640."""
    img = np.zeros((480, 640), np.uint8)
    for r in range(3):
        for c in range(4):
            img[120 * r + 20:120 * r + 100, 160 * c + 30:160 * c + 130] = 255
    return img


def _contour_frames():
    noise = ((np.random.default_rng(0).random((12, 12)) > 0.45) * 255).astype(np.uint8)
    dense = ((np.random.default_rng(1).random((64, 80)) > 0.5) * 255).astype(np.uint8)
    large = np.zeros((965, 965), np.uint8)  # past K20's shared-memory bitmaps: the byte path
    large[:480, :640] = _twelve_blobs()
    large[600:900, 100:960] = 255
    return {"spiral": spiral(40, 128), "spiral_256": spiral(256, 256), "snake": snake(),
            "noise_step_bound": noise, "noise_64x80": dense, "twelve_blobs": _twelve_blobs(),
            "large_965x965": large}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["spiral", "spiral_256", "snake", "noise_step_bound",
                                  "noise_64x80", "twelve_blobs", "large_965x965"])
def test_contour_matches_plain_on_card(cuda_device, name):
    """K20 in its three modes against ``contour_plain``: rows, flags, steps and masks."""
    img = _contour_frames()[name]
    g = torch.from_numpy(img).to(cuda_device)
    table, lm, _ = gt.blobs(g, 200)
    fy, fx = np.argwhere(img > 128)[0]
    carried = torch.zeros_like(g)
    carried[::7, ::5] = 8
    carried[3::7, 2::5] = 9
    for kw in ({"start": (int(fx), int(fy))}, {"start": (-1, 0)}, {"start": (int(fx), int(fy))},
               {"table": table, "label_map": lm, "max_contours": 64},
               {"table": table, "label_map": lm, "largest": True}):
        for mask in (torch.zeros_like(g), carried):
            v1, v2 = mask.clone(), mask.clone()
            got = K.contour(g, v1, **kw)
            want = K.contour_plain(g, v2, **kw)
            for a, b in zip(got, want):
                assert (a is None and b is None) or torch.equal(a, b), (name, kw.keys())
            assert torch.equal(v1, v2)
    if name == "noise_step_bound":
        rows, _, steps = K.contour(g, torch.zeros_like(g), start=(int(fx), int(fy)))
        assert steps.tolist() == [4 * 12 * 12 + 8]


@pytest.mark.cuda
def test_contour_entry_points_launch_once_on_card(cuda_device):
    img = _twelve_blobs()
    g = torch.from_numpy(img).to(cuda_device)
    found_on_card, counts = _no_sync(gt.find_contours, g, 16, 64)
    assert counts == {"ccl": 1, "blob_stats": 1, "contour": 1}
    assert int(found_on_card.n) == 12
    on_cpu = gt.find_contours(torch.from_numpy(img), 16, 64)
    for a, b in zip([found_on_card.n, *found_on_card.box, *found_on_card.start,
                     found_on_card.length, found_on_card.visited],
                    [on_cpu.n, *on_cpu.box, *on_cpu.start, on_cpu.length, on_cpu.visited]):
        assert torch.equal(a.cpu(), b)
    (largest, found), counts = _no_sync(gt.largest_blob_contour, g)
    assert counts == {"ccl": 1, "blob_stats": 1, "contour": 1} and bool(found)
    c, counts = _no_sync(gt.trace_contour, g, (30, 20), largest.visited)
    assert counts == {"contour": 1}
    ref = gt.trace_contour(torch.from_numpy(img), (30, 20), largest.visited.cpu())
    for a, b in zip([*c.box, *c.start, c.length, c.visited],
                    [*ref.box, *ref.start, ref.length, ref.visited]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_match_template_sharded_on_card(cuda_device):
    frames = _frames((4, 64, 96), 81, cuda_device)
    for shape in ((1, 4), (2, 4)):
        mesh = gt.parallel.make_mesh(shape, devices=[cuda_device] * 8)
        for th, tw in ((5, 7), (16, 16), (40, 24)):
            tmpl = _frames((th, tw), th, cuda_device)
            got, counts = _no_sync(gt.parallel.match_template_sharded, frames, tmpl, mesh)
            assert counts == {"match_template": shape[0] * shape[1]}  # a shard each
            assert torch.equal(got, gt.match_template(frames, tmpl))


@pytest.mark.cuda
def test_sparse_sharded_on_card(cuda_device):
    """The sparse sharded entry points on a (1, 4) mesh of one card, each equal
    to its single-device entry point and launching its kernels a shard."""
    par = gt.parallel
    mesh = par.make_mesh((1, 4), devices=[cuda_device] * 4)
    doc = gt.io.read_pgm(__file__.rsplit("/", 1)[0] + "/golden/testdata/document.pgm").copy()
    frame = torch.from_numpy(doc).to(cuda_device)
    binary = gt.preprocess_binarize(frame)
    K.reset_launch_counts()
    labels = par.label_components_sharded(binary, mesh)
    assert K.launch_counts()["ccl"] == 4
    assert torch.equal(labels, gt.label_components(binary))
    got = par.blobs_sharded(binary, mesh, 1000)
    for a, b in zip(_blob_leaves(got), _blob_leaves(gt.blobs(binary, 1000)[0])):
        assert torch.equal(a, b)
    (page, corners), counts = _no_sync_but_one(par.scan_spatial_shardmap, frame, mesh)
    assert counts == {"blur_hist_window": 4, "otsu": 1, "ccl": 4, "blob_stats": 4,
                      "quad_warp_rows": 4}
    ref_page, ref_corners = gt.scan(frame)
    assert torch.equal(page, ref_page) and torch.equal(corners, ref_corners)
    aruco = torch.from_numpy(gt.io.read_pgm(__file__.rsplit("/", 1)[0]
                                            + "/golden/testdata/aruco.pgm").copy()).to(cuda_device)
    ref = gt.orb_extract(aruco, 500, 20)  # first: it uploads the BRIEF pattern (a wait)
    kps, counts = _no_sync(par.orb_extract_spatial, aruco, mesh, 500, 20)
    assert counts == {"fast": 4, "orb_moments": 4, "orb_brief": 4}
    for a, b in zip(kps, ref):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)
    ref = gt.match_orb(kps, kps, 300, 60)
    matches, _ = _no_sync(par.match_orb_sharded, kps, kps, mesh, 300, 60)
    for a, b in zip(matches, ref):
        assert torch.equal(a, b)
    faces = torch.from_numpy(np.stack([doc[:480, :640]] * 2)).to(cuda_device)
    ref = gt.detect_faces(faces)  # first: it uploads the cascade tables
    rects, counts = _no_sync(par.detect_faces_sharded, faces, par.make_mesh(
        (2, 4), devices=[cuda_device] * 8))
    assert counts["integral"] == 8
    for a, b in zip(rects, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_sparse_sharded_across_cards(cuda_device):
    """With two cards or more: each sparse sharded call on a mesh of distinct
    cards equals the same call on a mesh that names the first card as often
    (the halo rows, tables and hit masks then move between cards), with its
    outputs on the mesh's first card."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    k = 4 if n >= 4 else 2
    par = gt.parallel
    cards = [torch.device("cuda", i) for i in range(k)]
    across, one = (par.make_mesh((1, k), devices=d) for d in (cards, [cards[0]] * k))
    across2, one2 = (par.make_mesh((2, k // 2), devices=d) for d in (cards, [cards[0]] * k))
    here = __file__.rsplit("/", 1)[0] + "/golden/testdata/"
    doc = torch.from_numpy(gt.io.read_pgm(here + "document.pgm").copy()).to(cards[0])
    aruco = torch.from_numpy(gt.io.read_pgm(here + "aruco.pgm").copy()).to(cards[0])
    binary = gt.preprocess_binarize(doc)
    kps = gt.orb_extract(aruco, 500, 20)
    faces = torch.stack([aruco, aruco.roll(9, 1)])
    calls = [(par.label_components_sharded, (binary,), across, one),
             (par.blobs_sharded, (binary, across, 1000), None, one),
             (par.scan_spatial_shardmap, (doc,), across, one),
             (par.orb_extract_spatial, (aruco, across, 500, 20), None, one),
             (par.match_orb_sharded, (kps, kps, across, 300, 60), None, one),
             (par.detect_faces_sharded, (faces,), across2, one2)]
    for fn, args, mesh_a, mesh_b in calls:
        if mesh_a is not None:
            got, want = fn(args[0], mesh_a, *args[1:]), fn(args[0], mesh_b, *args[1:])
        else:
            i = next(j for j, v in enumerate(args) if v is across)
            got = fn(*args)
            want = fn(*args[:i], mesh_b, *args[i + 1:])
        for a, b in zip(_blob_leaves(got), _blob_leaves(want)):
            assert a.device == cards[0] and torch.equal(a, b), fn.__name__


def _blob_leaves(table):
    """A table's tensors (a Blobs' box and centroid fields flattened; a
    tensor is its own one leaf)."""
    if isinstance(table, torch.Tensor):
        return [table]
    out = []
    for v in table:
        out.extend(v if isinstance(v, tuple) else [v])
    return out


def _no_sync_but_one(fn, *args):
    """``fn(*args)`` with the counts at 0; fails unless the host waited exactly
    once (sync debug mode "warn", each wait one warning)."""
    import warnings

    torch.cuda.synchronize()
    K.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    waits = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(waits) == 1, [str(w.message) for w in caught]
    return out, {k: v for k, v in K.launch_counts().items() if v}


def _k19_widths():
    """csrc/template.cu's crossover: the narrowest and widest templates on the tensor cores."""
    import re

    with open(__file__.rsplit("/", 2)[0] + "/grayskull_tpu_torch/csrc/template.cu") as f:
        src = f.read()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                 for name in ("kMmaMinWidth", "kMmaMaxWidth"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tshape", [((1, 260, 300), (257, 257)), ((1, 12, 7400), (9, 7339))])
@pytest.mark.parametrize("fill", [(255, 255), (255, 0)])
def test_match_template_at_the_limit_on_card(cuda_device, shape, tshape, fill):
    """All-255 frames and template (the correlation passes 2^31 and wraps in
    s32) and a 255 frame with a 0 template (the SSD at its largest), on the
    tensor cores (257 x 257) and on the INT32 design (9 x 7339)."""
    frames = torch.full(shape, fill[0], dtype=torch.uint8, device=cuda_device)
    tmpl = torch.full(tshape, fill[1], dtype=torch.uint8, device=cuda_device)
    got = K.match_template(frames, tmpl)
    assert torch.equal(got, torch.full_like(got, 255 if fill[1] == 255 else 0))
    assert torch.equal(got, K.match_template_plain(frames, tmpl))


@pytest.mark.cuda
def test_match_template_both_sides_of_the_crossover_on_card(cuda_device):
    """K19 at the widths on either side of each end of its tensor-core range,
    at byte offsets 0, 1 and 3."""
    lo, hi = _k19_widths()
    for tw in (lo - 1, lo, hi, hi + 1):
        for offset in (0, 1, 3):
            frames = _offset_frames((2, 40, hi + 80), offset, tw + offset, cuda_device)
            tmpl = _offset_frames((5, tw), 0, tw, cuda_device)
            got = K.match_template(frames, tmpl)
            assert torch.equal(got, K.match_template_plain(frames, tmpl)), (tw, offset)


def _overlap_frames():
    """(name, frame, max_contours, max_blobs): K20's side-by-side walks where
    their paths meet, and more rows than one block's warps (on the shared-memory
    bitmaps and on the bytes)."""
    diagonal = np.zeros((20, 30), np.uint8)
    for y0, x0, y1, x1 in ((2, 2, 12, 12), (12, 12, 18, 25), (2, 14, 8, 20)):
        diagonal[y0:y1, x0:x1] = 255
    dots = np.zeros((40, 48), np.uint8)
    dots[1::3, 1::3] = 255
    big_dots = np.zeros((965, 965), np.uint8)  # past the bitmaps: the byte path
    big_dots[5:300:3, 7:40:3] = 255
    big_dots[600:900, 100:960] = 255
    return [("diagonal", diagonal, 4, 4), ("diagonal_cap_1", diagonal, 1, 4),
            ("dots_cap_80", dots, 80, 100), ("dots_965x965_cap_80", big_dots, 80, 120)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _overlap_frames(), ids=lambda c: c[0])
def test_contour_find_where_walks_meet_on_card(cuda_device, case):
    """K20's find mode against ``contour_plain`` on zero and carried masks,
    one carried mask marking the first blob's start (its walk skipped, its
    pixels fresh for the walk that crosses them)."""
    name, img, max_contours, max_blobs = case
    g = torch.from_numpy(img).to(cuda_device)
    table, lm, _ = gt.blobs(g, max_blobs)
    carried = torch.zeros_like(g)
    carried[::7, ::5] = 8
    carried[3::7, 2::5] = 9
    skip_first = torch.zeros_like(g)
    skip_first[int(table.box.y[0]), int(table.box.x[0])] = 9
    for mask in (torch.zeros_like(g), carried, skip_first):
        v1, v2 = mask.clone(), mask.clone()
        got = K.contour(g, v1, table=table, label_map=lm, max_contours=max_contours)
        want = K.contour_plain(g, v2, table=table, label_map=lm, max_contours=max_contours)
        for a, b in zip(got, want):
            assert torch.equal(a, b), name
        assert torch.equal(v1, v2), name
    if name.startswith("dots"):
        assert int(K.contour(g, torch.zeros_like(g), table=table, label_map=lm,
                             max_contours=max_contours)[1]) == 80  # three windows of walks


def _fs_sin_cases(rng):
    """float32 sine inputs: both reduction loops, ORB's range, the octant's
    edges, the loop-end cases (NaN past 2^20) and the largest input below it."""
    below = np.nextafter(np.float32(2.0**20), np.float32(0))
    return np.concatenate([
        rng.uniform(-30.0, 30.0, 200_000), rng.uniform(-np.pi, np.pi + 1.58, 50_000),
        [0.0, -0.0, 3.141592, -3.141592, 1.570796, 6.283185, -6.283185, np.inf, -np.inf,
         np.nan, 2.0**27, -(2.0**27), 2.0**20, -(2.0**20), 3.4e38, below, -below]],
    ).astype(np.float32)


def _fs_atan2_cases(rng):
    m = 255 * 709 * 15
    ys = np.concatenate([rng.integers(-m, m, 100_000), rng.uniform(-1e6, 1e6, 100_000),
                         [0.0, -0.0, 0.0, -0.0, 1.0, -1.0, np.nan, np.inf, 1.0, 0.0]])
    xs = np.concatenate([rng.integers(-m, m, 100_000), rng.uniform(-1e6, 1e6, 100_000),
                         [0.0, 0.0, -0.0, -0.0, 0.0, 0.0, 1.0, 1.0, np.nan, np.inf]])
    return ys.astype(np.float32), xs.astype(np.float32)


@pytest.mark.cuda
def test_freestanding_k21_matches_plain_on_card(cuda_device):
    """K21 against its plain versions (on the CPU, where the loops test on the
    host), bit for bit, NaNs included: every NaN is 0x7fc00000 on both."""
    from grayskull_tpu_torch.kernels import freestanding as F

    rng = np.random.default_rng(81)
    ys, xs = _fs_atan2_cases(rng)
    y, x = torch.from_numpy(ys), torch.from_numpy(xs)
    K.reset_launch_counts()
    got = F.fs_atan2(y.to(cuda_device), x.to(cuda_device))
    assert K.launch_counts()["freestanding"] == 1
    assert torch.equal(got.cpu().view(torch.int32), F.fs_atan2_plain(y, x).view(torch.int32))
    a = torch.from_numpy(_fs_sin_cases(rng))
    for offset in (None, 1.57079):
        got = F.fs_sin(a.to(cuda_device), offset).cpu()
        assert torch.equal(got.view(torch.int32), F.fs_sin_plain(a, offset).view(torch.int32))
    assert K.launch_counts()["freestanding"] == 3
    assert np.isnan(F.fs_sin(torch.tensor([np.inf], device=cuda_device)).item())


def _fs_moment_cases(rng):
    """int32 (m01, m10): every pair of int32's ends, 0, +-1 and odd values past
    2^24, small m01 against large negative m10 (angles near +-pi) and uniform
    int32s; 200,011 pairs, so the last thread's elements are a tail."""
    edge = np.array([0, 1, -1, -2**31, 2**31 - 1, -2**31 + 1, 2**24 + 1, -(2**24 + 1),
                     2**25 + 3], np.int64)
    ey, ex = (v.ravel() for v in np.meshgrid(edge, edge))
    near_pi = (rng.integers(-3, 4, 50_000), -rng.integers(1, 2**31, 50_000))
    uniform = rng.integers(-2**31, 2**31, (2, 200_011 - ey.size - 50_000))
    return (np.concatenate([ey, near_pi[0], uniform[0]]).astype(np.int32),
            np.concatenate([ex, near_pi[1], uniform[1]]).astype(np.int32))


@pytest.mark.cuda
def test_freestanding_fs_orient_matches_plain_on_card(cuda_device):
    """K21's fused orientation entry against its plain version (on the CPU),
    bit for bit: one launch a call, whatever the alignment of the operands."""
    from grayskull_tpu_torch.kernels import freestanding as F

    ys, xs = _fs_moment_cases(np.random.default_rng(82))
    y, x = torch.from_numpy(ys), torch.from_numpy(xs)
    want = [t.view(torch.int32) for t in F.fs_orient_plain(y, x)]
    yd, xd = y.to(cuda_device), x.to(cuda_device)
    for lo in (0, 1, 2, 3):  # operands 0, 4, 8 and 12 bytes past a 16-byte boundary
        K.reset_launch_counts()
        got = F.fs_orient(yd[lo:], xd[lo:])
        assert K.launch_counts()["freestanding"] == 1
        for a, b in zip(got, want):
            assert torch.equal(a.cpu().view(torch.int32), b[lo:])
    got = F.fs_orient(yd[:199_997].view(-1, 7), xd[:199_997].view(-1, 7))  # 2-D, 7 x 28,571
    for a, b in zip(got, want):
        assert a.shape == (28_571, 7)
        assert torch.equal(a.cpu().view(torch.int32), b[:199_997].view(-1, 7))


def _host_waits(fn, *args):
    torch.cuda.synchronize()
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.cuda
def test_freestanding_orb_on_card_matches_cpu(cuda_device):
    """The ORB path in the freestanding mode: K21 once, for the angle, the sine
    and the reference's cosine together (``fs_orient``), no host wait, and
    tables equal to the CPU's bit for bit (and to the plain path on the card)."""
    lena = gt.io.read_pgm(__file__.rsplit("/", 1)[0] + "/golden/testdata/lena.pgm")
    frames = torch.from_numpy(np.stack([lena, np.roll(lena, 9, axis=1)])).to(cuda_device)
    gt.orb_extract(frames, 300, 20)  # K8's tables reach the card: a wait, once
    libm32.use_freestanding(True)
    try:
        K.reset_launch_counts()
        on_card, waits = _host_waits(gt.orb_extract, frames, 300, 20)
        assert waits == 0 and K.launch_counts()["freestanding"] == 1
        on_cpu = gt.orb_extract(frames.cpu(), 300, 20)
        plain = gt.orb_extract(frames, 300, 20, force_reference=True)
        tk, sk, m = gt.track(frames[0, :100, :120], frames[1], max_kps=400)
        ck = gt.track(frames[0, :100, :120].cpu(), frames[1].cpu(), max_kps=400)
    finally:
        libm32.use_freestanding(False)
    for a, b, c in zip(_bits_of(on_card), _bits_of(on_cpu), _bits_of(plain)):
        assert torch.equal(a.cpu(), b) and torch.equal(a, c)
    for got, want in zip((tk, sk, m), ck):
        for a, b in zip(_bits_of(got), _bits_of(want)):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_live_demo_on_card_matches_cpu(cuda_device):
    import os
    import sys

    examples = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "examples")
    if examples not in sys.path:
        sys.path.insert(0, examples)
    import live_demo_torch
    import stream_demo_torch

    frames = stream_demo_torch.synth_frames(4, 120, 160)
    card = live_demo_torch.Demo(frames, device="cuda")
    cpu = live_demo_torch.Demo(frames, device="cpu")
    analyzers = ["blobs", "keypoints", "faces", "contours", "orb"]
    for i, spec in ((1, "blur:1,threshold:otsu"), (2, "sobel"), (3, "adaptive:5:5,erode")):
        assert card.frame(i, spec, analyzers) == cpu.frame(i, spec, analyzers)
    assert card.capture_template(frames[2]) == cpu.capture_template(frames[2])
    assert card.process(frames[1], "blur:1", ["orb"]) == cpu.process(frames[1], "blur:1", ["orb"])
