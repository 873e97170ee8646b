"""The port's kernel modules against the Pallas kernels they replace.

On the CPU a kernel wrapper runs its plain version; here those plain versions
are held, with tolerance 0, to the Pallas kernels run in interpret mode the way
``tests/test_preproc.py`` runs them, and to the XLA Otsu sweep.  The CUDA kernels
themselves are held to the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  The LBP cascade's plain
version is also held to the XLA window evaluation ``_eval_windows_jit``.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import grayskull_tpu as gs
import grayskull_tpu_torch as gt
from grayskull_tpu.core import LbpCascade as JaxLbpCascade
from grayskull_tpu.kernels.integral import integral_pallas
from grayskull_tpu.kernels.lbp import lbp_eval_scale as jax_lbp_eval_scale
from grayskull_tpu.kernels.lbp import lbp_pad_for
from grayskull_tpu.kernels.preproc import (blur_pallas, filter3_pallas, fused_blur_hist,
                                           fused_threshold_sobel, morph_pallas,
                                           preproc_available, sobel_pallas)
from grayskull_tpu.ops.histogram import otsu_from_histogram as jax_otsu_from_histogram
from grayskull_tpu.ops.lbp import _eval_windows_jit
from grayskull_tpu_torch import kernels as K
from grayskull_tpu_torch.kernels import _build
from grayskull_tpu_torch.kernels.lbp import scale_tables
from tests.test_torch_cuda import (COPY_OFFSETS, COPY_SIZES, host_arrays_on_cpu,  # noqa: F401
                                   otsu_batch_histograms, otsu_edge_histograms, synthetic_cascade)

STENCIL_SHAPES = [(1, 13, 136), (1, 97, 200), (1, 7, 8), (1, 17, 129)]


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _eq(port, ref, msg=""):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref), err_msg=msg)


@pytest.mark.parametrize("shape,radius", [((2, 24, 128), 2), ((2, 24, 128), 6),
                                          ((2, 128, 128), 2)])
def test_blur_hist_vs_fused_blur_hist(shape, radius):
    imgs = _frames(shape, 10)
    blurred, hist = K.blur_hist(torch.from_numpy(imgs), radius)
    ref_blurred, ref_hist = fused_blur_hist(imgs, radius, interpret=True)
    assert hist.dtype == torch.int32 and tuple(hist.shape) == (shape[0], 256)
    _eq(blurred, ref_blurred, "blurred")
    _eq(hist, ref_hist, "hist")
    none_blurred, none_hist = K.blur_hist(torch.from_numpy(imgs), radius, with_hist=False)
    assert none_hist is None and torch.equal(none_blurred, blurred)


@pytest.mark.parametrize("radius", [2, 9])
@pytest.mark.parametrize("shape", STENCIL_SHAPES)
def test_blur_vs_blur_pallas(shape, radius):
    imgs = _frames(shape, 11)
    blurred, _ = K.blur_hist(torch.from_numpy(imgs), radius, with_hist=False)
    _eq(blurred, blur_pallas(imgs, radius, interpret=True), f"{shape} r={radius}")


@pytest.mark.parametrize("shape", STENCIL_SHAPES)
def test_sobel_vs_sobel_pallas(shape):
    imgs = _frames(shape, 12)
    binary, edges = K.threshold_sobel(torch.from_numpy(imgs))
    assert binary is None
    _eq(edges, sobel_pallas(imgs, interpret=True), str(shape))


@pytest.mark.parametrize("want_binary", [True, False])
def test_threshold_sobel_vs_fused_threshold_sobel(want_binary):
    imgs = _frames((2, 24, 128), 13)
    t = np.array([90, 170], np.uint8)
    binary, edges = K.threshold_sobel(torch.from_numpy(imgs), torch.from_numpy(t), want_binary)
    ref_binary, ref_edges = fused_threshold_sobel(imgs, t, want_binary, interpret=True)
    _eq(edges, ref_edges, "edges")
    if want_binary:
        _eq(binary, ref_binary, "binary")
    else:
        assert binary is None and ref_binary is None


def test_otsu_vs_xla_sweep():
    rng = np.random.default_rng(14)
    hists = rng.integers(0, 300, (16, 256)).astype(np.int32)
    hists[3, :200] = 0
    hists[5, 17:] = 0
    total = 256 * 150
    _eq(K.otsu(torch.from_numpy(hists), total),
        jax_otsu_from_histogram(hists.astype(np.uint32), total))
    for name, hist, tot in otsu_edge_histograms():
        got = K.otsu(torch.from_numpy(hist.astype(np.int32)[None]), tot)
        assert int(got[0]) == int(jax_otsu_from_histogram(hist.astype(np.uint32), tot)), name


def otsu_lane_replay(hist, total, lanes):
    """K3's decomposition in numpy (``csrc/otsu.cu``): ``lanes`` lanes a frame,
    each on 256 / lanes consecutive bins.  The uint32 weight prefix is each
    lane's own prefix plus a scan across the lanes; the skipped bins (wb == 0)
    and the first break (a bin not skipped with total - wb == 0) come from it;
    the two float32 chains run bin by bin, sumB over the products with 0 in
    place of the bins the sweep does not take; each taken bin's variance is
    ((wb*wf)*d)*d; the threshold is the largest variance, ties to the lowest
    bin, or 0 with no taken bin."""
    counts = np.asarray(hist, np.int64).astype(np.uint32)
    n, per = counts.shape[0], 256 // lanes
    own = np.cumsum(counts.reshape(n, lanes, per), axis=2, dtype=np.uint32)
    lane_sums = own[:, :, -1]
    before = np.cumsum(lane_sums, axis=1, dtype=np.uint32) - lane_sums
    wb = (before[:, :, None] + own).reshape(n, 256)
    wf = np.uint32(total) - wb
    live = wb != 0
    breaks = live & (wf == 0)
    brk = np.where(breaks.any(axis=1), breaks.argmax(axis=1), 256)
    taken = live & (np.arange(256)[None] < brk[:, None])
    terms = np.arange(256, dtype=np.float32)[None] * counts.astype(np.float32)
    taken_terms = np.where(taken, terms, np.float32(0))
    total_sum = np.zeros(n, np.float32)
    sum_b = np.zeros(n, np.float32)
    prefix = np.zeros((n, 256), np.float32)
    for t in range(256):
        total_sum = total_sum + terms[:, t]
        sum_b = sum_b + taken_terms[:, t]
        prefix[:, t] = sum_b
    fb = np.where(taken, wb.astype(np.float32), np.float32(1))
    ff = np.where(taken, wf.astype(np.float32), np.float32(1))
    d = prefix / fb - (total_sum[:, None] - prefix) / ff
    var = ((fb * ff) * d) * d
    assert np.isfinite(var[taken]).all() and (var[taken] >= 0).all()
    var = np.where(taken, var, np.float32(-1))
    best = var.max(axis=1)
    return np.where(best >= 0, (var == best[:, None]).argmax(axis=1), 0).astype(np.uint8)


OTSU_REPLAY_CASES = otsu_batch_histograms() + [
    (name, hist.astype(np.int32)[None], total) for name, hist, total in otsu_edge_histograms()]


@pytest.mark.parametrize("case", OTSU_REPLAY_CASES, ids=[c[0] for c in OTSU_REPLAY_CASES])
def test_otsu_lane_decomposition_replayed(case):
    """The replay at 8, 16 and 32 lanes a frame (the committed kLanes among
    them) equals ``otsu_plain`` and the XLA sweep, wrapped weights and totals
    the counts do not sum to included."""
    name, hists, total = case
    text = (_build.CSRC_DIR / "otsu.cu").read_text()
    assert int(re.search(r"constexpr int kLanes = (\d+);", text).group(1)) in (8, 16, 32)
    plain = K.otsu(torch.from_numpy(hists), total)
    _eq(plain, jax_otsu_from_histogram(hists.astype(np.uint32), total), name)
    for lanes in (8, 16, 32):
        np.testing.assert_array_equal(otsu_lane_replay(hists, total, lanes), plain.numpy(),
                                      err_msg=f"{name} {lanes} lanes")


def copy_writes(n, aligned, threads):
    """How many times K17's launch (``csrc/bandwidth.cu:gs_copy``) writes each of
    ``n`` bytes.  Both pointers 16-byte aligned: blocks of ``threads`` threads,
    at least one, thread i of the grid moving 16-byte vector i below n / 16, and
    the last block's thread j byte n / 16 * 16 + j below n.  Otherwise a thread
    a byte over blockDim 256.  Returns the counts and the grid size."""
    writes = np.zeros(n, np.int8)
    if aligned:
        n_vec = n // 16
        blocks = max(-(-n_vec // threads), 1)
        vectors = min(blocks * threads, n_vec)  # the grid's threads below n_vec
        writes[:16 * vectors] += 1
        tail = n_vec * 16 + np.arange(threads)
        writes[tail[tail < n]] += 1
    else:
        blocks = -(-n // 256)
        writes[:min(blocks * 256, n)] += 1
    return writes, blocks


@pytest.mark.parametrize("size", COPY_SIZES)
def test_copy_tail_and_alignment_replayed(size):
    """At the card test's sizes and offsets, K17's vectors, its last block's
    tail and its byte path write every byte once, in a grid below 2^31 blocks;
    ``copy`` on the CPU returns the same bytes."""
    text = (_build.CSRC_DIR / "bandwidth.cu").read_text()
    threads = int(re.search(r"constexpr int kCopyThreads = (\d+);", text).group(1))
    assert threads >= 16  # the last block covers a tail of up to 15 bytes
    x = np.random.default_rng(size).integers(0, 256, size + 8, dtype=np.uint8)
    for off in COPY_OFFSETS:
        writes, blocks = copy_writes(size, off % 16 == 0, threads)
        assert (writes == 1).all() and blocks <= 2**31 - 1, off
        a = torch.from_numpy(x[off:off + size])
        assert torch.equal(K.copy(a), a), off


def test_plain_runs_on_cpu_without_counting():
    before = K.launch_counts()
    imgs = torch.from_numpy(_frames((1, 9, 10), 15))
    _, hist = K.blur_hist(imgs, 1)
    K.threshold_sobel(imgs, K.otsu(hist, 90))
    ii = K.integral(imgs)
    K.lbp_eval_scale(synthetic_cascade(), ii, 1.0, 1, 2, 1)
    xy = torch.full((1, 3), 4, dtype=torch.int32)
    K.fast(imgs, 20)
    K.orb_moments(imgs, xy, xy)
    K.orb_brief(imgs, xy, xy, torch.zeros((1, 3)), torch.ones((1, 3)))
    K.ccl(imgs)
    K.quad_warp(imgs, torch.zeros((1, 4, 2), dtype=torch.int32), (3, 4))
    K.quad_warp_rows(imgs, torch.zeros((1, 4, 2), dtype=torch.int32), (3, 4), 1, 2)
    K.adaptive(imgs, 2, 5)
    K.morph(imgs, "erode")
    K.filter3(imgs, ((0, -1, 0), (-1, 5, -1), (0, -1, 0)), 1)
    K.resize(imgs, (5, 6))
    K.blur_hist_window(imgs, -1, 1, h_total=10, row_lo=1, row_hi=9)
    K.threshold_sobel_window(imgs, torch.zeros(1, dtype=torch.uint8), 3, h_total=20)
    K.copy(imgs)
    K.triad(imgs, imgs)
    K.match_template(imgs, imgs[0, :2, :3].contiguous())
    K.contour(imgs[0], torch.zeros_like(imgs[0]), start=(1, 1))
    K.fs_sin(K.fs_atan2(torch.ones(3), torch.ones(3)), 1.57079)
    K.blob_stats(torch.ones((2, 12), dtype=torch.int32), 3, 4)
    K.blob_stats(torch.ones((2, 12), dtype=torch.int32), 7000, 4)
    assert K.launch_counts() == before
    assert set(before) == {"blur_hist", "threshold_sobel", "otsu", "integral", "lbp_eval_scale",
                           "fast", "orb_moments", "orb_brief", "ccl", "quad_warp", "adaptive",
                           "morph", "filter3", "resize", "blur_hist_window",
                           "threshold_sobel_window", "copy", "triad", "match_template", "contour",
                           "quad_warp_rows", "freestanding", "blob_stats", "blob_stats_global"}


@pytest.mark.parametrize("shape", [(1, 7, 8), (2, 97, 200), (3, 1, 40), (1, 130, 257)])
def test_integral_vs_integral_pallas(shape):
    imgs = _frames(shape, 40)
    got = K.integral(torch.from_numpy(imgs))
    assert got.dtype == torch.uint32
    _eq(got, integral_pallas(imgs, interpret=True), str(shape))


def _jax_cascade(cascade):
    return JaxLbpCascade(**{f.name: getattr(cascade, f.name)
                            for f in dataclasses.fields(cascade)})


@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("scale", [1.0, 1.5])
def test_lbp_eval_scale_plain_vs_jax_synthetic(scale, step):
    """``tests/test_lbp.py``'s synthetic cascade, which has a back-loaded stage split."""
    cas = synthetic_cascade()
    jcas = _jax_cascade(cas)
    ih, iw = 40, 256
    frames = _frames((2, ih, iw), 41)
    iib = gs.integral(frames)
    win = int(np.float32(8) * np.float32(scale))
    ny, nx = (ih - win) // step + 1, (iw - win) // step + 1
    got = K.lbp_eval_scale(cas, gt.integral(frames), scale, ny, nx, step)
    assert got.dtype == torch.bool and tuple(got.shape) == (2, ny, nx)
    _eq(got, _eval_windows_jit(jcas, iib, scale, ny, nx, step), "vs _eval_windows")
    iip = lbp_pad_for(jcas, iib, [(scale, win, win)], ih, iw, step)
    _eq(got, jax_lbp_eval_scale(jcas, iip, scale, ny, nx, step, interpret=True), "vs pallas")


@pytest.mark.parametrize("step", [1, 2, 3])
def test_lbp_eval_scale_plain_vs_jax_frontalface(step):
    lena = gt.io.read_pgm(os.path.join(os.path.dirname(__file__), "golden", "testdata",
                                       "lena.pgm"))
    cas = gt.load_frontalface()
    jcas = _jax_cascade(cas)
    ii = gt.integral(lena[None])
    iib = gs.integral(lena[None])
    for scale, win_w, win_h in gt.scale_ladder(cas, 128, 128, 1.2, 1.0, 4.0)[::4]:
        ny, nx = (128 - win_h) // step + 1, (128 - win_w) // step + 1
        _eq(K.lbp_eval_scale(cas, ii, scale, ny, nx, step),
            _eval_windows_jit(jcas, iib, scale, ny, nx, step), f"scale {scale}")
    for y, x in ((57, 65), (104, 104)):  # one window from an origin
        _eq(K.lbp_eval_scale(cas, ii, 1.0, 1, 1, 1, (y, x)),
            _eval_windows_jit(jcas, iib, 1.0, 1, 1, 1, origin=(y, x)), f"window {(y, x)}")


def test_faces_wrappers_reject_bad_input():
    good = torch.zeros((2, 8, 8), dtype=torch.uint8)
    for bad, err in ((good.to(torch.int32), TypeError), (good[0], ValueError),
                     (good[:, :, ::2], ValueError), (good[:, :0], ValueError)):
        with pytest.raises(err):
            K.integral(bad)
    ii = K.integral(good)
    cas = synthetic_cascade()
    for bad, err in ((ii.view(torch.int32), TypeError), (ii[0], ValueError),
                     (ii[:, :, ::2], ValueError)):
        with pytest.raises(err):
            K.lbp_eval_scale(cas, bad, 1.0, 1, 1)
    for ny, nx, step, origin in ((0, 1, 1, (0, 0)), (1, 1, 0, (0, 0)), (1, 1, 1, (-1, 0))):
        with pytest.raises(ValueError):
            K.lbp_eval_scale(cas, ii, 1.0, ny, nx, step, origin)
    empty_stage = dataclasses.replace(cas, stage_nweaks=np.array([0, 4], np.uint16))
    with pytest.raises(ValueError):
        K.lbp_eval_scale(empty_stage, ii, 1.0, 1, 1)
    nweaks = 3800  # past the 227 KB of shared memory that holds the tables and a tile
    huge = dataclasses.replace(
        cas, weak_feature_idx=np.zeros(nweaks, np.uint16),
        weak_left_val=np.zeros(nweaks, np.float32), weak_right_val=np.zeros(nweaks, np.float32),
        weak_subset_offset=np.zeros(nweaks, np.uint16), weak_num_subsets=np.ones(nweaks, np.uint16),
        stage_weak_start=np.array([0], np.uint16), stage_nweaks=np.array([nweaks], np.uint16),
        stage_threshold=np.zeros(1, np.float32))
    with pytest.raises(ValueError):
        scale_tables(huge, 1.0)


def test_wrappers_reject_bad_input():
    good = torch.zeros((2, 8, 8), dtype=torch.uint8)
    for bad, err in ((good.to(torch.int32), TypeError), (good[0], ValueError),
                     (good[:, :, ::2], ValueError), (good[:, :0], ValueError)):
        with pytest.raises(err):
            K.blur_hist(bad, 2)
        with pytest.raises(err):
            K.threshold_sobel(bad)
    with pytest.raises(TypeError):
        K.blur_hist(good.numpy(), 2)
    with pytest.raises(ValueError):
        K.blur_hist(good, -1)
    with pytest.raises(ValueError):  # window sum past int32
        K.blur_hist(torch.zeros((1, 3000, 3000), dtype=torch.uint8), 1500)
    for t in (torch.zeros(3, dtype=torch.uint8), torch.zeros(2, dtype=torch.int32),
              torch.zeros((2, 1), dtype=torch.uint8)):
        with pytest.raises(ValueError):
            K.threshold_sobel(good, t)
    hist = torch.zeros((2, 256), dtype=torch.int32)
    for bad, err in ((hist.to(torch.int64), TypeError), (hist[:, :255], ValueError),
                     (hist[0], ValueError), (hist.t().contiguous().t(), ValueError)):
        with pytest.raises(err):
            K.otsu(bad, 64)
    with pytest.raises(ValueError):
        K.otsu(hist, 2**31)


def test_blur_magic_division_is_exact():
    """K1/K15's division (``csrc/preproc.cu:div_magic``, ``div_exact``) replayed
    in numpy: a multiply-high by ``floor((2^32 - 1) / d) + 1`` (``2^32 - 1`` for
    d = 1), corrected once each way, is ``s // d`` for every uint32 ``s`` and
    ``d >= 1``; on the interior path (d >= 2, ``s + d < 2^32``) one correction
    down in 32-bit products is enough."""
    rng = np.random.default_rng(7)
    n = 1 << 18
    d = np.concatenate([rng.integers(1, 70_000, n), 2 ** rng.integers(0, 32, n),
                        rng.integers(1, 2**32, n), np.arange(1, 9).repeat(n // 8)]).astype(np.uint64)
    k = rng.integers(0, 4, d.size).astype(np.uint64)
    s = np.where(k == 0, rng.integers(0, 2**32, d.size).astype(np.uint64),  # any sum
                 np.where(k == 1, np.minimum(d * rng.integers(0, 300, d.size).astype(np.uint64),
                                             2**32 - 1),  # exact multiples, as in flat regions
                          np.where(k == 2, np.minimum(256 * d, 2**32) - 1,  # the largest mean
                                   2**32 - 1))).astype(np.uint64)
    m = np.where(d == 1, 2**32 - 1, (2**32 - 1) // d + 1).astype(np.uint64)
    est = (s * m) >> np.uint64(32)
    qd = est * d
    q = est - (qd > s).astype(np.uint64) + (qd + d <= s).astype(np.uint64)
    np.testing.assert_array_equal(q, s // d)
    inner = (d >= 2) & (s + d < 2**32)
    assert inner.sum() > n
    est, di, si = est[inner], d[inner], s[inner]
    down = est - (((est * di) & np.uint64(0xFFFFFFFF)) > si).astype(np.uint64)
    np.testing.assert_array_equal(down, si // di)


def _neighbourhood_frame(t, rng):
    """A 64 x 128 frame holding all 512 3x3 patterns of above/not above ``t``:
    pattern p fills the 3x3 cell at rows 4i.., columns 4j.. (p = 32i + j,
    bit 3*dy + dx for the pixel at (dy, dx)), centred at (4i+1, 4j+1); the
    fourth row and column of each cell are random."""
    frame = rng.integers(0, 256, (64, 128), dtype=np.int64)
    bits = (np.arange(512)[:, None] >> np.arange(9)[None, :]) & 1  # (512, 9)
    above = rng.integers(t + 1, 256, (512, 9)) if t < 255 else np.zeros((512, 9), np.int64)
    below = rng.integers(0, t + 1, (512, 9))
    cells = np.where(bits == 1, above, below).reshape(512, 3, 3)
    for p in range(512):
        i, j = divmod(p, 32)
        frame[4 * i:4 * i + 3, 4 * j:4 * j + 3] = cells[p]
    return frame.astype(np.uint8), bits.reshape(512, 3, 3)


@pytest.mark.parametrize("t", [0, 90, 254])
def test_binary_sobel_is_0_127_255_on_every_neighbourhood(t):
    """K2/K16's Sobel on the 0/1 map (``csrc/preproc.cu:sobel_words``) replayed
    in numpy.  On a {0, 255} map the magnitude min(255 * (|gx|+|gy|) / 2, 255)
    of the 0/1 map's gx, gy is 0, 127 or 255 as |gx|+|gy| is 0, 1, or 2 and
    more; the port's plain version and JAX ``fused_threshold_sobel`` (interpret
    mode) give that rule on all 512 neighbourhoods.  |gx|+|gy| has the parity
    of gx+gy = 2(i-a) + 2(f+h-b-d), so it is never 1 and the rule is 0 where
    gx = gy = 0, else 255: the kernel's test.  Its column and row [1, 2, 1]
    sums are at most 4, their XORs at most 7, and ``((d + 0x7f7f7f7f) >> 7 &
    0x01010101) * 0xff`` maps four such bytes at once, with no carry between
    them, to 255 where a byte is not 0."""
    rng = np.random.default_rng(20 + t)
    frame, bits = _neighbourhood_frame(t, rng)
    assert preproc_available(*frame.shape)
    imgs = np.stack([frame, frame[::-1].copy()])
    thr = np.array([t, t], np.uint8)
    binary, edges = K.threshold_sobel(torch.from_numpy(imgs), torch.from_numpy(thr))
    ref_binary, ref_edges = fused_threshold_sobel(imgs, thr, True, interpret=True)
    _eq(binary, ref_binary, "binary")
    _eq(edges, ref_edges, "edges")
    b = bits.astype(np.int64)  # (512, 3, 3): rows dy, columns dx
    taps = np.array([1, 2, 1])
    v_left, v_right = (b[:, :, 0] * taps).sum(1), (b[:, :, 2] * taps).sum(1)
    h_top, h_bottom = (b[:, 0, :] * taps).sum(1), (b[:, 2, :] * taps).sum(1)
    gx, gy = v_right - v_left, h_bottom - h_top
    s = np.abs(gx) + np.abs(gy)
    rule = np.where(s == 0, 0, np.where(s == 1, 127, 255))
    centres = edges[0].numpy()[4 * (np.arange(512) // 32) + 1, 4 * (np.arange(512) % 32) + 1]
    np.testing.assert_array_equal(centres, rule)
    np.testing.assert_array_equal(np.minimum(255 * s // 2, 255), rule)
    assert (s % 2 == 0).all() and s.max() == 6 and set(rule.tolist()) == {0, 255}
    sums = np.stack([v_left, v_right, h_top, h_bottom])
    assert sums.min() == 0 and sums.max() == 4
    d = (v_right ^ v_left) | (h_bottom ^ h_top)
    np.testing.assert_array_equal(np.where(d != 0, 255, 0), rule)
    # the word formula on every choice of four bytes d = 0 .. 7
    quads = np.stack(np.meshgrid(*[np.arange(8)] * 4, indexing="ij"), -1).reshape(-1, 4)
    words = (quads.astype(np.uint64) << (8 * np.arange(4, dtype=np.uint64))).sum(1)
    out = ((((words + 0x7F7F7F7F) >> 7) & 0x01010101) * 0xFF) & 0xFFFFFFFF
    got = (out[:, None] >> (8 * np.arange(4, dtype=np.uint64))) & 0xFF
    np.testing.assert_array_equal(got, np.where(quads == 0, 0, 255))


def _byte_perm(x, y, s):
    """CUDA's ``__byte_perm`` on arrays of 32-bit words (uint64): byte i of the
    result is byte ``(s >> 4i) & 7`` of the 8 bytes y:x."""
    v = (y << np.uint64(32)) | x
    out = np.zeros_like(x)
    for i in range(4):
        sel = np.uint64(8 * ((s >> (4 * i)) & 7))
        out |= ((v >> sel) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out


def _row_words(frames, outside):
    """(N, H, W) uint8 -> (N, H + 2, ceil(W / 4) + 2) little-endian words (uint64)
    of the frames framed by a row, a column and a whole word of ``outside``
    bytes: the words ``csrc/stencil3.cu:load_row`` leaves, with the words
    just left and right of the frame that ``neighbours`` takes the border
    bytes from."""
    n, h, w = frames.shape
    wp = -(-w // 4) * 4
    x = np.full((n, h + 2, wp + 8), outside, np.uint64)
    x[:, 1:h + 1, 4:4 + w] = frames
    return sum(x[..., j::4] << np.uint64(8 * j) for j in range(4))


def _word_bytes(words, w):
    """(..., K) words -> (..., w) uint8: bytes 0..3 of each word, in order."""
    b = np.stack([(words >> np.uint64(8 * j)) & np.uint64(0xFF) for j in range(4)], -1)
    return b.reshape(*words.shape[:-1], -1)[..., :w].astype(np.uint8)


def _filter3_replay(frames, taps, norm, packed):
    """K13 (``csrc/stencil3.cu:filter_words``) in numpy.  The window of column
    x in a row is the word of bytes [x-1, x, x+1, x+2]: for byte j of a word
    v between its neighbour words prev and next, ``__byte_perm(prev, v,
    0x6543)``, v, ``__byte_perm(v, next, 0x4321)``, ``__byte_perm(v, next,
    0x5432)``.  ``packed``: three dp4a's of the unsigned window bytes against
    the row's taps packed as signed bytes with a zero fourth byte; else a
    uint32 multiply-add per tap.  Then the sum read as uint32, ``div_exact``
    by ``div_magic(norm)``, the quotient read as int32 and clamped to 0..255."""
    n, h, w = frames.shape
    words = _row_words(frames, 0)
    prev, v, nxt = words[..., :-2], words[..., 1:-1], words[..., 2:]
    wins = [_byte_perm(prev, v, 0x6543), v, _byte_perm(v, nxt, 0x4321), _byte_perm(v, nxt, 0x5432)]
    k = [[int(t) for t in row] for row in taps]
    sums = []
    for j in range(4):
        acc = np.zeros((n, h, v.shape[-1]), np.int64)
        for dy in range(3):
            win = wins[j][:, dy:dy + h]
            if packed:
                tw = sum((k[dy][i] & 0xFF) << (8 * i) for i in range(3))  # byte 3 is 0
                for i in range(4):
                    u8 = ((win >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.int64)
                    s8 = ((tw >> (8 * i)) & 0xFF) - (256 if (tw >> (8 * i)) & 0x80 else 0)
                    acc += u8 * s8
            else:
                for i in range(3):
                    u8 = ((win >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.int64)
                    acc = (acc + u8 * (k[dy][i] & 0xFFFFFFFF)) & 0xFFFFFFFF
        if packed:
            assert np.abs(acc).max() <= 9 * 255 * 128  # the int32 sum never wraps
        sums.append(acc & 0xFFFFFFFF)
    s = np.stack(sums, -1).reshape(n, h, -1)[..., :w].astype(np.uint64)
    d = np.uint64(norm)
    m = np.uint64(2**32 - 1 if norm == 1 else (2**32 - 1) // norm + 1)
    q = (s * m) >> np.uint64(32)  # __umulhi: s, m < 2^32, so s * m < 2^64
    qd = q * d
    q = q - (qd > s).astype(np.uint64) + (qd + d <= s).astype(np.uint64)
    np.testing.assert_array_equal(q, s // d)
    q32 = np.where(q >= 2**31, q.astype(np.int64) - 2**32, q.astype(np.int64))
    return np.clip(q32, 0, 255).astype(np.uint8)


INT8_TAPS = {"sharpen": ((0, -1, 0), (-1, 5, -1), (0, -1, 0)),
             "emboss": ((-2, -1, 0), (-1, 1, 1), (0, 1, 2)),
             "blur_box": ((1, 1, 1), (1, 1, 1), (1, 1, 1)),
             "blur_gaussian": ((1, 2, 1), (2, 4, 2), (1, 2, 1)),
             "sobel_y": ((-1, -2, -1), (0, 0, 0), (1, 2, 1))}


@pytest.mark.parametrize("name", sorted(INT8_TAPS))
def test_filter3_packed_dot_products_replayed(name):
    """K13's int8 path replayed in numpy equals the plain version and JAX's
    XLA ``filter2d`` for norms 1 .. 255 and at 2^31 and 2^32 - 1, and JAX
    ``filter3_pallas`` (interpret mode) at norms 1 and 7, one each side of its
    sign test (the norm does not change what it compiles), which holds only
    below about 16 M: a negative sum clamps to 0 with norm 1, to 255 with
    norms 2 .. 255, and the cast quotient decides past 2^31."""
    taps = INT8_TAPS[name]
    frames = _frames((2, 11, 37), 30)
    frames[1, :4] = 255  # all-white rows: the largest sums, and the most negative ones
    for norm in (1, 7):
        _eq(torch.from_numpy(_filter3_replay(frames, taps, norm, packed=True)),
            filter3_pallas(frames, taps, norm, interpret=True),
            f"{name} norm {norm} vs filter3_pallas")
    for norm in (1, 2, 7, 9, 16, 255, 2**31, 2**32 - 1):
        got = _filter3_replay(frames, taps, norm, packed=True)
        _eq(K.filter3(torch.from_numpy(frames), taps, norm), got, f"{name} norm {norm}")
        _eq(torch.from_numpy(got), gs.filter2d(frames, np.array(taps), norm),
            f"{name} norm {norm} vs filter2d")


def test_filter3_int8_boundary_taps():
    """``gs_filter3`` packs the taps only where every one fits int8: 127 and
    -128 take the dp4a path, 128 and -129 the uint32 multiply-add path (read
    as signed bytes they would be -128 and 127).  Each path, replayed, equals
    the plain version and JAX."""
    frames = _frames((2, 9, 21), 31)
    edge = ((127, -128, 127), (-128, 127, -128), (127, -128, 127))
    past = ((128, -129, 0), (1, 2, 3), (-129, 0, 128))
    for norm in (1, 2, 255):
        got = _filter3_replay(frames, edge, norm, packed=True)
        _eq(K.filter3(torch.from_numpy(frames), edge, norm), got, f"127/-128 norm {norm}")
        _eq(torch.from_numpy(got), gs.filter2d(frames, np.array(edge), norm),
            f"127/-128 norm {norm} vs filter2d")
        if norm == 2:
            _eq(torch.from_numpy(got), filter3_pallas(frames, edge, norm, interpret=True),
                f"127/-128 norm {norm} vs filter3_pallas")
        got = _filter3_replay(frames, past, norm, packed=False)
        _eq(K.filter3(torch.from_numpy(frames), past, norm), got, f"128/-129 norm {norm}")
        _eq(torch.from_numpy(got), gs.filter2d(frames, np.array(past), norm),
            f"128/-129 norm {norm} vs filter2d")
        assert not np.array_equal(_filter3_replay(frames, past, norm, packed=True), got)
    assert _filter3_replay(frames, edge, 1, packed=False).tobytes() == \
        _filter3_replay(frames, edge, 1, packed=True).tobytes()


def _vop4(op, a, b):
    """``__vminu4`` / ``__vmaxu4``: the bytewise unsigned min or max of two words."""
    out = np.zeros_like(a)
    for i in range(4):
        sh = np.uint64(8 * i)
        out |= op((a >> sh) & np.uint64(0xFF), (b >> sh) & np.uint64(0xFF)) << sh
    return out


@pytest.mark.parametrize("op", ["erode", "dilate"])
def test_morph_simd_words_replayed(op):
    """K12 (``csrc/stencil3.cu:morph_words``) in numpy: the vertical min or max
    of three rows' words, then of each word and its two ``__byte_perm``-shifted
    neighbours, the frame bordered by the op-neutral byte.  On rows of width
    612 (config #2's, the 4-byte path), 16, 17 and 1 it equals the plain
    version and JAX (``morph_pallas`` in interpret mode where the frame is 8
    wide, else ``gs.erode`` / ``gs.dilate``).  The lane layout (lane l holds
    words 4l .. 4l + 3 of a 512-column segment; word 0's left neighbour is
    lane l - 1's word 3 by ``__shfl_up_sync``, word 3's right one lane l + 1's
    word 0 by ``__shfl_down_sync``) gives every word its true neighbours."""
    fn = np.minimum if op == "erode" else np.maximum
    neutral = 255 if op == "erode" else 0
    rng = np.random.default_rng(32)
    a, b = rng.integers(0, 2**32, (2, 4096), dtype=np.uint64)
    want = _word_bytes(a, 16384).astype(np.int64), _word_bytes(b, 16384).astype(np.int64)
    np.testing.assert_array_equal(_word_bytes(_vop4(fn, a, b), 16384), fn(*want))
    for w in (612, 16, 17, 1):
        frames = _frames((2, 9, w), 33 + w)
        frames[1, 3:6] = 255 - neutral  # a band of the absorbing value
        words = _row_words(frames, neutral)
        vert = _vop4(fn, _vop4(fn, words[:, :-2], words[:, 1:-1]), words[:, 2:])
        prev, v, nxt = vert[..., :-2], vert[..., 1:-1], vert[..., 2:]
        out = _vop4(fn, _vop4(fn, _byte_perm(prev, v, 0x6543), v), _byte_perm(v, nxt, 0x4321))
        got = _word_bytes(out, w)
        _eq(K.morph(torch.from_numpy(frames), op), got, f"width {w}")
        ref = morph_pallas(frames, op, interpret=True) if w >= 8 else getattr(gs, op)(frames)
        _eq(torch.from_numpy(got), ref, f"width {w} vs JAX")
    # lane l, word k of a segment holds word 4l + k; the lane rules give words i - 1 and i + 1
    idx = np.arange(128).reshape(32, 4)  # [lane, k]
    left = np.concatenate([np.roll(idx[:, 3:], 1, axis=0), idx[:, :3]], axis=1)
    right = np.concatenate([idx[:, 1:], np.roll(idx[:, :1], -1, axis=0)], axis=1)
    # lane 0's word 0 takes the left byte, lane 31's word 3 the right byte
    np.testing.assert_array_equal(left.ravel()[1:], np.arange(127))
    np.testing.assert_array_equal(right.ravel()[:-1], np.arange(1, 128))


def test_stencil3_access_width_follows_the_kernel():
    """chip_smoke.py names the access width of K12's launches on config #2
    with ``stencil3_access``, which repeats ``csrc/stencil3.cu:access_width``:
    16 bytes where the row width and both addresses are multiples of 16, 4
    where they are multiples of 4 (config #2's 612-byte rows), else 1."""
    import chip_smoke

    src = (_build.CSRC_DIR / "stencil3.cu").read_text()
    assert "return (a & 15) == 0 ? kVectors : (a & 3) == 0 ? kWords : kBytes;" in src
    base = 1 << 21
    for w, want in ((612, 4), (1024, 16), (7, 1), (1000, 4), (129, 1)):
        assert chip_smoke.stencil3_access(base, base + 512 * w, w) == want, w
    assert chip_smoke.stencil3_access(base + 4, base, 1024) == 4
    assert chip_smoke.stencil3_access(base, base + 8, 1024) == 4
    assert chip_smoke.stencil3_access(base + 1, base, 612) == 1
    assert chip_smoke.stencil3_access(base, base + 2, 1024) == 1


def test_build_command_targets_hopper_without_fma(tmp_path):
    srcs = _build.sources()
    assert {s.name for s in srcs} == {"preproc.cu", "otsu.cu", "integral.cu", "lbp.cu", "fast.cu",
                                      "patches.cu", "ccl.cu", "warp.cu", "stencil3.cu",
                                      "resize.cu", "bandwidth.cu", "template.cu", "contour.cu",
                                      "freestanding.cu", "blobs.cu"}
    for src in srcs:  # one nvcc per source, started together
        cmd = _build.compile_command(src, tmp_path / f"{src.stem}.o")
        assert cmd[0].endswith("nvcc")
        assert "arch=compute_90a,code=sm_90a" in cmd and "-fmad=false" in cmd
        assert "--use_fast_math" not in cmd
        assert {"-c", "-O3", "-std=c++17", "-fPIC"} <= set(cmd)
        assert cmd[cmd.index("-o") + 1] == str(tmp_path / f"{src.stem}.o")
        assert [c for c in cmd if c.endswith(".cu")] == [str(src)]
    objs = [tmp_path / f"{src.stem}.o" for src in srcs]
    link = _build.link_command(objs, tmp_path / "lib.so")
    assert "-shared" in link and "arch=compute_90a,code=sm_90a" in link
    assert link[link.index("-o") + 1] == str(tmp_path / "lib.so")
    assert link[-len(objs):] == [str(o) for o in objs]
    # the library name is keyed by the sources: a new hash means a rebuild
    assert _build._library_path(srcs).name.startswith("libgs_kernels_")
    assert _build._library_path(srcs) == _build._library_path(srcs)
    assert _build._library_path(srcs[:1]) != _build._library_path(srcs)
    assert set(_build._SIGNATURES) == {"gs_blur_hist", "gs_threshold_sobel", "gs_otsu",
                                       "gs_integral", "gs_lbp_eval_scale", "gs_fast",
                                       "gs_orb_moments", "gs_orb_brief", "gs_ccl",
                                       "gs_quad_warp", "gs_adaptive", "gs_morph", "gs_filter3",
                                       "gs_resize", "gs_blur_hist_window",
                                       "gs_threshold_sobel_window", "gs_copy", "gs_triad",
                                       "gs_match_template", "gs_contour", "gs_quad_warp_rows",
                                       "gs_fs_orient", "gs_fs_atan2", "gs_fs_sin",
                                       "gs_blob_stats"}


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "no-such-nvcc"))
    with pytest.raises(RuntimeError, match="not found"):
        _build.build()
    assert not list((tmp_path / "build").iterdir())  # the work directory is removed
