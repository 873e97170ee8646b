"""The port's dense pixel ops and K11-K14 against ``grayskull_tpu``'s, on the CPU.

On the CPU a kernel wrapper runs its plain version.  Here those plain versions
and the ops around them are held, with tolerance 0 (every output is uint8), to
the JAX package on the same seeded numpy frames: to the Pallas kernels
``adaptive_pallas``, ``morph_pallas`` and ``filter3_pallas`` in interpret mode
(as ``tests/test_preproc.py`` runs them), to the public JAX ops, to the exact
XLA resize ``grayskull_tpu.ops.pixel._resize`` and to the goldens.  The Pallas
resize in interpret mode is used only for the dyadic 2x upscale, where XLA:CPU's
contraction of its lerp cannot change a bit (``tests/test_pixel.py:240-286``).
The CUDA kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import os

import numpy as np
import pytest
import torch

import grayskull_tpu as gs
import grayskull_tpu_torch as gt
from grayskull_tpu.kernels.preproc import adaptive_pallas, filter3_pallas, morph_pallas
from grayskull_tpu.kernels.resize import resize_pallas
from grayskull_tpu.ops.pixel import _resize as jax_resize
from grayskull_tpu_torch import kernels as K
from grayskull_tpu_torch.kernels.resize import source_coords
from tests.test_torch_cuda import host_arrays_on_cpu  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "tests", "golden", "testdata")
GOLDEN = os.path.join(REPO, "tests", "golden", "goldens.npz")
SHAPES = [(2, 24, 128), (1, 97, 200), (1, 7, 8), (1, 17, 129)]
PRESETS = {"sharpen": gs.SHARPEN_KERNEL, "emboss": gs.EMBOSS_KERNEL,
           "blur_box": gs.BLUR_BOX_KERNEL, "blur_gaussian": gs.BLUR_GAUSSIAN_KERNEL}
SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], np.int8)  # negative sums
WIDE_TAPS = np.array([[300, -1000, 5], [0, 70000, 0], [1, 2, -99999]], np.int32)


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _eq(port, ref, msg=""):
    assert isinstance(port, torch.Tensor) and port.device.type == "cpu", msg
    assert port.dtype == torch.uint8, msg
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref), err_msg=msg)


@pytest.fixture(scope="module")
def receipt2():
    rec = gt.io.read_pgm(os.path.join(TESTDATA, "receipt.pgm"))
    return np.stack([np.roll(rec, 5 * i, axis=1) for i in range(2)])


@pytest.mark.parametrize("radius", [1, 3, 6, 15])
@pytest.mark.parametrize("shape", SHAPES)
def test_adaptive_vs_adaptive_pallas(shape, radius):
    imgs = _rand(shape, 1)
    for c in (5, -3):
        got = K.adaptive(torch.from_numpy(imgs), radius, c)
        _eq(got, adaptive_pallas(imgs, radius, c, interpret=True), f"{shape} r={radius} c={c}")


@pytest.mark.parametrize("radius", [0, 1, 3, 6, 15, 20, 300])
def test_adaptive_threshold_vs_jax(radius):
    """r <= 15 is the JAX separable path, r = 20 and 300 its prefix-sum path."""
    for shape in SHAPES:
        imgs = _rand(shape, 2)
        for c in (-3, 0, 5, 40, -300):
            _eq(gt.adaptive_threshold(imgs, radius, c), gs.adaptive_threshold(imgs, radius, c),
                f"{shape} r={radius} c={c}")
    one = _rand((33, 45), 3)  # a single (H, W) frame keeps its layout
    _eq(gt.adaptive_threshold(one, radius, 7), gs.adaptive_threshold(one, radius, 7))


def test_adaptive_int32_offsets():
    """``thr = mean - c`` wraps as int32: c = -2^31 makes every threshold
    negative, so every pixel is 255, as in the JAX op."""
    imgs = _rand((1, 17, 29), 4)
    for c in (-2**31, 2**31 - 1, -256, 255, 256):
        _eq(gt.adaptive_threshold(imgs, 2, c), gs.adaptive_threshold(imgs, 2, c), f"c={c}")
    assert bool((gt.adaptive_threshold(imgs, 2, -2**31) == 255).all())
    with pytest.raises(ValueError):
        K.adaptive(torch.from_numpy(imgs), 2, 2**31)


@pytest.mark.parametrize("op", ["erode", "dilate"])
@pytest.mark.parametrize("shape", SHAPES + [(1, 1, 9), (2, 5, 1)])
def test_morph_vs_morph_pallas_and_jax(shape, op):
    imgs = _rand(shape, 5)
    got = K.morph(torch.from_numpy(imgs), op)
    _eq(got, getattr(gs, op)(imgs), f"{shape} {op} vs gs.{op}")
    if min(shape[1:]) >= 7:  # Pallas takes 8-wide frames and 8-row blocks
        _eq(got, morph_pallas(imgs, op, interpret=True), f"{shape} {op} vs morph_pallas")
    _eq(getattr(gt, op)(imgs[0]), getattr(gs, op)(imgs[0]), "one (H, W) frame")


def test_morph_border_is_clipped_not_zero():
    """A white frame stays white under erode (the border is 255-neutral, not 0)
    and a black one black under dilate; a zero pad would pass on interior data only."""
    white, black = np.full((1, 6, 9), 255, np.uint8), np.zeros((1, 6, 9), np.uint8)
    _eq(gt.erode(white), white)
    _eq(gt.dilate(black), black)
    dot = black.copy()
    dot[0, 0, 0] = 200
    _eq(gt.dilate(dot), gs.dilate(dot))
    assert int(gt.dilate(dot)[0, 1, 1]) == 200 and int(gt.dilate(dot)[0, 2, 2]) == 0


@pytest.mark.parametrize("name", sorted(PRESETS) + ["sobel_y_norm1", "sobel_y_norm7"])
@pytest.mark.parametrize("shape", SHAPES)
def test_filter3_vs_filter3_pallas(shape, name):
    """int8 taps, the TPU kernel's domain; SOBEL_Y's negative sums with norm 1
    clamp to 0 and with norm 7 wrap to 255."""
    taps, norm = PRESETS.get(name, (SOBEL_Y, 7 if name.endswith("7") else 1))
    imgs = _rand(shape, 6)
    t = tuple(tuple(int(v) for v in row) for row in np.asarray(taps))
    got = K.filter3(torch.from_numpy(imgs), t, norm)
    _eq(got, filter3_pallas(imgs, t, norm, interpret=True), f"{shape} {name}")


@pytest.mark.parametrize("kernel,norm", [
    (WIDE_TAPS, 1), (WIDE_TAPS, 3), (-WIDE_TAPS, 2**32 - 1),
    (np.random.default_rng(7).integers(-5, 6, (5, 5)), 4),
    (np.random.default_rng(8).integers(-9, 10, (1, 4)), 1),
    (np.random.default_rng(9).integers(0, 256, (3, 3)).astype(np.uint8), 2),
    (SOBEL_Y.astype(np.uint8), 1),
])
def test_filter2d_vs_jax(kernel, norm):
    """Taps past int8 (the JAX XLA path), kernels other than 3x3 (plain on any
    device) and uint8 kernel images (reinterpreted as int8 before the taps)."""
    for shape in SHAPES:
        imgs = _rand(shape, 10)
        _eq(gt.filter2d(imgs, kernel, norm), gs.filter2d(imgs, kernel, norm), f"{shape}")
    assert gt.ops.pixel.filter is gt.filter2d
    with pytest.raises(ValueError):
        gt.filter2d(imgs, kernel, 0)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_presets_vs_jax(name):
    for shape in SHAPES:
        imgs = _rand(shape, 11)
        _eq(getattr(gt, name)(imgs), getattr(gs, name)(imgs), f"{shape} {name}")
    for const in ("SHARPEN_KERNEL", "EMBOSS_KERNEL", "BLUR_BOX_KERNEL", "BLUR_GAUSSIAN_KERNEL"):
        k, n = getattr(gt, const)
        jk, jn = getattr(gs, const)
        assert k.dtype == np.int8 and np.array_equal(k, jk) and n == jn


RESIZE_CASES = [((24, 128), (48, 256)), ((97, 200), (35, 61)), ((7, 8), (13, 5)),
                ((17, 129), (17, 129)), ((1, 1), (5, 7)), ((7, 1), (3, 9)), ((1, 40), (6, 3)),
                ((64, 96), (100, 40)), ((100, 128), (480, 640))]


@pytest.mark.parametrize("src,dst", RESIZE_CASES)
def test_resize_vs_exact_xla_path(src, dst):
    imgs = _rand((2,) + src, 12)
    got = K.resize(torch.from_numpy(imgs), dst)
    assert tuple(got.shape) == (2,) + dst
    _eq(got, jax_resize(imgs, dst), f"{src}->{dst}")
    _eq(gt.resize(imgs[1], dst), jax_resize(imgs[1], dst), "one (H, W) frame")


@pytest.mark.parametrize("src", [(100, 128), (24, 256)])
def test_resize_dyadic_vs_resize_pallas(src):
    """A 2x upscale has dyadic weights: Pallas interpret mode is exact there."""
    imgs = _rand((2,) + src, 13)
    dst = (src[0] * 2, src[1] * 2)
    _eq(gt.resize(imgs, dst), resize_pallas(imgs, dst, interpret=True), f"{src}->{dst}")


def test_resize_coords_divide_by_a_tensor():
    """The plain version's coordinates are the JAX host table's float32 values."""
    from grayskull_tpu.ops.pixel import _src_coords_f32

    for dst_n, src_n in ((480, 1024), (640, 1024), (768, 480), (347, 480), (3, 7), (9, 1)):
        i0, i1, d = source_coords(dst_n, src_n)
        j0, j1, jd = _src_coords_f32(dst_n, src_n)
        assert np.array_equal(i0.numpy(), j0) and np.array_equal(i1.numpy(), j1)
        assert np.array_equal(d.numpy().view(np.int32), np.asarray(jd).view(np.int32))


def test_resize_coords_over_a_sweep_of_sizes():
    """``source_coords`` (what K14 computes in its prologue, a column's once a
    block and a row's once a warp) equals the JAX host table ``_src_coords_f32``
    bit for bit over every output size 1 .. 70 and the benchmark's sizes, for
    source sizes from 1 to 1024, up- and downscales."""
    from grayskull_tpu.ops.pixel import _src_coords_f32

    pairs = [(d, s) for d in range(1, 71) for s in (1, 2, 3, 7, 40, 97, 612, 816, 1024)]
    pairs += [(480, 1024), (640, 1024), (768, 480), (1024, 640), (100, 816), (40, 612), (347, 480)]
    for dst_n, src_n in pairs:
        i0, i1, d = source_coords(dst_n, src_n)
        j0, j1, jd = _src_coords_f32(dst_n, src_n)
        assert np.array_equal(i0.numpy(), j0) and np.array_equal(i1.numpy(), j1), (dst_n, src_n)
        assert np.array_equal(d.numpy().view(np.int32), np.asarray(jd).view(np.int32)), (dst_n, src_n)


def _f32_add_rz(a, b):
    """float32 a + b rounded toward zero: the exact sum in float64, then down one step if rounding went up."""
    exact = a.astype(np.float64) + np.float64(b)
    r = exact.astype(np.float32)
    up = np.abs(r.astype(np.float64)) > np.abs(exact)
    return np.where(up, np.nextafter(r, np.float32(0)), r)


def test_resize_byte_and_truncation_tricks_replayed():
    """K14 (``csrc/resize.cu:lerp``) makes a byte a float as the float with
    bits 0x4B000000 | b less 2^23, and stores the low byte of p + 2^23 rounded
    toward zero.  Both equal C's conversions: every byte exactly, and for p in
    [0, 256) (float32 values next to every integer and a million random ones)
    the truncated ``(uint8_t)(unsigned)p``.  Replayed with them, the kernel's
    lerp equals the plain version and JAX's exact XLA resize."""
    b = np.arange(256, dtype=np.uint32)
    as_float = (b | np.uint32(0x4B000000)).view(np.float32) - np.float32(2**23)
    np.testing.assert_array_equal(as_float, b.astype(np.float32))
    ints = np.arange(257, dtype=np.float32)
    near = np.concatenate([np.nextafter(ints, np.float32(0)), ints, np.nextafter(ints, np.float32(300))])
    rng = np.random.default_rng(40)
    p = np.concatenate([near, rng.uniform(0, 256, 10**6).astype(np.float32)])
    p = p[(p >= 0) & (p < 256)]
    low = _f32_add_rz(p, 2.0**23).view(np.uint32) & np.uint32(0xFF)
    np.testing.assert_array_equal(low, p.astype(np.uint32) % 256)

    for (sh, sw), (dh, dw) in (((97, 200), (35, 61)), ((24, 128), (48, 256)), ((7, 1), (3, 9))):
        imgs = _rand((2, sh, sw), 41)
        x0, x1, dx = (t.numpy() for t in source_coords(dw, sw))
        y0, y1, dy = (t.numpy() for t in source_coords(dh, sh))
        byte_f = lambda c: (c.astype(np.uint32) | np.uint32(0x4B000000)).view(np.float32) - np.float32(2**23)
        ndx, ndy = np.float32(1) - dx, np.float32(1) - dy
        c = lambda ys, xs: byte_f(imgs[:, ys][:, :, xs])
        t1 = (c(y0, x0) * ndx[None, None]) * ndy[None, :, None]
        t2 = (c(y0, x1) * dx[None, None]) * ndy[None, :, None]
        t3 = (c(y1, x0) * ndx[None, None]) * dy[None, :, None]
        t4 = (c(y1, x1) * dx[None, None]) * dy[None, :, None]
        got = (_f32_add_rz(((t1 + t2) + t3) + t4, 2.0**23).view(np.uint32) & np.uint32(0xFF)).astype(np.uint8)
        _eq(K.resize(torch.from_numpy(imgs), (dh, dw)), got, f"{(sh, sw)}->{(dh, dw)}")
        _eq(torch.from_numpy(got), jax_resize(imgs, (dh, dw)), f"{(sh, sw)}->{(dh, dw)} vs JAX")


@pytest.mark.parametrize("size", [(7, 150), (1, 1), (64, 96), (200, 13), (33, 290)])
def test_resize_nn_vs_jax(size):
    for shape in SHAPES:
        imgs = _rand(shape, 14)
        _eq(gt.resize_nn(imgs, size), gs.resize_nn(imgs, size), f"{shape} -> {size}")


def test_crop_and_copy_vs_jax():
    imgs = _rand((2, 24, 128), 15)
    for roi in ((0, 0, 128, 24), (5, 3, 40, 20), (127, 23, 1, 1), gs.Rect(20, 10, 40, 14)):
        got = gt.crop(imgs, roi)
        assert got.is_contiguous()
        _eq(got, gs.crop(imgs, roi), str(roi))
        _eq(gt.crop(imgs[0], roi), gs.crop(imgs[0], roi), str(roi))
    for bad in ((-1, 0, 4, 4), (0, 0, 0, 4), (120, 0, 9, 4), (0, 20, 4, 5)):
        with pytest.raises(ValueError):
            gt.crop(imgs, bad)
    src = torch.from_numpy(imgs)
    dup = gt.copy(src)
    _eq(dup, gs.copy(imgs))
    dup[0, 0, 0] ^= 1
    assert not torch.equal(dup, src)  # a copy, not a view


def test_goldens():
    g = np.load(GOLDEN)
    img = g["input"]
    got = {
        "adaptive_15_5": gt.adaptive_threshold(img, 15, 5), "erode": gt.erode(img),
        "dilate": gt.dilate(img), "sharpen": gt.sharpen(img), "emboss": gt.emboss(img),
        "blur_box3": gt.blur_box(img), "blur_gaussian3": gt.blur_gaussian(img),
        "resize_100_40": gt.resize(img, (100, 40)), "resize_nn_7_150": gt.resize_nn(img, (7, 150)),
        "crop_20_10_40_30": gt.crop(img, gt.Rect(20, 10, 40, 30)),
    }
    for name, value in got.items():
        _eq(value, g[name], name)


def test_config2_on_two_receipt_frames(receipt2):
    """BASELINE config #2 (``benchmarks/bench_all.py:169-181``):
    ``erode(dilate(adaptive_threshold(x, 15, 5)))`` on receipt rolled 5*i columns."""
    got = gt.erode(gt.dilate(gt.adaptive_threshold(receipt2, 15, 5)))
    want = gs.erode(gs.dilate(gs.adaptive_threshold(receipt2, 15, 5)))
    assert tuple(got.shape) == (2, 816, 612)
    _eq(got, want, "config #2")
    assert 0 < int((got == 255).sum()) < got.numel()  # a real binary image


def test_dense_wrappers_reject_bad_input():
    good = torch.zeros((2, 8, 8), dtype=torch.uint8)
    for bad, err in ((good.to(torch.int32), TypeError), (good[0], ValueError),
                     (good[:, :, ::2], ValueError), (good[:, :0], ValueError)):
        with pytest.raises(err):
            K.adaptive(bad, 1, 0)
        with pytest.raises(err):
            K.morph(bad, "erode")
        with pytest.raises(err):
            K.filter3(bad, ((0, 0, 0), (0, 1, 0), (0, 0, 0)), 1)
        with pytest.raises(err):
            K.resize(bad, (4, 4))
    with pytest.raises(ValueError):
        K.adaptive(good, -1, 0)
    with pytest.raises(ValueError):  # window sum past int32
        K.adaptive(torch.zeros((1, 3000, 3000), dtype=torch.uint8), 1500, 0)
    with pytest.raises(ValueError):
        K.morph(good, "open")
    for taps, norm in ((((1, 2), (3, 4)), 1), (((0,) * 3,) * 3, 0), (((0,) * 3,) * 3, 2**32),
                       (((2**31, 0, 0), (0,) * 3, (0,) * 3), 1)):
        with pytest.raises(ValueError):
            K.filter3(good, taps, norm)
    for size in ((0, 4), (4, -1)):
        with pytest.raises(ValueError):
            K.resize(good, size)

