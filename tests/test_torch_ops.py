"""The port's main-path ops against ``grayskull_tpu``'s, on the CPU.

The same uint8 inputs, made with numpy from a seed, go through both packages.
Every output is an integer (Otsu's threshold follows the bit-exact C sweep), so
the tolerance is 0: arrays must be equal.
"""

import os

import numpy as np
import pytest
import torch

import grayskull_tpu as gs
import grayskull_tpu_torch as gt
from grayskull_tpu.ops.histogram import otsu_from_histogram as jax_otsu_from_histogram
from tests.test_torch_cuda import otsu_edge_histograms

SHAPES = [(1, 64, 96), (3, 97, 200), (2, 7, 8), (2, 17, 129)]
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "goldens.npz")


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _eq(port, ref, msg=""):
    assert isinstance(port, torch.Tensor) and port.device.type == "cpu", msg
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref), err_msg=msg)


@pytest.mark.parametrize("radius", [0, 1, 2, 5, 6, 7, 9, 16])
def test_blur_matches_jax(radius):
    for i, shape in enumerate(SHAPES):
        imgs = _frames(shape, 100 + i)
        _eq(gt.blur(imgs, radius), gs.blur(imgs, radius), f"{shape} r={radius}")
    single = _frames((23, 31), 7)
    _eq(gt.blur(single, radius), gs.blur(single, radius), f"single r={radius}")


@pytest.mark.parametrize("shape", SHAPES)
def test_sobel_matches_jax(shape):
    imgs = _frames(shape, 1)
    _eq(gt.sobel(imgs), gs.sobel(imgs), str(shape))
    _eq(gt.sobel(imgs[0]), gs.sobel(imgs[0]), f"{shape} single")


@pytest.mark.parametrize("shape", SHAPES)
def test_threshold_matches_jax(shape):
    imgs = _frames(shape, 2)
    for t in (0, 100, 254, 255):
        _eq(gt.threshold(imgs, t), gs.threshold(imgs, t), f"{shape} t={t}")
    per_frame = np.random.default_rng(3).integers(0, 256, shape[0], dtype=np.uint8)
    _eq(gt.threshold(imgs, torch.from_numpy(per_frame)),
        gs.threshold(imgs, per_frame[:, None, None]), f"{shape} per-frame")


@pytest.mark.parametrize("shape", SHAPES)
def test_histogram_matches_jax(shape):
    imgs = _frames(shape, 4)
    got = gt.histogram(imgs)
    assert got.dtype == torch.int32 and tuple(got.shape) == (shape[0], 256)
    _eq(got, np.asarray(gs.histogram(imgs)).astype(np.int32), str(shape))
    _eq(gt.histogram(imgs[0]), np.asarray(gs.histogram(imgs[0])).astype(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_otsu_threshold_matches_jax(shape):
    imgs = _frames(shape, 5)
    blurred = np.asarray(gs.blur(imgs, 2))  # smooth content: interior thresholds
    for x in (imgs, blurred):
        got = gt.otsu_threshold(x)
        assert got.dtype == torch.uint8 and tuple(got.shape) == (shape[0],)
        _eq(got, gs.otsu_threshold(x), str(shape))
        _eq(gt.otsu_threshold(x[0]), gs.otsu_threshold(x[0]), f"{shape} single")


@pytest.mark.parametrize("name,hist,total", otsu_edge_histograms(),
                         ids=[c[0] for c in otsu_edge_histograms()])
def test_otsu_from_histogram_edge_cases(name, hist, total):
    got = gt.otsu_from_histogram(torch.from_numpy(hist.astype(np.int32)), total)
    assert got.ndim == 0 and got.dtype == torch.uint8
    ref = jax_otsu_from_histogram(hist.astype(np.uint32), total)
    assert int(got) == int(ref), name


def test_otsu_from_histogram_batched_random():
    rng = np.random.default_rng(6)
    hists = rng.integers(0, 400, (5, 3, 256))
    hists[1, 2, :90] = 0
    totals = hists.sum(-1)
    for total in {int(totals[0, 0]), 256 * 200}:
        got = gt.otsu_from_histogram(torch.from_numpy(hists), total)
        assert tuple(got.shape) == (5, 3)
        _eq(got, jax_otsu_from_histogram(hists.astype(np.uint32), total))


@pytest.mark.parametrize("name", ["blur2", "blur9", "sobel", "histogram", "otsu", "threshold_100"])
def test_goldens(name):
    g = np.load(GOLDEN)
    img = g["input"]
    got = {
        "blur2": lambda: gt.blur(img, 2),
        "blur9": lambda: gt.blur(img, 9),
        "sobel": lambda: gt.sobel(img),
        "histogram": lambda: gt.histogram(img),
        "otsu": lambda: gt.otsu_threshold(img),
        "threshold_100": lambda: gt.threshold(img, 100),
    }[name]()
    _eq(got, g[name].astype(np.int32) if name == "histogram" else g[name], name)


def test_as_image_conventions():
    img = _frames((5, 6), 8)
    t = gt.as_image(img)
    assert t.dtype == torch.uint8 and t.device.type == "cpu" and not gt.is_batched(t)
    frozen = img.copy()
    frozen.setflags(write=False)
    assert torch.equal(gt.as_image(frozen), t)
    assert gt.is_batched(gt.as_image(img[None]))
    with pytest.raises(TypeError):
        gt.as_image(img.astype(np.int32))
    with pytest.raises(ValueError):
        gt.as_image(img[None, None])
    with pytest.raises(ValueError):
        gt.as_image(img[0])
    r = gt.Rect(1, 2, 3, 4)
    assert (r.x, r.h, gt.Point(5, 6).y) == (1, 4, 6)


def test_ops_keep_layout_and_accept_strided():
    imgs = _frames((2, 20, 30), 9)
    strided = torch.from_numpy(imgs)[:, :, ::2]  # non-contiguous view
    assert not strided.is_contiguous()
    ref = np.ascontiguousarray(imgs[:, :, ::2])
    _eq(gt.blur(strided, 3), gs.blur(ref, 3))
    _eq(gt.sobel(strided), gs.sobel(ref))
    assert tuple(gt.blur(strided[0], 1).shape) == (20, 15)
