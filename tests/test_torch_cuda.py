"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without a CUDA device.  The file imports no
JAX, so it also runs where only PyTorch is installed::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Every output is an integer and the Otsu sweep is bit-exact, so the tolerance
is 0.
"""

import numpy as np
import pytest
import torch

import grayskull_tpu_torch as gt
from grayskull_tpu_torch import kernels as K

SHAPES = [(2, 24, 128), (1, 97, 200), (1, 7, 8), (1, 17, 129), (2, 816, 612)]


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
    for name, hist, tot in otsu_edge_histograms():
        h = torch.from_numpy(hist.astype(np.int32)[None]).to(cuda_device)
        assert torch.equal(K.otsu(h, tot), K.otsu_plain(h, tot)), name


@pytest.mark.cuda
def test_preprocess_launches_every_kernel_on_card(cuda_device):
    imgs = _frames((4, 300, 260), 17, cuda_device)
    K.reset_launch_counts()
    out = gt.preprocess(imgs)
    counts = K.launch_counts()
    assert counts == {"blur_hist": 1, "otsu": 1, "threshold_sobel": 1}
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
