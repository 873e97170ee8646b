"""The port's kernel modules against the Pallas kernels they replace.

On the CPU a kernel wrapper runs its plain version; here those plain versions
are held, with tolerance 0, to the Pallas kernels run in interpret mode the way
``tests/test_preproc.py`` runs them, and to the XLA Otsu sweep.  The CUDA kernels
themselves are held to the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from grayskull_tpu.kernels.preproc import (blur_pallas, fused_blur_hist,
                                           fused_threshold_sobel, sobel_pallas)
from grayskull_tpu.ops.histogram import otsu_from_histogram as jax_otsu_from_histogram
from grayskull_tpu_torch import kernels as K
from grayskull_tpu_torch.kernels import _build
from tests.test_torch_cuda import otsu_edge_histograms

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


def test_plain_runs_on_cpu_without_counting():
    before = K.launch_counts()
    imgs = torch.from_numpy(_frames((1, 9, 10), 15))
    _, hist = K.blur_hist(imgs, 1)
    K.threshold_sobel(imgs, K.otsu(hist, 90))
    assert K.launch_counts() == before
    assert set(before) == {"blur_hist", "threshold_sobel", "otsu"}


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


def test_build_command_targets_hopper_without_fma(tmp_path):
    srcs = _build.sources()
    assert {s.name for s in srcs} == {"preproc.cu", "otsu.cu"}
    cmd = _build.build_command(srcs, tmp_path / "lib.so")
    assert cmd[0].endswith("nvcc")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-fmad=false" in cmd
    assert "--use_fast_math" not in cmd
    assert {"-shared", "-O3", "-std=c++17"} <= set(cmd)
    assert cmd[cmd.index("-o") + 1] == str(tmp_path / "lib.so")
    assert [c for c in cmd if c.endswith(".cu")] == [str(s) for s in srcs]
    # the library name is keyed by the sources: a new hash means a rebuild
    assert _build._library_path(srcs).name.startswith("libgs_kernels_")
    assert _build._library_path(srcs) == _build._library_path(srcs)
    assert _build._library_path(srcs[:1]) != _build._library_path(srcs)
