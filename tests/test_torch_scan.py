"""The port's quad warp and document scanner against ``grayskull_tpu``'s, on the CPU.

K10's plain version (through ``perspective_correct``), ``preprocess_binarize``
and ``scan`` are held, with tolerance 0 (every output is an integer), to the
JAX functions on the same inputs: random frames made with numpy from a seed,
``document.pgm`` and the golden ``persp``, and once to the JAX Pallas band
sampler in interpret mode.  Also the repair of host arrays: with no card and
no request for the CPU, a numpy input raises.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grayskull_tpu as gs
import grayskull_tpu_torch as gt
from grayskull_tpu.ops.warp import _warp_batched_tpu
from grayskull_tpu.pipelines.scan import preprocess_binarize as jax_preprocess_binarize
from grayskull_tpu.pipelines.scan import scan as jax_scan
from grayskull_tpu_torch import kernels as K
from grayskull_tpu_torch.core import host_arrays_to
from tests.test_torch_cuda import host_arrays_on_cpu  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "tests", "golden", "testdata")
# tests/test_integral_template_warp.py:193-197: mild, steep and extreme quads on document.pgm
DOC_QUADS = {
    "mild": [[50, 40], [700, 60], [690, 1000], [40, 980]],
    "steep": [[0, 400], [760, 0], [767, 600], [10, 1010]],
    "extreme": [[10, 700], [1000, 10], [1020, 760], [3, 10]],
    "outside": [[-60, -45], [900, -10], [820, 1200], [-30, 1100]],
}


@pytest.fixture(scope="module")
def document():
    return gt.io.read_pgm(os.path.join(TESTDATA, "document.pgm"))


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _eq(port, ref, msg=""):
    assert isinstance(port, torch.Tensor) and port.device.type == "cpu", msg
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref), err_msg=msg)


def test_perspective_identity_quad():
    img = _rand((20, 30), 1)
    c = np.array([(0, 0), (29, 0), (29, 19), (0, 19)], np.int32)
    _eq(gt.perspective_correct(img, c, (20, 30)), gs.perspective_correct(img, c, (20, 30)))


@pytest.mark.parametrize("trial", range(5))
def test_perspective_random_quads(trial):
    """``tests/test_integral_template_warp.py:108-117``'s cases, corners also outside the frame."""
    rng = np.random.default_rng(100 + trial)
    img = _rand((48, 64), trial)
    size = (int(rng.integers(4, 100)), int(rng.integers(4, 100)))
    for lo, hi in ((0, 64), (-40, 110)):
        c = np.stack([rng.integers(lo, hi, 4), rng.integers(lo * 3 // 4, hi * 3 // 4, 4)],
                     axis=1).astype(np.int32)
        _eq(gt.perspective_correct(img, c, size), gs.perspective_correct(img, c, size), str(c))


def test_perspective_one_row_or_column():
    """0/0 in the grid: the JAX package's page is src[0, 0] everywhere (its
    integer float adder turns the NaN into -inf, which clamps to 0)."""
    img = _rand((48, 64), 7)
    c = np.array([[3, 4], [50, 6], [40, 30], [5, 40]], np.int32)
    for size in ((1, 1), (1, 10), (10, 1)):
        with np.errstate(invalid="ignore"):
            want = gs.perspective_correct(img, c, size)
        _eq(gt.perspective_correct(img, c, size), want, str(size))
        assert (np.asarray(want) == img[0, 0]).all()


def test_perspective_golden():
    g = np.load(os.path.join(REPO, "tests", "golden", "goldens.npz"))
    _eq(gt.perspective_correct(g["input"], g["persp_corners"].astype(np.int32), (50, 70)),
        g["persp"])


def test_perspective_document_quads(document):
    for name, q in DOC_QUADS.items():
        c = np.array(q, np.int32)
        _eq(gt.perspective_correct(document, c, (1000, 800)),
            gs.perspective_correct(document, c, (1000, 800)), name)


def test_perspective_batched(document):
    frames = np.stack([document, document[::-1].copy()])
    quads = np.array([DOC_QUADS["mild"], DOC_QUADS["outside"]], np.int32)
    got = gt.perspective_correct(frames, quads, (97, 61))
    for i in range(2):
        assert torch.equal(got[i], gt.perspective_correct(frames[i], quads[i], (97, 61)))
    shared = gt.perspective_correct(frames, quads[0], (97, 61))
    assert torch.equal(shared[0], got[0])
    assert torch.equal(shared[1], gt.perspective_correct(frames[1], quads[0], (97, 61)))
    with pytest.raises(TypeError):
        gt.perspective_correct(frames[0], quads[0].astype(np.float32), (4, 4))
    with pytest.raises(ValueError):
        gt.perspective_correct(frames[0], quads, (4, 4))
    with pytest.raises(ValueError):
        K.quad_warp(torch.from_numpy(frames), torch.from_numpy(quads), (0, 4))


def test_quad_warp_matches_pallas_band_sampler(document):
    """The odd-height (347, 200) page of ``tests/test_integral_template_warp.py:120-138``
    against ``_warp_batched_tpu`` in interpret mode."""
    h, w = document.shape
    c = np.array([(int(w * 0.1), int(h * 0.15)), (int(w * 0.9), int(h * 0.1)),
                  (int(w * 0.85), int(h * 0.9)), (int(w * 0.12), int(h * 0.88))], np.int32)
    want = _warp_batched_tpu(jnp.asarray(document)[None], jnp.asarray(c)[None], (347, 200),
                             interpret=True)
    got = K.quad_warp(torch.from_numpy(document[None].copy()), torch.from_numpy(c[None]),
                      (347, 200))
    _eq(got, want)


def test_preprocess_binarize_matches_jax(document):
    _eq(gt.preprocess_binarize(document), jax_preprocess_binarize(jnp.asarray(document)))
    # a bright frame: Otsu's threshold is >= 246, so otsu + 10 wraps past 255
    rng = np.random.default_rng(3)
    bright = np.where(rng.random((40, 56)) < 0.5, 248, 255).astype(np.uint8)
    t = int(gs.otsu_threshold(gs.blur(bright, 1)))
    assert t >= 246
    want = jax_preprocess_binarize(jnp.asarray(bright))
    assert np.asarray(want).any()  # the wrapped threshold is small, so most pixels pass
    _eq(gt.preprocess_binarize(bright), want)
    frames = np.stack([bright, _rand((40, 56), 4)])
    got = gt.preprocess_binarize(frames)
    _eq(got[1], jax_preprocess_binarize(jnp.asarray(frames[1])))
    assert torch.equal(got[0], gt.preprocess_binarize(bright))
    assert torch.equal(got, gt.preprocess_binarize(frames, force_reference=True))


def test_scan_document_matches_jax(document):
    page, corners = gt.scan(document)
    want_page, want_corners = jax_scan(jnp.asarray(document))
    assert tuple(page.shape) == (1000, 800) and corners.dtype == torch.int32
    _eq(corners, want_corners)
    _eq(page, want_page)


def test_scan_batch_matches_jax_and_single(document):
    """``benchmarks/bench_all.py:153``'s batch: frame i rolled 3*i columns."""
    frames = np.stack([np.roll(document, 3 * i, axis=1) for i in range(3)])
    pages, corners = gt.scan(frames)
    want_pages, want_corners = jax_scan(jnp.asarray(frames))
    _eq(corners, want_corners)
    _eq(pages, want_pages)
    page, corner = gt.scan(frames[2])
    assert torch.equal(page, pages[2]) and torch.equal(corner, corners[2])
    ref = gt.scan(frames, force_reference=True)
    assert torch.equal(ref[0], pages) and torch.equal(ref[1], corners)


def test_scan_synthetic_quad_and_empty_frame():
    """``tests/test_pipelines.py:37-48``'s bright tilted page, and an all-zero frame."""
    img = np.full((120, 160), 30, np.uint8)
    yy, xx = np.mgrid[0:120, 0:160]
    inside = ((yy > 0.25 * xx - 5) & (yy < 100 - 0.1 * xx) & (xx > 20 + 0.1 * yy)
              & (xx < 140 - 0.05 * yy))
    img[inside] = 220
    zero = np.zeros((120, 160), np.uint8)
    for name, frame in (("quad", img), ("empty", zero)):
        page, corners = gt.scan(frame, out_size=(50, 40))
        want_page, want_corners = jax_scan(jnp.asarray(frame), out_size=(50, 40))
        _eq(corners, want_corners, name)
        _eq(page, want_page, name)
    assert corners.tolist() == [[0, 0]] * 4  # no blob: the zero centroid


def test_host_arrays_need_a_card_or_the_cpu(monkeypatch):
    """Outside ``host_arrays_to("cpu")`` a numpy input goes to the CUDA device;
    with none it raises rather than run on the CPU, and a CPU tensor still runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = _rand((12, 16), 9)
    with host_arrays_to(None):
        with pytest.raises(RuntimeError, match="host_arrays_to"):
            gt.blur(img, 1)
        with pytest.raises(RuntimeError, match="host_arrays_to"):
            gt.scan(img, out_size=(4, 4))
        with pytest.raises(RuntimeError, match="host_arrays_to"):
            gt.otsu_from_histogram(np.ones(256, np.int32), 256)
        out = gt.blur(torch.from_numpy(img), 1)
        assert out.device.type == "cpu"
    assert gt.blur(img, 1).device.type == "cpu"  # the tests' fixture asks for the CPU
