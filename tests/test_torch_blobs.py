"""The port's connected components against ``grayskull_tpu``'s, on the CPU.

K9's plain version ``ccl_plain``, ``label_components``, ``blobs`` and
``blob_corners`` are held, with tolerance 0 (every output is an integer), to
the JAX functions on the same inputs (random frames made with numpy from a
seed, the adversarial frames of ``tests/test_blobs_contour.py`` and the
binarized ``document.pgm``), to the JAX Pallas kernel ``ccl_serpentine`` in
interpret mode, and to the goldens ``blobs_*`` and ``multiblob_*``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grayskull_tpu_torch as gt
from grayskull_tpu.kernels.ccl import ccl_serpentine
from grayskull_tpu.ops.blobs import blob_corners as jax_blob_corners
from grayskull_tpu.ops.blobs import blobs as jax_blobs
from grayskull_tpu.ops.blobs import label_components as jax_label_components
from grayskull_tpu.pipelines.scan import preprocess_binarize as jax_preprocess_binarize
from grayskull_tpu.pipelines.scan import scan as jax_scan
from grayskull_tpu_torch import kernels as K
from grayskull_tpu_torch.core import blobs_from_arrays
from tests.test_torch_cuda import host_arrays_on_cpu, snake, spiral  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "tests", "golden", "testdata")
DENSITIES = (0.3, 0.55, 0.6)  # 0.6 is near the site-percolation threshold


def _random(shape, density, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) < density) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def document_binary():
    doc = gt.io.read_pgm(os.path.join(TESTDATA, "document.pgm"))
    return np.asarray(jax_preprocess_binarize(jnp.asarray(doc)))


@pytest.fixture(scope="module")
def goldens():
    return np.load(os.path.join(REPO, "tests", "golden", "goldens.npz"))


def _ccl(img):
    return K.ccl_plain(torch.from_numpy(img[None].copy()))[0].numpy()


@pytest.mark.parametrize("name", ["snake", "noise", "spiral"])
def test_ccl_plain_matches_serpentine_kernel(name):
    img = {"snake": snake, "noise": lambda: _random((16, 128), 0.45, 7),
           "spiral": lambda: spiral(40, 128)}[name]()
    h, w = img.shape
    fg = img >= 128
    big = 2**30
    l0 = np.full((-(-h // 8) * 8, -(-w // 128) * 128), big, np.int32)
    l0[:h, :w] = np.where(fg, np.arange(h * w, dtype=np.int32).reshape(h, w), big)
    fixpoint, _ = ccl_serpentine(jnp.asarray(l0[None]), interpret=True)
    want = np.where(fg, np.asarray(fixpoint)[0, :h, :w], -1)
    np.testing.assert_array_equal(_ccl(img), want)
    np.testing.assert_array_equal(gt.label_components(img).numpy(), want)


@pytest.mark.parametrize("shape", [(1, 300), (300, 1), (7, 8), (17, 129), (64, 96)])
def test_ccl_plain_matches_label_components(shape):
    for i, density in enumerate(DENSITIES):
        img = _random(shape, density, 10 + i)
        want = np.asarray(jax_label_components(img))
        np.testing.assert_array_equal(_ccl(img), want, err_msg=f"{shape}@{density}")
        got = gt.label_components(img)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_ccl_document_and_batch(document_binary):
    want = np.asarray(jax_label_components(document_binary))
    np.testing.assert_array_equal(_ccl(document_binary), want)
    frames = np.stack([document_binary, document_binary[::-1].copy(), np.zeros_like(want, np.uint8)])
    got = gt.label_components(frames, force_reference=True).numpy()
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], np.asarray(jax_label_components(frames[1])))
    assert (got[2] == -1).all()


def test_ccl_wrapper_checks_its_input():
    with pytest.raises(TypeError):
        K.ccl(torch.zeros((1, 4, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        K.ccl(torch.zeros((4, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        K.ccl(torch.zeros((1, 4, 8), dtype=torch.uint8)[:, :, ::2])


def _same_table(port, ref_table, msg=""):
    ref = blobs_from_arrays(ref_table)
    for name, a, b in zip(port._fields, port, ref):
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        for x, y in pairs:
            assert x.dtype == torch.int32, (msg, name)
            np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=f"{msg} {name}")


def _same_blobs(img, cap, msg=""):
    table, labels, overflowed = gt.blobs(img, cap)
    jt, jl, jo = jax_blobs(img, cap)
    _same_table(table, jt, msg)
    assert labels.dtype == torch.uint16
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl), err_msg=f"{msg} label map")
    assert bool(overflowed) == bool(jo), msg
    return table, labels, overflowed


@pytest.mark.parametrize("shape", [(1, 40), (40, 1), (7, 8), (17, 129), (64, 96)])
def test_blobs_match_jax(shape):
    for i, density in enumerate(DENSITIES):
        img = _random(shape, density, 20 + i)
        _same_blobs(img, 4000, f"{shape}@{density}")
        _same_blobs(img, 3, f"{shape}@{density} cap 3")  # fewer labels than seeds


def test_blobs_document(document_binary):
    table, _, _ = _same_blobs(document_binary, 1000, "document")
    assert int(table.n) > 100


def test_blobs_goldens(goldens):
    for key, cap in (("blobs", 500), ("multiblob", 64)):
        table, labels, _ = gt.blobs(goldens[f"{key}_input"], cap)
        n = int(table.n)
        assert n == len(goldens[f"{key}_label"])
        np.testing.assert_array_equal(labels.numpy(), goldens[f"{key}_labels"])
        np.testing.assert_array_equal(table.label[:n].numpy(), goldens[f"{key}_label"])
        np.testing.assert_array_equal(table.area[:n].numpy(), goldens[f"{key}_area"])
        box = torch.stack([v[:n] for v in table.box], 1).numpy()
        np.testing.assert_array_equal(box, goldens[f"{key}_box"].astype(np.int64))
        cen = torch.stack([v[:n] for v in table.centroid], 1).numpy()
        np.testing.assert_array_equal(cen, goldens[f"{key}_centroid"].astype(np.int64))


def test_blobs_past_capacity_is_flagged():
    """``tests/test_blobs_contour.py:324-328``: a column seeded past capacity
    reconnects to component 1; like the JAX package, the port merges it fully
    and flags the overflow (C drops those pixels)."""
    img = np.zeros((6, 12), np.uint8)
    img[0:4, 0] = 255
    img[3, 0:9] = 255
    img[0, 4] = 255
    img[0:3, 8] = 255
    table, labels, overflowed = _same_blobs(img, 2, "past capacity")
    assert bool(overflowed) and int(table.n) == 2
    assert table.label[:2].tolist() == [1, 2] and table.area[:2].tolist() == [15, 1]
    assert int(labels.to(torch.int32).max()) == 2


def test_blobs_edge_cases():
    empty = np.zeros((4, 5), np.uint8)
    table, labels, overflowed = _same_blobs(empty, 5, "empty")
    assert int(table.n) == 0 and int(labels.to(torch.int32).max()) == 0 and not bool(overflowed)
    dot = np.zeros((3, 3), np.uint8)
    dot[1, 1] = 255
    table, _, _ = _same_blobs(dot, 5, "one pixel")
    assert (int(table.n), table.label[0].item(), table.area[0].item()) == (1, 1, 1)
    assert [v[0].item() for v in table.box] == [1, 1, 1, 1]
    checker = (np.indices((6, 7)).sum(0) % 2 * 255).astype(np.uint8)  # 21 one-pixel blobs
    table, labels, overflowed = _same_blobs(checker, 4, "cap below the seeds")
    assert bool(overflowed) and int(table.n) == 4 and int(labels.to(torch.int32).max()) == 4
    with pytest.raises(ValueError):
        gt.blobs(dot, -1)


def test_blobs_capacity_zero(document_binary):
    """``max_blobs=0``: an empty table, an all-zero label map, and
    ``overflowed`` wherever a frame has a seed, as the JAX op returns."""
    img = np.zeros((4, 4), np.uint8)
    img[0, 0] = img[2, 2] = 255
    for frame, seeds in ((img, True), (np.zeros((4, 5), np.uint8), False),
                         (document_binary, True)):
        table, labels, overflowed = _same_blobs(frame, 0, f"capacity 0, seeds={seeds}")
        assert int(table.n) == 0 and tuple(table.label.shape) == (0,)
        assert int(labels.to(torch.int32).max()) == 0 and bool(overflowed) == seeds
    table, labels, overflowed = gt.blobs(np.stack([img, np.zeros_like(img)]), 0)
    assert table.n.tolist() == [0, 0] and tuple(table.area.shape) == (2, 0)
    assert overflowed.tolist() == [True, False] and not labels.any()
    with pytest.raises(ValueError):  # the largest blob of an empty table
        jax_scan(jnp.asarray(img), out_size=(8, 8), max_blobs=0)
    with pytest.raises(ValueError):
        gt.scan(img, out_size=(8, 8), max_blobs=0)


def _leaves(table):
    return [table.n, table.label, table.area, *table.box, *table.centroid]


def test_blobs_batched_equals_per_frame():
    frames = np.stack([_random((33, 47), d, 30 + i) for i, d in enumerate(DENSITIES)])
    frames[1] = 0
    table, labels, overflowed = gt.blobs(frames, 40)
    assert tuple(table.label.shape) == (3, 40) and tuple(table.n.shape) == (3,)
    for i in range(3):
        one, one_labels, one_over = gt.blobs(frames[i], 40)
        for a, b in zip(_leaves(table), _leaves(one)):
            assert torch.equal(a[i], b), i
        assert torch.equal(labels[i], one_labels) and bool(overflowed[i]) == bool(one_over)
    ref = gt.blobs(frames, 40, force_reference=True)
    assert torch.equal(ref[1], labels)


def test_blobs_coordinate_sums_wrap_unsigned():
    """An all-255 1700x1700 frame: the x and y sums (2,455,055,000) pass 2^31,
    so C's unsigned sums divide unsigned (a signed one would go negative)."""
    img = np.full((1700, 1700), 255, np.uint8)
    table, _, _ = _same_blobs(img, 4, "1700x1700")
    assert int(table.n) == 1 and int(table.area[0]) == 1700 * 1700
    assert [int(v[0]) for v in table.centroid] == [849, 849]


def test_blob_corners_match_jax():
    img = _random((24, 32), 0.6, 40)
    table, labels, _ = gt.blobs(img, 2000)
    jt, jl, _ = jax_blobs(img, 2000)
    n = int(table.n)
    box = torch.stack(list(table.box), 1)
    cen = torch.stack(list(table.centroid), 1)
    got = gt.blob_corners(np.stack([img] * n), labels.expand(n, -1, -1), table.label[:n],
                          gt.Rect(*box[:n].T), gt.Point(*cen[:n].T))
    assert tuple(got.shape) == (n, 4, 2) and got.dtype == torch.int32
    for i in range(n):
        want = jax_blob_corners(img, jl, int(table.label[i]), gt.Rect(*box[i].tolist()),
                                gt.Point(*cen[i].tolist()))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want), err_msg=f"blob {i}")
        single = gt.blob_corners(img, labels, table.label[i], gt.Rect(*box[i]), gt.Point(*cen[i]))
        assert torch.equal(single, got[i])


def test_blob_corners_golden_and_no_pixel(goldens):
    img = goldens["multiblob_input"]
    table, labels, _ = gt.blobs(img, 64)
    big = int(table.area.argmax())
    corners = gt.blob_corners(img, labels, table.label[big], gt.Rect(*(v[big] for v in table.box)),
                              gt.Point(*(v[big] for v in table.centroid)))
    np.testing.assert_array_equal(corners.numpy(), goldens["multiblob_corners"].astype(np.int64))
    # a label with no pixel in the box: every corner is the centroid, as in C
    none = gt.blob_corners(img, labels, 999, gt.Rect(0, 0, 5, 5), gt.Point(17, 3))
    want = jax_blob_corners(img, labels.numpy(), 999, gt.Rect(0, 0, 5, 5), gt.Point(17, 3))
    np.testing.assert_array_equal(none.numpy(), np.asarray(want))
    assert none.tolist() == [[17, 3]] * 4
