"""The port's sharded paths, K15-K18's plain versions and the new profiling
helpers against ``grayskull_tpu``'s, on the CPU.

The JAX functions run on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's mesh lists the CPU device as many times.  Inputs are made with
numpy from a seed.  Every output is an integer, so the tolerance is 0.  The
JAX window kernels run in Pallas interpret mode, as ``tests/test_parallel.py``
runs them.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import grayskull_tpu as gs
import grayskull_tpu_torch as gt
from grayskull_tpu import parallel as jp
from grayskull_tpu.kernels.preproc import fused_blur_hist_window, fused_threshold_sobel_window
from grayskull_tpu.parallel.halo import bottom_halo as jax_bottom_halo
from grayskull_tpu.parallel.halo import exchange_halo as jax_exchange_halo
from grayskull_tpu.pipelines.preproc import preprocess_reference
from grayskull_tpu_torch import kernels as K
from grayskull_tpu_torch import parallel as tp
from grayskull_tpu_torch import profiling
from tests.test_torch_cuda import host_arrays_on_cpu  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
PREPROCESS_OUTPUTS = ("blurred", "binary", "edges", "thresholds")


@pytest.fixture(scope="module")
def cpu8():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return devs[:8]


def _mesh(shape, names=("data", "space")):
    return tp.make_mesh(shape, names, devices=[CPU] * int(np.prod(shape)))


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _eq(got, want, msg=""):
    if isinstance(got, torch.Tensor):
        got = (got.view(torch.int32) if got.dtype == torch.uint32 else got).numpy()
    want = np.asarray(want)
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _shards(frames, k):
    h_loc = frames.shape[-2] // k
    return [torch.from_numpy(frames[..., s * h_loc:(s + 1) * h_loc, :].copy()) for s in range(k)]


def _jax_halo(fn, frames, k, halo, devices):
    """``fn(x, halo, "space")`` in a shard_map over k devices: one array a shard."""
    mesh = jp.make_mesh((k,), axis_names=("space",), devices=devices[:k])
    spec = P(None, "space", None)
    out = np.asarray(jax.jit(shard_map(lambda x: fn(x, halo, "space"), mesh=mesh,
                                       in_specs=(spec,), out_specs=spec))(frames))
    return np.split(out, k, axis=1)


@pytest.mark.parametrize("halo", [1, 2, 4])
def test_exchange_halo_matches_jax(cpu8, halo):
    frames = _frames((2, 32, 24), 1)
    got = tp.exchange_halo(_shards(frames, 8), halo)
    for s, (a, b) in enumerate(zip(got, _jax_halo(jax_exchange_halo, frames, 8, halo, cpu8))):
        _eq(a, b, f"shard {s}")
    assert [tuple(x.shape) for x in got] == [(2, 4 + 2 * halo, 24)] * 8


@pytest.mark.parametrize("halo", [3, 4, 9, 20])
def test_bottom_halo_matches_jax_multi_hop(cpu8, halo):
    frames = _frames((2, 32, 24), 2)
    got = tp.bottom_halo(_shards(frames, 8), halo)
    for s, (a, b) in enumerate(zip(got, _jax_halo(jax_bottom_halo, frames, 8, halo, cpu8))):
        _eq(a, b, f"shard {s}")


def test_halo_edges_and_errors():
    shards = _shards(_frames((1, 12, 5), 3), 3)
    assert tp.exchange_halo(shards, 0) == shards
    one = tp.exchange_halo(shards[:1], 2)[0]
    assert (one[:, :2] == 0).all() and (one[:, -2:] == 0).all()
    with pytest.raises(ValueError):  # JAX builds a wrong shape here
        tp.exchange_halo(shards, 5)
    with pytest.raises(ValueError):
        tp.bottom_halo(shards, -1)


@pytest.mark.parametrize("radius", [1, 2, 3, 5])
def test_window_kernels_plain_vs_jax_interpret(radius):
    """K15 and K16's plain versions against the Pallas kernels in interpret
    mode, at the first, a middle and the last of 4 shards (W = 128, the JAX
    kernels' gate)."""
    ns, h_loc, w, r = 4, 16, 128, radius
    h = ns * h_loc
    frames = _frames((2, h, w), 10 + r)
    ext = tp.exchange_halo(_shards(frames, ns), r)
    blurred = K.blur_hist_plain(torch.from_numpy(frames), r, with_hist=False)[0].numpy()
    ext1 = tp.exchange_halo(_shards(blurred, ns), 1)
    t = torch.from_numpy(np.array([blurred[0].mean(), blurred[1].min() + 3], np.uint8))
    for s in (0, 2, ns - 1):
        got_b, got_h = K.blur_hist_window(ext[s], s * h_loc - r, r, h_total=h, row_lo=r,
                                          row_hi=r + h_loc)
        want_b, want_h = fused_blur_hist_window(ext[s].numpy(), s * h_loc - r, radius=r,
                                                h_total=h, row_lo=r, row_hi=r + h_loc,
                                                interpret=True)
        _eq(got_b[:, r:r + h_loc], np.asarray(want_b)[:, r:r + h_loc], f"shard {s} blurred")
        _eq(got_b[:, r:r + h_loc], blurred[:, s * h_loc:(s + 1) * h_loc], f"shard {s} vs frame")
        _eq(got_h, want_h, f"shard {s} histogram")
        got = K.threshold_sobel_window(ext1[s], t, s * h_loc - 1, h_total=h)
        want = fused_threshold_sobel_window(ext1[s].numpy(), t.numpy(), s * h_loc - 1,
                                            h_total=h, interpret=True)
        for name, a, b in zip(("binary", "edges"), got, want):
            _eq(a[:, 1:1 + h_loc], np.asarray(b)[:, 1:1 + h_loc], f"shard {s} {name}")
        lean = K.threshold_sobel_window(ext1[s], t, s * h_loc - 1, h_total=h, want_binary=False)
        assert lean[0] is None and torch.equal(lean[1], got[1])


def test_window_kernels_reject_bad_windows():
    x = torch.zeros((1, 10, 8), dtype=torch.uint8)
    for row0, lo, hi in ((-3, 0, 10), (14, 0, 10), (0, 4, 3), (0, 0, 11)):
        with pytest.raises(ValueError):  # a window with no frame row, or bad histogram rows
            K.blur_hist_window(x, row0, 2, h_total=20, row_lo=lo, row_hi=hi)
    with pytest.raises(ValueError):
        K.blur_hist_window(x, 0, 2, h_total=0, row_lo=0, row_hi=10)
    with pytest.raises(ValueError):
        K.threshold_sobel_window(x, torch.zeros(2, dtype=torch.uint8), 0, h_total=20)
    with pytest.raises(ValueError):
        K.threshold_sobel_window(x[:, ::2], torch.zeros(1, dtype=torch.uint8), 0, h_total=20)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (4, 2)])
def test_spatial_shardmap_matches_jax(cpu8, mesh_shape):
    n, h = 2 * mesh_shape[0], 32 * mesh_shape[1]
    imgs = _frames((n, h, 128), 20)
    jmesh = jp.make_mesh(mesh_shape, devices=cpu8)
    want = jp.preprocess_spatial_shardmap(imgs, jmesh, kernels=True, interpret=True)
    want_xla = jp.preprocess_spatial_shardmap(imgs, jmesh, kernels=False)
    mesh = _mesh(mesh_shape)
    got = tp.preprocess_spatial_shardmap(imgs, mesh)
    got_plain = tp.preprocess_spatial_shardmap(imgs, mesh, kernels=False)
    for name, a, b, c, d in zip(PREPROCESS_OUTPUTS, got, got_plain, want, want_xla):
        assert a.device == CPU and a.dtype == torch.uint8
        _eq(a, c, f"{name} vs Pallas body")
        _eq(a, d, f"{name} vs XLA body")
        assert torch.equal(a, b), name


@pytest.mark.parametrize("radius", [1, 5])
def test_spatial_shardmap_ragged_width(cpu8, radius):
    imgs = _frames((4, 64, 200), 21)
    want = jp.preprocess_spatial_shardmap(imgs, jp.make_mesh((2, 4), devices=cpu8), radius,
                                          kernels=False)
    ref = preprocess_reference(imgs, radius=radius)
    got = tp.preprocess_spatial_shardmap(imgs, _mesh((2, 4)), radius)
    for name, a, b, c in zip(PREPROCESS_OUTPUTS, got, want, ref):
        _eq(a, b, f"{name} r={radius} vs XLA body")
        _eq(a, c, f"{name} r={radius} vs preprocess_reference")


def test_preprocess_sharded_matches_jax(cpu8):
    imgs = _frames((8, 48, 80), 22)
    want = jp.preprocess_sharded(imgs, jp.make_mesh((4, 2), devices=cpu8))
    got = tp.preprocess_sharded(imgs, _mesh((4, 2)))
    for name, a, b in zip(PREPROCESS_OUTPUTS, got, want):
        _eq(a, b, name)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
def test_integral_sharded_matches_jax(cpu8, mesh_shape):
    imgs = _frames((2 * mesh_shape[0], 16 * mesh_shape[1], 48), 23)
    want = jp.integral_sharded(imgs, jp.make_mesh(mesh_shape, devices=cpu8))
    for kernels in (None, False):
        got = tp.integral_sharded(imgs, _mesh(mesh_shape), kernels=kernels)
        assert got.dtype == torch.uint32
        _eq(got, want, f"kernels={kernels}")


def test_integral_sharded_wraps():
    """An all-255 frame whose sums pass 2^32: the carries wrap as uint32."""
    imgs = np.full((1, 2048, 9000), 255, np.uint8)
    got = tp.integral_sharded(imgs, _mesh((1, 4)))
    assert int(got.view(torch.int32)[0, -1, -1]) % 2**32 == 255 * 2048 * 9000 % 2**32
    _eq(got, gs.integral(imgs))


def test_scan_sharded_matches_jax(cpu8):
    """``tests/test_parallel.py:194-212``'s batch: document.pgm at a quarter size."""
    doc = gt.io.read_pgm(os.path.join(REPO, "tests", "golden", "testdata", "document.pgm"))
    batch = np.stack([np.roll(doc[::4, ::4], 2 * i, axis=1) for i in range(4)])
    want = jp.scan_sharded(batch, jp.make_mesh((4, 2), devices=cpu8), out_size=(128, 96),
                           max_blobs=64)
    got = tp.scan_sharded(batch, _mesh((4, 2)), out_size=(128, 96), max_blobs=64)
    for name, a, b in zip(("pages", "corners"), got, want):
        _eq(a, b, name)


def test_mesh_and_shapes_raise():
    mesh = _mesh((2, 4))
    assert mesh.shape == {"data": 2, "space": 4} and mesh.devices.shape == (2, 4)
    assert tp.make_mesh(devices=[CPU] * 3).shape == {"data": 3, "space": 1}
    with pytest.raises(ValueError):
        tp.make_mesh((3, 1), devices=[CPU] * 2)
    with pytest.raises(ValueError):  # CPU and CUDA devices in one mesh
        tp.make_mesh((2,), ("data",), devices=[CPU, torch.device("cuda", 0)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # no fallback to CPU devices
            tp.make_mesh((1, 1))
    imgs = _frames((4, 32, 16), 24)
    with pytest.raises(ValueError):  # radius past the 8-row shards
        tp.preprocess_spatial_shardmap(imgs, _mesh((1, 4)), radius=9)
    with pytest.raises(ValueError):  # H % space
        tp.preprocess_spatial_shardmap(imgs, _mesh((1, 3)))
    with pytest.raises(ValueError):  # N % data
        tp.preprocess_spatial_shardmap(imgs, _mesh((3, 1)))
    with pytest.raises(ValueError):  # a mesh with no space axis
        tp.preprocess_spatial_shardmap(imgs, _mesh((2,), ("data",)))
    with pytest.raises(ValueError):
        tp.preprocess_sharded(imgs, _mesh((3, 1)))
    with pytest.raises(ValueError):
        tp.integral_sharded(imgs, _mesh((1, 3)))
    r8 = tp.preprocess_spatial_shardmap(imgs, _mesh((1, 4)), radius=8)
    for a, b in zip(r8, gt.preprocess(imgs, 8)):
        assert torch.equal(a, b)


def test_profiling_throughput_and_bandwidth(monkeypatch, tmp_path):
    batch = torch.zeros((4, 30, 50), dtype=torch.uint8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            profiling.throughput(gt.blur, batch)
        with pytest.raises(RuntimeError):  # the JAX version returns {} off the TPU
            profiling.hbm_bandwidth_gbps()
    monkeypatch.setattr(profiling, "timeit", lambda fn, *args, **kw: 0.25)
    out = profiling.throughput(gt.blur, batch, iters=3)
    assert out == {"sec_per_batch": 0.25, "frames_per_sec": 16.0,
                   "gpix_per_sec": 4 * 30 * 50 / 0.25 / 1e9}
    with profiling.trace(str(tmp_path / "tb")):
        gt.blur(batch, 1)
    assert os.path.getsize(tmp_path / "tb" / "trace.json") > 0


@pytest.mark.parametrize("shape", [(0,), (1,), (15,), (17,), (3, 5, 7), (2**20 + 3,)])
def test_copy_and_triad_plain_vs_numpy(shape):
    rng = np.random.default_rng(25)
    x, y = (rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(2))
    got = K.copy(torch.from_numpy(x))
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape
    _eq(got, x)
    _eq(K.triad(torch.from_numpy(x), torch.from_numpy(y)), x + y)  # numpy's uint8 add wraps
    with pytest.raises(ValueError):
        K.triad(torch.from_numpy(x), torch.zeros((1, *shape), dtype=torch.uint8))
    with pytest.raises(TypeError):
        K.copy(torch.from_numpy(x).to(torch.int32))


def test_package_and_chip_smoke_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|grayskull_tpu)(\s|\.|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "chip_sweep.py")]
    for root, _, names in os.walk(os.path.join(REPO, "grayskull_tpu_torch")):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    examples = os.path.join(REPO, "examples")
    files += [os.path.join(examples, f) for f in os.listdir(examples) if f.endswith("_torch.py")]
    bad = [f for f in files if pattern.search(open(f, encoding="utf-8").read())]
    assert len(files) > 30 and not bad, bad
    for module in (("parallel", "sparse.py"), ("native.py",), ("debug.py",),
                   ("kernels", "freestanding.py")):
        assert os.path.join(REPO, "grayskull_tpu_torch", *module) in files, module
    for demo in ("stream_demo_torch.py", "live_demo_torch.py"):
        assert os.path.join(examples, demo) in files, demo
