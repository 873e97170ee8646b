"""The port's ``freestanding`` trig mode (K21's plain versions on the CPU)
against ``grayskull_tpu``'s, bit for bit.

Both packages switch to the mode in a fixture and back to the fast mode
after.  ``tests/test_freestanding.py`` holds JAX's polynomials to an oracle
built from the reference's header; here the port is held to JAX's: the trig
itself over that file's input families (and the ORB moments' range, ``-0.0``
and the axes), then every ORB entry point that runs it.  Angles are compared
as uint32 bits.  Two inputs JAX never returns from (the sine of ``±inf`` and
of ``|x| >= 2^27``) give NaN here, as does every ``|x| >= 2^20``: those are
checked on the port alone.  A NaN result is the quiet NaN ``0x7fc00000``, so a
NaN is compared as a NaN, not by its payload.
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
from grayskull_tpu import parallel as jp
from grayskull_tpu.ops import features as jax_features
from grayskull_tpu.parallel import sparse as js
from grayskull_tpu_torch import kernels as K
from grayskull_tpu_torch import libm32
from grayskull_tpu_torch import parallel as tp
from grayskull_tpu_torch.kernels import freestanding as F
from tests.test_torch_cuda import host_arrays_on_cpu  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "tests", "golden", "testdata")
ORB_MOMENT = 255 * 709 * 15  # |m01|, |m10| < 255 * (disc pixels) * radius


@pytest.fixture()
def freestanding():
    """Both packages in the freestanding mode; both back in the fast mode after."""
    jax_libm32.use_freestanding(True)
    libm32.use_freestanding(True)
    yield
    jax_libm32.use_freestanding(False)
    libm32.use_freestanding(False)
    assert libm32.trig_mode() == "fast" and jax_libm32.trig_mode() == "fast"


def _image(name):
    return gt.io.read_pgm(os.path.join(TESTDATA, f"{name}.pgm"))


def _bits(v) -> np.ndarray:
    v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return v.view(np.uint32) if v.dtype == np.float32 else v


def _same_floats(got, ref, msg=""):
    """Equal float32 bits; a NaN equals a NaN whatever its payload."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == np.float32 and got.shape == ref.shape, msg
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=f"{msg}: NaN positions")
    np.testing.assert_array_equal(got[~nan].view(np.uint32), ref[~nan].view(np.uint32),
                                  err_msg=msg)


def _same_table(port, ref, msg=""):
    for name, a, b in zip(ref._fields, port, ref):
        a, b = _bits(a), _bits(b)
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f"{msg} {name}")


def atan2_inputs(rng):
    """(y, x): ``tests/test_freestanding.py``'s families, the ORB moments' range,
    and the axes and signed zeros."""
    ys = np.concatenate([
        rng.uniform(-1e6, 1e6, 2000), rng.integers(-5000, 5000, 2000),
        rng.integers(-ORB_MOMENT, ORB_MOMENT, 2000), rng.uniform(-1e-3, 1e-3, 500),
        [0.0, 1.0, -1.0, 0.0, 0.0, -0.0, 0.0, -0.0, 3.0, -3.0, 7.0, -7.0, 0.0]])
    xs = np.concatenate([
        rng.uniform(-1e6, 1e6, 2000), rng.integers(-5000, 5000, 2000),
        rng.integers(-ORB_MOMENT, ORB_MOMENT, 2000), rng.uniform(-1e-3, 1e-3, 500),
        [0.0, 0.0, 0.0, 5.0, -3.0, 0.0, -0.0, -0.0, -0.0, 0.0, 7.0, -7.0, 2.5]])
    return ys.astype(np.float32), xs.astype(np.float32)


def sin_inputs(rng):
    """``tests/test_freestanding.py``'s families (both reduction loops), ORB's
    angles and the reference cosine's shifted range, and the edges of the
    octant and the loops."""
    return np.concatenate([
        rng.uniform(-3.15, 3.15, 2000), rng.uniform(-30.0, 30.0, 2000),
        rng.uniform(-np.pi, np.pi + 1.58, 2000), rng.uniform(-1000.0, 1000.0, 200),
        [0.0, -0.0, 3.141592, -3.141592, 1.570796, -1.570796, 4.0, -4.0, 10.5,
         np.float32(np.pi), -np.float32(np.pi), 6.283185, -6.283185, 1e-30, -1e-30]],
    ).astype(np.float32)


def moment_pairs(rng, n=6000):
    """int32 (m01, m10): every pair of int32's ends, 0, +-1 and odd values past
    2^24 (where the cast to float32 rounds), a small m01 against a large
    negative m10 (angles near +-pi), ORB's moment range and uniform int32s."""
    edge = np.array([0, 1, -1, 2, -2, -2**31, 2**31 - 1, -2**31 + 1, 2**24 + 1, -(2**24 + 1),
                     2**25 + 3, 2**30 + 7], np.int64)
    ey, ex = (v.ravel() for v in np.meshgrid(edge, edge))
    k = (n - ey.size) // 3
    near_pi = (rng.integers(-3, 4, k), -rng.integers(1, 2**31, k))
    orb = rng.integers(-ORB_MOMENT, ORB_MOMENT, (2, k))
    uniform = rng.integers(-2**31, 2**31, (2, n - ey.size - 2 * k))
    m01 = np.concatenate([ey, near_pi[0], orb[0], uniform[0]]).astype(np.int32)
    m10 = np.concatenate([ex, near_pi[1], orb[1], uniform[1]]).astype(np.int32)
    return m01, m10


def test_fs_orient_vs_jax():
    """K21's orientation entry (its plain version on the CPU) against JAX's
    ``_freestanding_atan2`` of the moments cast to float32, then
    ``_freestanding_sin`` of the angle and of the angle plus 1.57079, bit for
    bit, tolerance 0; the moments past 2^24 round in the cast on both sides."""
    m01, m10 = moment_pairs(np.random.default_rng(25))
    assert (np.abs(m01.astype(np.int64)) > 2**24).sum() > 1000
    assert (m01.astype(np.float32).astype(np.int64) != m01).sum() > 1000  # the cast rounds
    got = F.fs_orient(torch.from_numpy(m01), torch.from_numpy(m10))
    plain = F.fs_orient_plain(torch.from_numpy(m01), torch.from_numpy(m10))
    angle = jax_libm32._freestanding_atan2(jnp.asarray(m01.astype(np.float32)),
                                           jnp.asarray(m10.astype(np.float32)))
    ref = (angle, jax_libm32._freestanding_sin(angle),
           jax_libm32._freestanding_sin(angle + np.float32(1.57079)))
    for name, a, b, r in zip(("angle", "sin", "cos"), got, plain, ref):
        assert a.shape == m01.shape and not torch.isnan(a).any(), name
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
        _same_floats(a, r, name)
    assert (np.abs(got[0].numpy()) > 3.14).sum() > 100  # angles near +-pi
    # cosine inputs past pi: its range reduction steps once
    assert (got[0].numpy() + np.float32(1.57079) > np.float32(3.141592)).sum() > 1000


@pytest.mark.parametrize("mode", ["fast", "exact_host", "freestanding"])
@pytest.mark.parametrize("force_reference", [False, True])
def test_orientation_trig_is_the_composition(mode, force_reference):
    """``orientation_trig`` gives in each mode exactly what ``atan2f`` of the
    float32 moments, ``sinf`` and ``cosf_like_reference`` give."""
    m01, m10 = (torch.from_numpy(v) for v in moment_pairs(np.random.default_rng(26), 1500))
    m01, m10 = m01.view(3, 500), m10.view(3, 500)
    {"fast": libm32.use_freestanding, "exact_host": libm32.use_exact_host_libm,
     "freestanding": libm32.use_freestanding}[mode](mode != "fast")
    try:
        assert libm32.trig_mode() == mode
        got = libm32.orientation_trig(m01, m10, force_reference)
        angle = libm32.atan2f(m01.to(torch.float32), m10.to(torch.float32), force_reference)
        want = (angle, libm32.sinf(angle, force_reference),
                libm32.cosf_like_reference(angle, force_reference))
    finally:
        libm32.use_freestanding(False)
    for a, b in zip(got, want):
        assert a.shape == (3, 500) and torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_fs_orient_refuses_what_the_kernel_would_not_take():
    m01, m10 = (torch.from_numpy(v) for v in moment_pairs(np.random.default_rng(27), 400))
    K.reset_launch_counts()
    assert all(t.shape == (0,) and t.dtype == torch.float32
               for t in F.fs_orient(m01[:0], m10[:0]))
    assert K.launch_counts()["freestanding"] == 0
    with pytest.raises(TypeError):
        F.fs_orient(m01.to(torch.float32), m10.to(torch.float32))
    with pytest.raises(TypeError):
        F.fs_orient(m01.to(torch.int64), m10)
    with pytest.raises(TypeError):
        F.fs_orient(m01.numpy(), m10)
    with pytest.raises(ValueError):
        F.fs_orient(m01[:-1], m10)
    with pytest.raises(ValueError):
        F.fs_orient(m01.view(20, 20).t(), m10.view(20, 20).t())


@pytest.mark.parametrize("fn", ["atan2f", "sinf", "cosf_like_reference"])
def test_trig_vs_jax(freestanding, fn):
    rng = np.random.default_rng(21)
    if fn == "atan2f":
        ys, xs = atan2_inputs(rng)
        got = libm32.atan2f(torch.from_numpy(ys), torch.from_numpy(xs))
        ref = jax_libm32.atan2f(ys, xs)
    else:
        a = sin_inputs(rng)
        got = getattr(libm32, fn)(torch.from_numpy(a))
        ref = getattr(jax_libm32, fn)(a)
    _same_floats(got, ref, fn)
    assert not np.isnan(np.asarray(ref)).any()


def test_plain_polynomials_vs_jax():
    """The plain functions themselves, outside any mode, against JAX's private
    ``_freestanding_atan2`` and ``_freestanding_sin`` (the port keeps the names)."""
    rng = np.random.default_rng(22)
    ys, xs = atan2_inputs(rng)
    _same_floats(libm32._freestanding_atan2(torch.from_numpy(ys), torch.from_numpy(xs)),
                 jax_libm32._freestanding_atan2(jnp.asarray(ys), jnp.asarray(xs)), "atan2")
    a = sin_inputs(rng)
    _same_floats(libm32._freestanding_sin(torch.from_numpy(a)),
                 jax_libm32._freestanding_sin(jnp.asarray(a)), "sin")
    _same_floats(F.fs_sin_plain(torch.from_numpy(a), 1.57079),
                 jax_libm32._freestanding_sin(jnp.asarray(a) + np.float32(1.57079)), "offset")


def test_mode_switches(freestanding):
    assert libm32.trig_mode() == "freestanding" and libm32.exact_mode()
    assert jax_libm32.trig_mode() == "freestanding"
    libm32.use_exact_host_libm(True)
    assert libm32.trig_mode() == "exact_host" and libm32.exact_mode()
    libm32.use_freestanding(True)
    assert libm32.trig_mode() == "freestanding"
    # scalars and broadcasting, as in the other modes
    assert float(libm32.atan2f(1.0, 1.0)) == float(jax_libm32.atan2f(1.0, 1.0))
    got = libm32.atan2f(torch.tensor([[1.0], [-2.0]]), torch.tensor([3.0, -4.0, 0.0]))
    _same_floats(got, jax_libm32.atan2f(np.array([[1.0], [-2.0]], np.float32),
                                        np.array([3.0, -4.0, 0.0], np.float32)))


def test_freestanding_changes_the_angles():
    """The mode is not the fast mode under another name: on lena most angles,
    and so most descriptors, differ."""
    lena = _image("lena")
    fast = gt.orb_extract(lena, 100, 20)
    libm32.use_freestanding(True)
    try:
        free = gt.orb_extract(lena, 100, 20)
    finally:
        libm32.use_freestanding(False)
    n = int(free.n)
    assert n == int(fast.n) > 50
    assert (_bits(free.angle)[:n] != _bits(fast.angle)[:n]).sum() > 0.9 * n
    assert (_bits(free.descriptor)[:n] != _bits(fast.descriptor)[:n]).any(axis=1).sum() > n // 2


@pytest.mark.parametrize("x", [np.inf, -np.inf, np.nan, 2.0**27, -(2.0**27), 2.0**20,
                               -(2.0**20), 3.4e38])
def test_sine_loop_end_gives_nan(freestanding, x):
    """Past the bound C's loop never ends (or runs up to 2^24 steps): NaN, at
    once.  JAX hangs on most of these, so it is not called."""
    a = torch.tensor([x, 0.5, x], dtype=torch.float32)
    for got in (libm32.sinf(a), F.fs_sin_plain(a), F.fs_sin(a)):
        assert np.isnan(got[0].item()) and np.isnan(got[2].item())
        assert got[1].item() == float(jax_libm32._freestanding_sin(jnp.float32(0.5)))
        assert _bits(got)[0] == 0x7FC00000  # the canonical quiet NaN
    if abs(x) != 2.0**20:  # the cosine's add brings -2^20 back inside the bound
        cos = libm32.cosf_like_reference(a)
        assert np.isnan(cos[0].item()) and not np.isnan(cos[1].item())


def test_sine_just_inside_the_bound_runs_cs_loops():
    """Every |x| < 2^20 runs C's loops: the largest float32 below the bound
    takes about 166,886 steps of the first loop, and equals JAX (the second
    loop at 2^18 + 0.25, about 41,700 steps)."""
    a = np.array([np.nextafter(np.float32(2.0**20), np.float32(0)), -(2.0**18 + 0.25), 65536.5,
                  -1000.25], np.float32)
    _same_floats(F.fs_sin_plain(torch.from_numpy(a)),
                 jax_libm32._freestanding_sin(jnp.asarray(a)), "near the bound")


def test_atan2_nan_and_inf_inputs_give_canonical_nan():
    """C's ``0.785398f - 0.785398f*r`` is NaN for a NaN ratio, and so is the
    port's.  JAX's emulated subtraction (``exactf32.f32_sub``) gives ``±inf``
    there instead; ORB's moments are finite integers and never reach it."""
    y = torch.tensor([np.nan, 1.0, np.inf, np.inf, 2.0, -np.inf], dtype=torch.float32)
    x = torch.tensor([1.0, np.nan, 1.0, np.inf, np.inf, -5.0], dtype=torch.float32)
    got = F.fs_atan2_plain(y, x)
    assert (_bits(got) == 0x7FC00000).all()
    ref = np.asarray(jax_libm32._freestanding_atan2(jnp.asarray(y.numpy()), jnp.asarray(x.numpy())))
    assert not np.isfinite(ref).any()


def test_k21_wrappers_on_the_cpu():
    """K21's wrappers run the plain versions for CPU tensors, launch nothing and
    refuse what the kernel would not take."""
    rng = np.random.default_rng(23)
    ys, xs = atan2_inputs(rng)
    K.reset_launch_counts()
    y, x = torch.from_numpy(ys), torch.from_numpy(xs)
    assert torch.equal(F.fs_atan2(y, x).view(torch.int32),
                       F.fs_atan2_plain(y, x).view(torch.int32))
    a = torch.from_numpy(sin_inputs(rng))
    for offset in (None, 1.57079, -2.5):
        assert torch.equal(F.fs_sin(a, offset).view(torch.int32),
                           F.fs_sin_plain(a, offset).view(torch.int32))
    assert F.fs_sin(torch.empty(0)).shape == (0,)
    assert K.launch_counts()["freestanding"] == 0
    with pytest.raises(TypeError):
        F.fs_sin(a.to(torch.float64))
    with pytest.raises(TypeError):
        F.fs_atan2(y.numpy(), x)
    with pytest.raises(ValueError):
        F.fs_sin(a.view(-1, 1).expand(-1, 2))
    with pytest.raises(ValueError):
        F.fs_atan2(y[:-1], x)


def test_force_reference_keeps_the_trig_plain(freestanding, monkeypatch):
    """``force_reference=True`` must run the plain polynomials, not K21, or the
    card's check would hold K21 to itself: with K21's wrappers made to raise,
    the plain path still runs and the default path does not."""
    lena = _image("lena")
    ref = gt.orb_extract(lena, 60, 20)

    def refuse(*_):
        raise AssertionError("K21 called")

    monkeypatch.setattr(libm32, "fs_orient", refuse)
    monkeypatch.setattr(libm32, "fs_atan2", refuse)
    monkeypatch.setattr(libm32, "fs_sin", refuse)
    _same_table(gt.orb_extract(lena, 60, 20, force_reference=True), ref, "plain path")
    mesh = tp.make_mesh((1, 4), devices=["cpu"] * 4)
    aruco = _image("aruco")
    tp.orb_extract_spatial(aruco, mesh, 40, 20, kernels=False)
    with pytest.raises(AssertionError, match="K21 called"):
        gt.orb_extract(lena, 60, 20)
    with pytest.raises(AssertionError, match="K21 called"):
        tp.orb_extract_spatial(aruco, mesh, 40, 20)


# --- the ORB entry points -------------------------------------------------------


def test_compute_orientation_and_brief_vs_jax(freestanding):
    lena = _image("lena")
    rng = np.random.default_rng(24)
    xs = rng.integers(15, lena.shape[1] - 15, 100)
    ys = rng.integers(15, lena.shape[0] - 15, 100)
    angle = gt.compute_orientation(lena, xs, ys, 15)
    ref = jax_features.compute_orientation(jnp.asarray(lena), xs, ys, 15)
    _same_floats(angle, ref, "orientation")
    assert float(gt.compute_orientation(lena, 40, 50)) == float(
        jax_features.compute_orientation(jnp.asarray(lena), 40, 50))
    angles = np.concatenate([angle.numpy(), rng.uniform(-np.pi, np.pi, 100)
                             .astype(np.float32)])
    px, py = np.concatenate([xs, xs]), np.concatenate([ys, ys])
    got = gt.brief_descriptor(lena, px, py, angles)
    want = jax_features.brief_descriptor(jnp.asarray(lena), px, py, angles)
    np.testing.assert_array_equal(_bits(got), np.asarray(want))
    np.testing.assert_array_equal(
        _bits(gt.brief_descriptor(lena, 40, 50, angles[0])),
        np.asarray(jax_features.brief_descriptor(jnp.asarray(lena), 40, 50, angles[0])))


def test_orb_extract_vs_jax(freestanding):
    lena = _image("lena")
    frames = np.stack([lena, np.roll(lena, 9, axis=1)])
    got = gt.orb_extract(frames, 100, 20)
    ref = gs.orb_extract(jnp.asarray(frames), 100, 20)
    assert min(got.n.tolist()) > 50
    _same_table(got, ref, "batch")
    _same_table(gt.orb_extract(lena, 100, 20), gs.orb_extract(jnp.asarray(lena), 100, 20),
                "one frame")


def test_track_vs_jax(freestanding):
    aruco = _image("aruco")
    tmpl = aruco[100:350, 150:450].copy()
    got = gt.track(tmpl, aruco, max_kps=300)
    ref = gs.pipelines.track(tmpl, aruco, max_kps=300)
    assert int(got[2].n) > 0
    for what, a, b in zip(("template", "scene", "matches"), got, ref):
        _same_table(a, b, what)


def test_orb_extract_spatial_vs_jax(freestanding):
    devs = jax.devices("cpu")
    if len(devs) < 4:
        pytest.skip("needs 4 virtual CPU devices")
    aruco = _image("aruco")  # 480x640: 4 shards of 120 rows
    ref = js.orb_extract_spatial(jnp.asarray(aruco), jp.make_mesh((1, 4), devices=devs[:4]),
                                 300, 20)
    mesh = tp.make_mesh((1, 4), devices=["cpu"] * 4)
    got = tp.orb_extract_spatial(aruco, mesh, 300, 20)
    assert int(got.n) > 50
    _same_table(got, ref, "sharded")
    _same_table(tp.orb_extract_spatial(aruco, mesh, 300, 20, kernels=False), ref, "plain")
    kps = gt.orb_extract(aruco, 300, 20)
    _same_table(got, kps, "vs orb_extract")
    _same_table(tp.match_orb_sharded(kps, got, mesh, 100, 60.0),
                gs.match_orb(gs.orb_extract(jnp.asarray(aruco), 300, 20), ref, 100, 60.0),
                "match_orb_sharded")
