"""The port's ``debug`` module and its stream and live demos against
``grayskull_tpu.debug`` and ``examples/stream_demo.py`` / ``examples/live_demo.py``,
on the CPU.

``dump`` writes the same PGM bytes (files are compared, not names: each
module numbers its own dumps); the overlays are the same arrays; ``nan_guard``
raises where JAX's ``jax_debug_nans`` raises.  The stream demo's non-timing
function writes the frames and the overlay that the JAX script writes; the
live demo answers every endpoint with the JAX demo's status and JSON body,
each behind its own in-process server.  The demos' entry points run on the
card, and without one they fail naming the CUDA device.
"""

import base64
import http.client
import json
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grayskull_tpu as gs
import grayskull_tpu_torch as gt
from grayskull_tpu import debug as jax_debug
from grayskull_tpu.core import Keypoints as JaxKeypoints
from grayskull_tpu.core import Rects as JaxRects
from grayskull_tpu_torch import debug
from tests.test_torch_cuda import host_arrays_on_cpu  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
if EXAMPLES not in sys.path:
    sys.path.insert(0, EXAMPLES)

import live_demo  # noqa: E402
import live_demo_torch  # noqa: E402
import stream_demo_torch  # noqa: E402

STREAM_SPEC = "blur:1,threshold:otsu,blobs,keypoints,contours"


def _read(paths):
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(f.read())
    return out


# --- debug -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["uint8", "float64", "float32", "batch", "flat_float",
                                  "negative_float32"])
def test_dump_bytes_vs_jax(tmp_path, kind):
    rng = np.random.default_rng(31)
    img = rng.integers(0, 256, (8, 12), dtype=np.uint8)
    arr = {"uint8": img,
           "float64": np.linspace(0, 1, 96).reshape(8, 12),
           "float32": rng.normal(3.0, 2.0, (8, 12)).astype(np.float32),
           "batch": np.stack([img, img[::-1], 255 - img]),
           "flat_float": np.full((5, 7), 2.5, np.float32),
           "negative_float32": -rng.random((2, 6, 9)).astype(np.float32)}[kind]
    ours = debug.dump(torch.from_numpy(arr), kind, directory=str(tmp_path / "port"))
    theirs = jax_debug.dump(jnp.asarray(arr) if arr.dtype != np.float64 else arr, kind,
                            directory=str(tmp_path / "jax"))
    assert len(ours) == len(theirs) == (1 if arr.ndim == 2 else arr.shape[0])
    assert _read(ours) == _read(theirs)
    for p in ours:
        name = os.path.basename(p)
        assert name.startswith(f"{kind}_") and name.endswith(".pgm") and len(name) == len(kind) + 9
    # a numpy array gives the same files as the tensor
    assert _read(debug.dump(arr, kind, directory=str(tmp_path / "np"))) == _read(ours)


def test_dump_numbers_its_files(tmp_path):
    img = np.zeros((4, 4), np.uint8)
    first = debug.dump(img, "n", directory=str(tmp_path))[0]
    second = debug.dump(img, "n", directory=str(tmp_path))[0]
    idx = [int(os.path.basename(p)[2:6]) for p in (first, second)]
    assert idx[1] == idx[0] + 1
    assert debug.DUMP_DIR.endswith("grayskull_dumps")


def _rect_tables(rows, n):
    cols = [np.array(c, np.int32) for c in zip(*rows)]
    port = gt.Rects(torch.tensor(n, dtype=torch.int32), *(torch.from_numpy(c) for c in cols))
    jax_table = JaxRects(jnp.int32(n), *(jnp.asarray(c) for c in cols))
    return port, jax_table


def test_draw_rects_vs_jax():
    rng = np.random.default_rng(32)
    img = rng.integers(0, 256, (40, 50), dtype=np.uint8)
    rows = [(2, 3, 10, 8), (30, 20, 40, 40), (-5, -2, 8, 6), (0, 0, 49, 39), (45, 35, 0, 0),
            (7, 7, 3, 3)]
    for color in (200, 255, 0):
        got = debug.draw_rects(img, rows, color=color)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, jax_debug.draw_rects(img, rows, color=color))
    port, jax_table = _rect_tables(rows, 4)  # the last two rows lie past n
    got = debug.draw_rects(torch.from_numpy(img), port)
    np.testing.assert_array_equal(got, jax_debug.draw_rects(img, jax_table))
    assert img.max() > 0 and not np.array_equal(got, img)


def test_draw_crosses_vs_jax():
    rng = np.random.default_rng(33)
    img = rng.integers(0, 200, (40, 50), dtype=np.uint8)
    pts = [(0, 0), (49, 39), (1, 38), (25, 20), (-1, 5), (51, 10), (10, -2)]
    for r in (0, 2, 5):
        np.testing.assert_array_equal(debug.draw_crosses(img, pts, 255, r),
                                      jax_debug.draw_crosses(img, pts, 255, r))
    frame = gt.io.read_pgm(os.path.join(REPO, "tests", "golden", "testdata", "lena.pgm"))
    kps, _ = gt.fast(frame, 60, 20)
    ref, _ = gs.fast(jnp.asarray(frame), 60, 20)
    assert isinstance(ref, JaxKeypoints) and int(kps.n) == int(ref.n) > 10
    np.testing.assert_array_equal(debug.draw_crosses(frame, kps, 128),
                                  jax_debug.draw_crosses(frame, ref, 128))


def test_nan_guard_raises_where_jax_raises():
    with jax_debug.nan_guard(), pytest.raises(FloatingPointError):
        jnp.zeros(3) / jnp.zeros(3)
    with debug.nan_guard(), pytest.raises(FloatingPointError):
        torch.zeros(3) / torch.zeros(3)
    with jax_debug.nan_guard():
        jax_inf = jnp.ones(3) / jnp.zeros(3)
    with debug.nan_guard():
        inf = torch.ones(3) / torch.zeros(3)
        torch.empty(4096)  # uninitialised memory is no op's NaN
        torch.empty_like(inf)
        inf.new_empty(17)
        torch.empty_strided((4, 4), (1, 4))
        ints = torch.tensor([0, 1]) // torch.tensor([1, 1])
    np.testing.assert_array_equal(inf.numpy(), np.asarray(jax_inf))
    assert ints.tolist() == [0, 1]


def test_nan_guard_restores_and_nests():
    outer_nan = torch.zeros(2) / torch.zeros(2)  # no guard: no raise
    assert torch.isnan(outer_nan).all()
    with debug.nan_guard():
        with debug.nan_guard():
            with pytest.raises(FloatingPointError):
                torch.log(torch.tensor([-1.0]))
        with pytest.raises(FloatingPointError):  # the outer guard is still on
            torch.tensor([0.0]).div_(0.0)
    torch.tensor([-1.0]).sqrt()  # and off again
    with pytest.raises(FloatingPointError):
        with debug.nan_guard():
            torch.tensor([np.inf]) - torch.tensor([np.inf])
    torch.tensor([np.inf]) - torch.tensor([np.inf])


# --- the stream demo ---------------------------------------------------------


def test_stream_demo_matches_jax(tmp_path, capsys):
    """The JAX script with ``--out`` (a subprocess, as ``tests/test_aux.py``
    runs it) and the port's :func:`process_stream` on the same frames: every
    written PGM byte for byte, and the analyzers' lines."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "examples/stream_demo.py", "--pipeline", STREAM_SPEC, "--frames", "2",
         "--size", "96x128", "--out", str(tmp_path / "jax")],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-500:]
    frames = torch.from_numpy(stream_demo_torch.synth_frames(2, 96, 128))
    processed, overlaid = stream_demo_torch.process_stream(frames, STREAM_SPEC,
                                                           str(tmp_path / "port"))
    printed = capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["frame_0000.pgm", "frame_0001.pgm", "overlay.pgm"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    theirs = [ln.replace(str(tmp_path / "jax"), "OUT") for ln in proc.stdout.splitlines()[1:]]
    ours = [ln.replace(str(tmp_path / "port"), "OUT") for ln in printed.splitlines()]
    assert ours == theirs and any(ln.startswith("  contours:") for ln in ours)
    assert processed.shape == (2, 96, 128) and overlaid.dtype == np.uint8


def test_stream_demo_pipelines_vs_jax():
    """Every dense op of the spec language, and faces, on one frame each."""
    import stream_demo

    frames = stream_demo_torch.synth_frames(2, 64, 80, seed=3)
    spec = "adaptive:5:3,dilate,erode,sobel,sharpen,emboss,threshold:90,blur:2"
    ours, _ = stream_demo_torch.build_pipeline(spec)
    theirs, _ = stream_demo.build_pipeline(spec)
    np.testing.assert_array_equal(ours(torch.from_numpy(frames)).numpy(),
                                  np.asarray(theirs(jnp.asarray(frames))))
    _, overlaid = stream_demo_torch.process_stream(torch.from_numpy(frames), "blur:1,faces:1")
    assert overlaid.shape == (64, 80)
    with pytest.raises(SystemExit, match="unknown pipeline op: nosuch"):
        stream_demo_torch.build_pipeline("blur:1,nosuch")


def test_stream_demo_main_needs_the_card(tmp_path):
    """The script runs on the CUDA device; with none it fails and says so."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the demo would run on it")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "examples/stream_demo_torch.py", "--frames", "2", "--size", "32x48",
         "--out", str(tmp_path / "out")],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode != 0 and "CUDA device" in proc.stderr
    assert not (tmp_path / "out").exists()


# --- the live demo -----------------------------------------------------------


class _Server:
    def __init__(self, module, demo):
        self.srv = module.ThreadingHTTPServer(("127.0.0.1", 0), module.make_handler(demo))
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()
        self.conn = http.client.HTTPConnection("127.0.0.1", self.srv.server_address[1],
                                               timeout=120)

    def ask(self, method, path, body=None):
        self.conn.request(method, path, body)
        resp = self.conn.getresponse()
        data = resp.read()
        return resp.status, data

    def close(self):
        self.conn.close()
        self.srv.shutdown()
        self.srv.server_close()


def test_live_demo_endpoints_vs_jax():
    """``tests/test_aux.py``'s drive of the JAX demo, and more, on both servers:
    the page, GET ``/frame`` with every analyzer, the 400s, POST, ``capture=1``
    and then ``orb`` against the captured template."""
    frames = stream_demo_torch.synth_frames(4, 64, 96)
    assert np.array_equal(frames, live_demo.synth_frames(4, 64, 96))
    ours = _Server(live_demo_torch, live_demo_torch.Demo(frames, device="cpu"))
    theirs = _Server(live_demo, live_demo.Demo(frames))
    body = np.asarray(frames[2]).tobytes()
    requests = [
        ("GET", "/", None),
        ("GET", "/frame?i=1&pipeline=blur:1,threshold:otsu&analyzers=blobs,keypoints", None),
        ("GET", "/frame?i=5&pipeline=blur:1,threshold:otsu,contours"
                "&analyzers=blobs,keypoints,faces,orb", None),
        ("GET", "/frame?i=0&pipeline=&analyzers=", None),
        ("GET", "/frame?i=0&pipeline=nosuchop&analyzers=", None),
        ("GET", "/nowhere", None),
        ("POST", "/frame?pipeline=blur:1&analyzers=keypoints", body),
        ("POST", "/frame?pipeline=sobel&analyzers=contours,faces", body),
        ("POST", "/frame?capture=1", body),
        ("POST", "/frame?pipeline=blur:1&analyzers=orb", body),
        ("POST", "/frame?capture=1", np.asarray(frames[3]).tobytes()),
        ("POST", "/frame?pipeline=adaptive:5:5,erode&analyzers=orb", body),
        ("POST", "/frame?pipeline=blur:1", body[:100]),
        ("POST", "/frame?pipeline=blur:1,bogus", body),
        ("POST", "/elsewhere", body),
    ]
    try:
        for method, path, data in requests:
            got, want = ours.ask(method, path, data), theirs.ask(method, path, data)
            assert got[0] == want[0], (method, path)
            if got[1][:1] == b"{":
                d = json.loads(got[1])
                assert d == json.loads(want[1]), (method, path)
            else:
                assert got[1] == want[1], (method, path)
        status, page = ours.ask("GET", "/")
        assert status == 200 and b"getUserMedia" in page and b"CW = 96" in page
        d = json.loads(ours.ask("GET", "/frame?i=2&pipeline=blur:1&analyzers=orb")[1])
        assert len(base64.b64decode(d["pixels"])) == 64 * 96 and len(d["matches"]) > 0
    finally:
        ours.close()
        theirs.close()


def test_live_demo_wants_a_device():
    frames = stream_demo_torch.synth_frames(2, 32, 48)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            live_demo_torch.Demo(frames)
    demo = live_demo_torch.Demo(frames, device="cpu")
    # outside host_arrays_to, as a handler thread is: the work stays on the Demo's device
    out = threading.Thread(target=lambda: results.append(demo.frame(0, "blur:1", ["faces"])))
    results = []
    out.start()
    out.join()
    assert results and results[0]["w"] == 48
