"""ctypes bindings for the native PGM loader (``csrc/gsio.c``), with
``grayskull_tpu.native``'s functions and behaviour.

The C source is shared with the JAX package by path.  The port builds its own
library with the system C compiler (``cc``) the first time it is needed, into
``grayskull_tpu_torch/_build/`` under a name keyed by a hash of the source and
flags, written to a temporary file and moved into place with
:func:`os.replace`.  It never loads a library that the JAX package built.

Everything degrades as in the JAX package: :func:`available` is False when
there is no compiler or library, and :func:`grayskull_tpu_torch.io.read_pgm_batch`
then reads through the Python codec.  This is host I/O: nothing here touches
the card.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

__all__ = ["available", "library_path", "probe_pgm", "read_pgm", "read_pgm_batch", "write_pgm"]

_PACKAGE_DIR = pathlib.Path(__file__).resolve().parent
SOURCE = _PACKAGE_DIR.parent / "csrc" / "gsio.c"
BUILD_DIR = _PACKAGE_DIR / "_build"
CFLAGS = ("-O2", "-std=c11", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: Optional[ct.CDLL] = None
_path: Optional[pathlib.Path] = None
_tried = False

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u32 = ct.c_uint32


def _bind(lib: ct.CDLL) -> ct.CDLL:
    lib.gsio_probe_pgm_file.argtypes = [ct.c_char_p, ct.POINTER(_u32), ct.POINTER(_u32)]
    lib.gsio_probe_pgm_file.restype = ct.c_int
    lib.gsio_read_pgm.argtypes = [ct.c_char_p, ct.POINTER(_u32), ct.POINTER(_u32), _u8p,
                                  ct.c_size_t]
    lib.gsio_read_pgm.restype = ct.c_int
    lib.gsio_write_pgm.argtypes = [ct.c_char_p, _u8p, _u32, _u32]
    lib.gsio_write_pgm.restype = ct.c_int
    lib.gsio_read_batch.argtypes = [ct.POINTER(ct.c_char_p), ct.c_int, _u32, _u32, _u8p,
                                    _i32p, ct.c_int]
    lib.gsio_read_batch.restype = ct.c_int
    return lib


def _build(src: pathlib.Path) -> pathlib.Path:
    """Compile ``src`` unless a library built from it exists; return its path."""
    digest = hashlib.sha256(" ".join(CFLAGS).encode() + src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libgsio_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["cc", *CFLAGS, "-o", tmp, str(src), "-lpthread"], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load() -> Optional[ct.CDLL]:
    global _lib, _path, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                path = _build(SOURCE)
                _lib, _path = _bind(ct.CDLL(str(path))), path
            except (OSError, subprocess.CalledProcessError):
                _lib = None  # no source, no compiler, or a failed build or load
        return _lib


def available() -> bool:
    """True when the native library is built and loaded."""
    return _load() is not None


def library_path() -> Optional[str]:
    """The loaded library's path, or None when :func:`available` is False."""
    return str(_path) if _load() is not None else None


def probe_pgm(path: str):
    """(w, h) of a PGM file without reading the payload, or None."""
    lib = _load()
    if lib is None:
        return None
    w, h = _u32(), _u32()
    if lib.gsio_probe_pgm_file(path.encode(), ct.byref(w), ct.byref(h)) != 0:
        return None
    return int(w.value), int(h.value)


def read_pgm(path: str) -> Optional[np.ndarray]:
    """One PGM file as (H, W) uint8, or None if it cannot be read."""
    lib = _load()
    if lib is None:
        return None
    dims = probe_pgm(path)
    if dims is None:
        return None
    w, h = dims
    out = np.empty((h, w), np.uint8)
    ww, hh = _u32(), _u32()
    if lib.gsio_read_pgm(path.encode(), ct.byref(ww), ct.byref(hh), out, out.size) != 0:
        return None
    return out


def write_pgm(img: np.ndarray, path: str) -> int:
    """Write (H, W) uint8 as a P5 PGM; 0 on success, -1 on error."""
    lib = _load()
    if lib is None:
        return -1
    img = np.ascontiguousarray(img, np.uint8)
    return int(lib.gsio_write_pgm(path.encode(), img, img.shape[1], img.shape[0]))


def read_pgm_batch(paths, pad_to=None, threads: int = 8) -> np.ndarray:
    """Load PGMs into an (N, H, W) uint8 batch with the threaded C loader.

    ``pad_to=(H, W)`` zero-pads or crops each frame; without it every frame
    must have the first file's size (``ValueError`` otherwise).  A file that
    cannot be read raises ``IOError``.  No paths give a (0, 0, 0) batch.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native gsio library unavailable")
    paths = list(paths)
    if not paths:
        return np.zeros((0, 0, 0), np.uint8)
    if pad_to is None:
        # as the Python codec: frames of other sizes are an error, not a pad or crop
        dims = probe_pgm(paths[0])
        if dims is None:
            raise IOError(f"cannot read PGM: {paths[0]}")
        for p in paths[1:]:
            d = probe_pgm(p)
            if d is None:
                raise IOError(f"cannot read PGM: {p}")
            if d != dims:
                raise ValueError(f"inconsistent frame sizes without pad_to: {paths[0]} is "
                                 f"{dims[0]}x{dims[1]} but {p} is {d[0]}x{d[1]}")
        pad_to = (dims[1], dims[0])
    ph, pw = int(pad_to[0]), int(pad_to[1])
    n = len(paths)
    out = np.zeros((n, ph, pw), np.uint8)
    status = np.zeros(n, np.int32)
    arr = (ct.c_char_p * n)(*[p.encode() for p in paths])
    ok = lib.gsio_read_batch(arr, n, ph, pw, out, status, int(threads))
    if ok != n:
        bad = [paths[i] for i in range(n) if status[i] != 0]
        raise IOError(f"failed to load {len(bad)} PGMs, first: {bad[0]}")
    return out
