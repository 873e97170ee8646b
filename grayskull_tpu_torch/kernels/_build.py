"""Build and load the port's CUDA kernels.

Every ``grayskull_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, the first time a
CUDA tensor reaches a kernel wrapper, and the library is loaded with
:mod:`ctypes`.  Nothing is built or loaded at import, so the package imports on a
machine with no GPU and no ``nvcc``.

The library lands in ``grayskull_tpu_torch/_build/`` under a name keyed by a hash
of the sources and flags, so an edited source is rebuilt and an unchanged one is
reused.  It is written to a temporary file first and moved into place with
:func:`os.replace`, so a second process never loads a half-written library.

``-fmad=false`` keeps ``a*b+c`` as two rounded operations everywhere: the Otsu
sweep must round each float operation as the C reference does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

__all__ = ["NVCC_FLAGS", "build", "build_command", "check", "library", "sources", "stream_of"]

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# C entry -> argument types; every pointer and the stream are c_void_p.
_SIGNATURES = {
    "gs_blur_hist": (_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _PTR),
    "gs_threshold_sobel": (_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR),
    "gs_otsu": (_PTR, _PTR, _INT, _INT, _PTR),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build_command(srcs, out) -> list[str]:
    """The ``nvcc`` command line that builds ``srcs`` into the library ``out``."""
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), *(str(s) for s in srcs)]


def _library_path(srcs) -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libgs_kernels_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the sources unless a library built from them exists; return its path."""
    srcs = sources()
    out = _library_path(srcs)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = build_command(srcs, tmp)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"cannot build the CUDA kernels: {cmd[0]} not found") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.gs_error_string.argtypes = (ctypes.c_int,)
            lib.gs_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code != 0:
        msg = library().gs_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def stream_of(tensor) -> int:
    """The raw handle of PyTorch's current stream on ``tensor``'s device."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
