"""Build and load the port's CUDA kernels.

Every ``grayskull_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``) into an object, one ``nvcc`` per source, all started together; the
objects are linked into one shared library with a plain C interface.  That
happens the first time a CUDA tensor reaches a kernel wrapper, and the library
is loaded with :mod:`ctypes`.  Nothing is built or loaded at import, so the
package imports on a machine with no GPU and no ``nvcc``.

The library lands in ``grayskull_tpu_torch/_build/`` under a name keyed by a hash
of the sources and flags, so an edited source is rebuilt and an unchanged one is
reused.  It is written to a temporary file first and moved into place with
:func:`os.replace`, so a second process never loads a half-written library.

``-fmad=false`` keeps ``a*b+c`` as two rounded operations everywhere: the Otsu
sweep, the rBRIEF rotation, the quad warp, the bilinear resize and the
freestanding trig must round each float operation as the C reference does.
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

__all__ = ["NVCC_FLAGS", "build", "check", "compile_command", "library", "link_command", "sources",
           "stream_of"]

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_UINT = ctypes.c_uint
_SIZE = ctypes.c_size_t
_FLOAT = ctypes.c_float
# C entry -> argument types; every pointer and the stream are c_void_p.
_SIGNATURES = {
    "gs_blur_hist": (_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _PTR),
    "gs_blur_hist_window": (_PTR, _PTR, _PTR, *(_INT,) * 8, _PTR),
    "gs_threshold_sobel": (_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR),
    "gs_threshold_sobel_window": (_PTR, _PTR, _PTR, _PTR, *(_INT,) * 5, _PTR),
    "gs_otsu": (_PTR, _PTR, _INT, _INT, _PTR),
    "gs_integral": (_PTR, _PTR, _INT, _INT, _INT, _PTR),
    "gs_lbp_eval_scale": (_PTR, _PTR, _PTR, *(_INT,) * 10, _PTR),
    "gs_fast": (_PTR, _PTR, _PTR, *(_INT,) * 5, _PTR),
    "gs_orb_moments": (*(_PTR,) * 5, *(_INT,) * 5, _PTR),
    "gs_orb_brief": (*(_PTR,) * 7, *(_INT,) * 4, _PTR),
    "gs_ccl": (_PTR, _PTR, _INT, _INT, _INT, _PTR),
    "gs_quad_warp": (_PTR, _PTR, _PTR, *(_INT,) * 5, _PTR),
    "gs_quad_warp_rows": (_PTR, _PTR, _PTR, *(_INT,) * 7, _PTR),
    "gs_adaptive": (_PTR, _PTR, *(_INT,) * 5, _PTR),
    "gs_morph": (_PTR, _PTR, *(_INT,) * 4, _PTR),
    "gs_filter3": (_PTR, _PTR, *(_INT,) * 12, _UINT, _PTR),
    "gs_resize": (_PTR, _PTR, *(_INT,) * 5, _PTR),
    "gs_copy": (_PTR, _PTR, _SIZE, _PTR),
    "gs_triad": (_PTR, _PTR, _PTR, _SIZE, _PTR),
    "gs_match_template": (_PTR, _PTR, _PTR, *(_INT,) * 5, _PTR),
    "gs_contour": (_PTR, _PTR, *(_INT,) * 3, _PTR, _INT, _INT, *(_PTR,) * 6, *(_INT,) * 3,
                   *(_PTR,) * 5, _PTR),
    "gs_fs_orient": (*(_PTR,) * 5, _SIZE, _PTR),
    "gs_fs_atan2": (_PTR, _PTR, _PTR, _SIZE, _PTR),
    "gs_fs_sin": (_PTR, _PTR, _SIZE, _FLOAT, _PTR),
    "gs_blob_stats": (_PTR, _PTR, *(_INT,) * 6, _PTR),
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


def compile_command(src, obj) -> list[str]:
    """The ``nvcc`` command line that compiles the source ``src`` into the object ``obj``."""
    return [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(objs, out) -> list[str]:
    """The ``nvcc`` command line that links the objects ``objs`` into the library ``out``."""
    return [_nvcc(), *GENCODE, "-shared", "-o", str(out), *(str(o) for o in objs)]


def _library_path(srcs) -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libgs_kernels_{digest.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Start every command at once, wait for all, raise if one failed."""
    try:  # every command runs the same nvcc: if it is missing, the first start fails
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build the CUDA kernels: {cmds[0][0]} not found") from e
    failed = []
    for cmd, p in zip(cmds, procs):
        out = p.communicate()[0]
        if p.returncode != 0:
            failed.append(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> pathlib.Path:
    """Compile the sources unless a library built from them exists; return its path."""
    srcs = sources()
    out = _library_path(srcs)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [work / f"{src.stem}.o" for src in srcs]
        _run_all([compile_command(src, obj) for src, obj in zip(srcs, objs)])
        lib = work / out.name
        _run_all([link_command(objs, lib)])
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
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
