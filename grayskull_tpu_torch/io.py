"""PGM (P5, maxval 255) I/O — ``gs_read_pgm``/``gs_write_pgm`` (grayskull.h:111-136).

The same codec as ``grayskull_tpu.io``, on numpy arrays (pass a decoded frame to
:func:`grayskull_tpu_torch.core.as_image` for a tensor).  Only binary P5 with
maxval 255 is accepted, and the path ``"-"`` is stdin/stdout.  The header is
parsed with C ``fscanf("P5\\n%u %u\\n%u\\n")`` semantics: each whitespace
directive matches a run of zero or more whitespace bytes, and the run before the
payload is consumed greedily (a leading whitespace-valued pixel byte is eaten,
as fscanf does).  Comments are not supported, as in the reference.
"""

from __future__ import annotations

import re
import sys
from typing import Optional

import numpy as np

__all__ = ["read_pgm", "write_pgm", "decode_pgm", "encode_pgm", "read_pgm_batch"]

_WS = b" \t\r\n\x0b\x0c"  # C isspace() set
_HEADER_RE = re.compile(
    rb"^P5[ \t\r\n\x0b\x0c]*(\d+)[ \t\r\n\x0b\x0c]+(\d+)[ \t\r\n\x0b\x0c]+(\d+)"
)


def decode_pgm(buf: bytes) -> Optional[np.ndarray]:
    """Decode a binary P5 PGM buffer to (H, W) uint8, or None on malformed input."""
    m = _HEADER_RE.match(buf)
    if not m:
        return None
    w, h, maxval = (int(g) for g in m.groups())
    if maxval != 255 or w == 0 or h == 0:
        return None
    start = m.end()
    while start < len(buf) and buf[start] in _WS:
        start += 1
    need = w * h
    data = buf[start : start + need]
    if len(data) != need:
        return None
    return np.frombuffer(data, dtype=np.uint8).reshape(h, w)


def encode_pgm(img: np.ndarray) -> bytes:
    """Encode (H, W) uint8 to binary P5 with maxval 255 (grayskull.h:128-136)."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"expected (H, W) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape
    return b"P5\n%d %d\n255\n" % (w, h) + img.tobytes()


def read_pgm(path: str) -> Optional[np.ndarray]:
    """Read a PGM file; path ``"-"`` reads stdin (grayskull.h:113)."""
    try:
        if path == "-":
            buf = sys.stdin.buffer.read()
        else:
            with open(path, "rb") as f:
                buf = f.read()
    except OSError:
        return None
    return decode_pgm(buf)


def write_pgm(img, path: str) -> int:
    """Write a PGM file; path ``"-"`` writes stdout.  Returns 0 on success, -1 on error."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8 or img.size == 0:
        return -1
    try:
        data = encode_pgm(img)
        if path == "-":
            sys.stdout.buffer.write(data)
            sys.stdout.buffer.flush()
        else:
            with open(path, "wb") as f:
                f.write(data)
        return 0
    except OSError:
        return -1


def read_pgm_batch(paths, pad_to=None) -> np.ndarray:
    """Read several same-sized PGMs into an (N, H, W) uint8 batch.

    ``pad_to=(H, W)`` zero-pads each frame bottom/right (or crops it) to a common
    shape.
    """
    frames = []
    shape = None
    for p in paths:
        img = read_pgm(p)
        if img is None:
            raise IOError(f"cannot read PGM: {p}")
        if pad_to is not None:
            ph, pw = pad_to
            out = np.zeros((ph, pw), np.uint8)
            out[: img.shape[0], : img.shape[1]] = img[:ph, :pw]
            img = out
        if shape is None:
            shape = img.shape
        elif img.shape != shape:
            raise ValueError(f"inconsistent frame shapes: {img.shape} vs {shape}")
        frames.append(img)
    return np.stack(frames)
