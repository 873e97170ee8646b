"""Stencil kernels of the preprocess main path, with their plain PyTorch versions.

* :func:`blur_hist` (K1, ``csrc/preproc.cu:gs_blur_hist``) replaces the Pallas
  kernels ``fused_blur_hist`` and ``blur_pallas``: the clipped-window box mean
  of ``gs_blur`` with truncating division and, optionally, each frame's
  256-bin histogram of the blurred pixels in the same pass.
* :func:`threshold_sobel` (K2, ``csrc/preproc.cu:gs_threshold_sobel``) replaces
  ``fused_threshold_sobel`` and ``sobel_pallas``: an optional per-frame
  ``p > t[n] ? 255 : 0`` binarization, then the interior Sobel magnitude.
* :func:`adaptive` (K11, ``csrc/preproc.cu:gs_adaptive``) replaces
  ``adaptive_pallas``: ``src > clipped_mean - c ? 255 : 0`` on K1's window sum.
* :func:`morph` (K12, ``csrc/stencil3.cu:gs_morph``) replaces ``morph_pallas``:
  the 3x3 erode or dilate over the in-frame neighbours.
* :func:`filter3` (K13, ``csrc/stencil3.cu:gs_filter3``) replaces
  ``filter3_pallas``: the zero-padded 3x3 ``gs_filter`` with C's unsigned
  division of the sum and a clamp to 0..255.
* :func:`blur_hist_window` (K15, ``csrc/preproc.cu:gs_blur_hist_window``)
  replaces ``fused_blur_hist_window``: K1 on one H-shard extended by exchanged
  halo rows, the window counts taken at global rows and the histogram over
  the shard's own rows.
* :func:`threshold_sobel_window` (K16, ``csrc/preproc.cu:gs_threshold_sobel_window``)
  replaces ``fused_threshold_sobel_window``: K2 with thresholds on one H-shard
  with a 1-row halo, the zero border at the global frame's edge.

A wrapper given a CUDA tensor launches its kernel or raises; given a CPU tensor
it runs the plain version (``*_plain``), which is also what the kernel is held
to on the card.  ``launches`` counts the kernel launches of each wrapper.
"""

from __future__ import annotations

import torch

from .. import profiling
from . import _build

__all__ = ["adaptive", "adaptive_plain", "blur_hist", "blur_hist_plain", "blur_hist_window",
           "blur_hist_window_plain", "filter3", "filter3_plain", "filter_plain",
           "frame_histograms", "launches", "morph", "morph_plain", "sobel_plain",
           "threshold_sobel", "threshold_sobel_plain", "threshold_sobel_window",
           "threshold_sobel_window_plain"]

launches = {"blur_hist": 0, "threshold_sobel": 0, "adaptive": 0, "morph": 0, "filter3": 0,
            "blur_hist_window": 0, "threshold_sobel_window": 0}

_INT32_MAX = 2**31 - 1
_MORPH_OPS = ("erode", "dilate")


def _check_frames(imgs: torch.Tensor, name: str) -> None:
    if not isinstance(imgs, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(imgs).__name__}")
    if imgs.dtype != torch.uint8:
        raise TypeError(f"{name}: frames must be torch.uint8, got {imgs.dtype}")
    if imgs.ndim != 3 or min(imgs.shape) < 1:
        raise ValueError(f"{name}: expected non-empty (N, H, W) frames, got {tuple(imgs.shape)}")
    if not imgs.is_contiguous():
        raise ValueError(f"{name}: frames must be contiguous")


def _check_radius(name: str, r: int, h: int, w: int) -> None:
    if r < 0:
        raise ValueError(f"{name}: radius must be >= 0, got {r}")
    if 255 * min(2 * r + 1, h) * min(2 * r + 1, w) > _INT32_MAX:
        raise ValueError(f"{name}: radius {r} on {h}x{w} frames overflows the int32 window sum")


def _check_thresholds(name: str, thresholds: torch.Tensor, imgs: torch.Tensor) -> None:
    n = imgs.shape[0]
    if thresholds.dtype != torch.uint8 or tuple(thresholds.shape) != (n,):
        raise ValueError(f"{name}: thresholds must be ({n},) uint8, got "
                         f"{tuple(thresholds.shape)} {thresholds.dtype}")
    if thresholds.device != imgs.device or not thresholds.is_contiguous():
        raise ValueError(f"{name}: thresholds must be contiguous on the frames' device")


def _check_rows(name: str, row0: int, h_total: int) -> None:
    """The shard's global offset and the frame height stay far inside int32."""
    if not 1 <= h_total < 2**30 or abs(row0) >= 2**30:
        raise ValueError(f"{name}: need 1 <= h_total < 2^30 and |row0| < 2^30, got "
                         f"h_total={h_total}, row0={row0}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def frame_histograms(imgs: torch.Tensor) -> torch.Tensor:
    """(N, H, W) uint8 -> (N, 256) int32 counts, one ``bincount`` for the batch."""
    n = imgs.shape[0]
    offs = torch.arange(n, device=imgs.device, dtype=torch.int32).mul_(256).view(n, 1, 1)
    keys = imgs.to(torch.int32) + offs
    return torch.bincount(keys.reshape(-1), minlength=256 * n).view(n, 256).to(torch.int32)


def _clipped_window_sum(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Sum over ``[i-r, i+r]`` clipped to the axis, along ``dim``, by prefix sums."""
    size = x.shape[dim]
    idx = torch.arange(size, device=x.device)
    hi = (idx + r).clamp(max=size - 1) + 1
    lo = (idx - r).clamp(min=0)
    zero_shape = list(x.shape)
    zero_shape[dim] = 1
    p = torch.cat([x.new_zeros(zero_shape), torch.cumsum(x, dim=dim, dtype=x.dtype)], dim=dim)
    return p.index_select(dim, hi) - p.index_select(dim, lo)


def _window_counts(size: int, r: int, device, start: int = 0, total: int | None = None):
    """Pixels of ``[i-r, i+r]`` inside ``[0, total)`` at the axis's positions
    ``i = start .. start + size - 1`` (default: the axis itself)."""
    total = size if total is None else total
    idx = torch.arange(size, device=device) + start
    return (idx + r).clamp(max=total - 1) - (idx - r).clamp(min=0) + 1


def _clipped_mean(imgs: torch.Tensor, r: int, row0: int = 0,
                  h_total: int | None = None) -> torch.Tensor:
    """Clipped-window box mean with truncating division, int32 or int64.

    The sums clip to the array; the counts' rows are the frame's rows
    ``row0 ..`` of a frame of ``h_total`` rows (default: the array itself).
    """
    n, h, w = imgs.shape
    wide = torch.int32 if 255 * h * w <= _INT32_MAX else torch.int64
    s = _clipped_window_sum(_clipped_window_sum(imgs.to(wide), r, 2), r, 1)
    count = (_window_counts(h, r, imgs.device, row0, h_total)[:, None]
             * _window_counts(w, r, imgs.device)[None, :]).to(wide)
    return torch.div(s, count, rounding_mode="floor")


def blur_hist_plain(imgs: torch.Tensor, radius: int, with_hist: bool = True):
    """Plain version of :func:`blur_hist`: ``(blurred, hist or None)``."""
    blurred = _clipped_mean(imgs, int(radius)).to(torch.uint8)
    return blurred, frame_histograms(blurred) if with_hist else None


def blur_hist_window_plain(imgs_ext: torch.Tensor, row0: int, radius: int, *, h_total: int,
                           row_lo: int, row_hi: int):
    """Plain version of :func:`blur_hist_window`: ``(blurred_ext, hist)``."""
    blurred = _clipped_mean(imgs_ext, int(radius), int(row0), int(h_total)).to(torch.uint8)
    return blurred, frame_histograms(blurred[:, int(row_lo):int(row_hi)])


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor's values modulo 2^32, read as int32 (still int64)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def adaptive_plain(imgs: torch.Tensor, radius: int, c: int) -> torch.Tensor:
    """Plain version of :func:`adaptive`: ``src > mean - c ? 255 : 0``, the
    subtraction wrapping as int32 does (computed in int64)."""
    thr = _wrap_int32(_clipped_mean(imgs, int(radius)).to(torch.int64) - int(c))
    return (imgs.to(torch.int64) > thr).to(torch.uint8) * 255


def morph_plain(imgs: torch.Tensor, op: str) -> torch.Tensor:
    """Plain version of :func:`morph`: the frames padded with the op-neutral value
    (255 for erode, 0 for dilate), then the min or max of the 9 shifts."""
    h, w = imgs.shape[-2:]
    erode = op == "erode"
    x = torch.nn.functional.pad(imgs, (1, 1, 1, 1), value=255 if erode else 0)
    fn = torch.minimum if erode else torch.maximum
    out = x[:, 1 : 1 + h, 1 : 1 + w]
    for dy in range(3):
        for dx in range(3):
            out = fn(out, x[:, dy : dy + h, dx : dx + w])
    return out.contiguous()


def filter_plain(imgs: torch.Tensor, taps, norm: int) -> torch.Tensor:
    """``gs_filter`` with any (kh, kw) int32 taps: the zero-padded correlation as
    int32 multiply-adds that wrap (computed in int64, then taken modulo 2^32),
    then C's ``int / unsigned``: the sum read as uint32, divided by ``norm``,
    read back as int32 and clamped to 0..255."""
    rows = [[int(v) for v in row] for row in taps]
    kh, kw = len(rows), len(rows[0])
    h, w = imgs.shape[-2:]
    x = torch.nn.functional.pad(imgs.to(torch.int64), (kw // 2, kw - 1 - kw // 2,
                                                       kh // 2, kh - 1 - kh // 2))
    acc = torch.zeros(imgs.shape, dtype=torch.int64, device=imgs.device)
    for j in range(kh):
        for i in range(kw):
            if rows[j][i] != 0:
                acc += x[:, j : j + h, i : i + w] * rows[j][i]
    q = torch.div(acc & 0xFFFFFFFF, int(norm), rounding_mode="floor")
    # uint32 -> int32: a quotient of 2^31 or more is negative and clamps to 0
    return torch.where(q >= 2**31, 0, q.clamp(max=255)).to(torch.uint8)


filter3_plain = filter_plain  # K13's plain version: filter_plain with 3x3 taps


def sobel_plain(imgs: torch.Tensor, row0: int = 0, h_total: int | None = None) -> torch.Tensor:
    """Interior ``min((|gx|+|gy|)/2, 255)``, zero 1-pixel border, (N, H, W) uint8.

    Pixels outside the array read 0.  The border's rows are the frame's: array
    row ``y`` is frame row ``y + row0`` of a frame of ``h_total`` rows (default:
    the array itself).
    """
    h, w = imgs.shape[-2:]
    total = h if h_total is None else h_total
    x = torch.nn.functional.pad(imgs.to(torch.int32), (1, 1, 1, 1))

    def sh(dy, dx):
        return x[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    gx = -sh(-1, -1) + sh(-1, 1) - 2 * sh(0, -1) + 2 * sh(0, 1) - sh(1, -1) + sh(1, 1)
    gy = -sh(-1, -1) - 2 * sh(-1, 0) - sh(-1, 1) + sh(1, -1) + 2 * sh(1, 0) + sh(1, 1)
    mag = torch.div(gx.abs() + gy.abs(), 2, rounding_mode="floor").clamp_(max=255)
    rows = torch.arange(h, device=imgs.device) + row0
    cols = torch.arange(w, device=imgs.device)
    interior = (((rows >= 1) & (rows <= total - 2))[:, None]
                & ((cols >= 1) & (cols <= w - 2))[None, :])
    return torch.where(interior, mag, 0).to(torch.uint8)


def threshold_sobel_plain(imgs: torch.Tensor, thresholds: torch.Tensor | None = None,
                          want_binary: bool = True):
    """Plain version of :func:`threshold_sobel`: ``(binary or None, edges)``."""
    if thresholds is None:
        return None, sobel_plain(imgs)
    binary = (imgs > thresholds.view(-1, 1, 1)).to(torch.uint8) * 255
    return (binary if want_binary else None), sobel_plain(binary)


def threshold_sobel_window_plain(blurred_ext: torch.Tensor, thresholds: torch.Tensor, row0: int,
                                 *, h_total: int, want_binary: bool = True):
    """Plain version of :func:`threshold_sobel_window`: ``(binary_ext or None, edges_ext)``."""
    binary = (blurred_ext > thresholds.view(-1, 1, 1)).to(torch.uint8) * 255
    return (binary if want_binary else None), sobel_plain(binary, int(row0), int(h_total))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@profiling.spanned("gs.kernels.blur_hist")
def blur_hist(imgs: torch.Tensor, radius: int, with_hist: bool = True):
    """K1: (N, H, W) uint8 -> ``(blurred uint8, hist (N, 256) int32 or None)``.

    Any N, H, W >= 1 and any radius >= 0 whose clipped window sum fits int32.
    """
    _check_frames(imgs, "blur_hist")
    n, h, w = imgs.shape
    r = int(radius)
    _check_radius("blur_hist", r, h, w)
    if not imgs.is_cuda:
        return blur_hist_plain(imgs, r, with_hist)
    lib = _build.library()
    blurred = torch.empty_like(imgs)
    hist = torch.zeros((n, 256), dtype=torch.int32, device=imgs.device) if with_hist else None
    with torch.cuda.device(imgs.device):
        code = lib.gs_blur_hist(imgs.data_ptr(), blurred.data_ptr(),
                                None if hist is None else hist.data_ptr(),
                                n, h, w, min(r, max(h, w)), _build.stream_of(imgs))
    _build.check(code, "blur_hist")
    launches["blur_hist"] += 1
    return blurred, hist


@profiling.spanned("gs.kernels.threshold_sobel")
def threshold_sobel(imgs: torch.Tensor, thresholds: torch.Tensor | None = None,
                    want_binary: bool = True):
    """K2: (N, H, W) uint8 [+ (N,) uint8 thresholds] -> ``(binary or None, edges)``.

    With ``thresholds`` the frames are first binarized ``p > t[n] ? 255 : 0``
    (written out as ``binary`` when ``want_binary``); the Sobel magnitude of the
    result (or of the raw frames, without thresholds) is ``edges``.
    """
    _check_frames(imgs, "threshold_sobel")
    n, h, w = imgs.shape
    if thresholds is not None:
        _check_thresholds("threshold_sobel", thresholds, imgs)
    if not imgs.is_cuda:
        return threshold_sobel_plain(imgs, thresholds, want_binary)
    lib = _build.library()
    edges = torch.empty_like(imgs)
    binary = torch.empty_like(imgs) if thresholds is not None and want_binary else None
    with torch.cuda.device(imgs.device):
        code = lib.gs_threshold_sobel(imgs.data_ptr(),
                                      None if thresholds is None else thresholds.data_ptr(),
                                      None if binary is None else binary.data_ptr(),
                                      edges.data_ptr(), n, h, w, _build.stream_of(imgs))
    _build.check(code, "threshold_sobel")
    launches["threshold_sobel"] += 1
    return binary, edges


@profiling.spanned("gs.kernels.adaptive")
def adaptive(imgs: torch.Tensor, radius: int, c: int) -> torch.Tensor:
    """K11: (N, H, W) uint8 -> ``src > clipped_mean - c ? 255 : 0`` uint8.

    ``c`` is an int32 offset, passed to the kernel by value.  Any radius >= 0
    whose clipped window sum fits int32, as :func:`blur_hist`.
    """
    _check_frames(imgs, "adaptive")
    n, h, w = imgs.shape
    r, c = int(radius), int(c)
    _check_radius("adaptive", r, h, w)
    if not -2**31 <= c <= _INT32_MAX:
        raise ValueError(f"adaptive: c must fit int32, got {c}")
    if not imgs.is_cuda:
        return adaptive_plain(imgs, r, c)
    lib = _build.library()
    out = torch.empty_like(imgs)
    with torch.cuda.device(imgs.device):
        code = lib.gs_adaptive(imgs.data_ptr(), out.data_ptr(), n, h, w, min(r, max(h, w)), c,
                               _build.stream_of(imgs))
    _build.check(code, "adaptive")
    launches["adaptive"] += 1
    return out


@profiling.spanned("gs.kernels.morph")
def morph(imgs: torch.Tensor, op: str) -> torch.Tensor:
    """K12: (N, H, W) uint8 -> the 3x3 ``"erode"`` (min) or ``"dilate"`` (max) over
    each pixel's in-frame neighbours."""
    _check_frames(imgs, "morph")
    if op not in _MORPH_OPS:
        raise ValueError(f"morph: op must be 'erode' or 'dilate', got {op!r}")
    if not imgs.is_cuda:
        return morph_plain(imgs, op)
    n, h, w = imgs.shape
    lib = _build.library()
    out = torch.empty_like(imgs)
    with torch.cuda.device(imgs.device):
        code = lib.gs_morph(imgs.data_ptr(), out.data_ptr(), n, h, w, int(op == "erode"),
                            _build.stream_of(imgs))
    _build.check(code, "morph")
    launches["morph"] += 1
    return out


@profiling.spanned("gs.kernels.filter3")
def filter3(imgs: torch.Tensor, taps, norm: int) -> torch.Tensor:
    """K13: (N, H, W) uint8 and 3x3 int32 taps -> ``gs_filter``: the zero-padded
    correlation, ``(uint32)sum / norm`` read back as int32, clamped to 0..255.

    ``taps`` is any 3x3 nesting of ints in int32 range (the caller reinterprets
    a uint8 kernel image as int8 first); ``norm`` is 1 .. 2^32 - 1.
    """
    _check_frames(imgs, "filter3")
    k = [int(v) for row in taps for v in row]
    if len(taps) != 3 or len(k) != 9 or any(len(row) != 3 for row in taps):
        raise ValueError("filter3: taps must be 3x3")
    if any(not -2**31 <= v <= _INT32_MAX for v in k):
        raise ValueError(f"filter3: taps must fit int32, got {k}")
    norm = int(norm)
    if not 1 <= norm < 2**32:
        raise ValueError(f"filter3: norm must be in 1 .. 2^32 - 1, got {norm}")
    if not imgs.is_cuda:
        return filter3_plain(imgs, taps, norm)
    n, h, w = imgs.shape
    lib = _build.library()
    out = torch.empty_like(imgs)
    with torch.cuda.device(imgs.device):
        code = lib.gs_filter3(imgs.data_ptr(), out.data_ptr(), n, h, w, *k, norm,
                              _build.stream_of(imgs))
    _build.check(code, "filter3")
    launches["filter3"] += 1
    return out


@profiling.spanned("gs.kernels.blur_hist_window")
def blur_hist_window(imgs_ext: torch.Tensor, row0: int, radius: int, *, h_total: int,
                     row_lo: int, row_hi: int):
    """K15: one H-shard ``(N, h_ext, W)`` uint8 -> ``(blurred_ext, hist (N, 256) int32)``.

    ``imgs_ext`` is a shard's rows with ``radius`` exchanged halo rows on each
    side (zeros past the frame).  Array row ``y`` is frame row ``y + row0`` of
    a frame of ``h_total`` rows (``row0`` may be negative): the window sums
    clip to the array, their pixel counts to the frame.  The histogram counts
    the blurred rows ``[row_lo, row_hi)`` of the array.  Every window must
    count at least one frame row, so ``-radius <= row0`` and
    ``row0 + h_ext <= h_total + radius``.  Any radius whose window sum fits int32.

    A halo row past the frame is summed but not counted, so where it is not
    zero (the exchange gives zeros) a mean can pass 255: the stored byte
    wraps mod 256 and the histogram counts that byte.  The JAX kernel leaves
    such a mean out of its histogram instead.
    """
    _check_frames(imgs_ext, "blur_hist_window")
    n, h, w = imgs_ext.shape
    r, row0, h_total = int(radius), int(row0), int(h_total)
    row_lo, row_hi = int(row_lo), int(row_hi)
    _check_radius("blur_hist_window", r, h, w)
    _check_rows("blur_hist_window", row0, h_total)
    if row0 < -r or row0 + h > h_total + r:
        raise ValueError(f"blur_hist_window: rows {row0} .. {row0 + h - 1} of a {h_total}-row "
                         f"frame leave a radius-{r} window with no frame row")
    if not 0 <= row_lo <= row_hi <= h:
        raise ValueError(f"blur_hist_window: need 0 <= row_lo <= row_hi <= {h}, got "
                         f"{row_lo}, {row_hi}")
    if not imgs_ext.is_cuda:
        return blur_hist_window_plain(imgs_ext, row0, r, h_total=h_total, row_lo=row_lo,
                                      row_hi=row_hi)
    lib = _build.library()
    blurred = torch.empty_like(imgs_ext)
    hist = torch.zeros((n, 256), dtype=torch.int32, device=imgs_ext.device)
    # past this radius every window spans the array, the row and the frame
    whole = max(h, w, h_total - row0, row0 + h)
    with torch.cuda.device(imgs_ext.device):
        code = lib.gs_blur_hist_window(imgs_ext.data_ptr(), blurred.data_ptr(), hist.data_ptr(),
                                       n, h, w, min(r, whole), row0, h_total, row_lo, row_hi,
                                       _build.stream_of(imgs_ext))
    _build.check(code, "blur_hist_window")
    launches["blur_hist_window"] += 1
    return blurred, hist


@profiling.spanned("gs.kernels.threshold_sobel_window")
def threshold_sobel_window(blurred_ext: torch.Tensor, thresholds: torch.Tensor, row0: int, *,
                           h_total: int, want_binary: bool = True):
    """K16: one H-shard ``(N, h_ext, W)`` uint8 and ``(N,)`` uint8 thresholds ->
    ``(binary_ext or None, edges_ext)``.

    Each frame is binarized ``p > t[n] ? 255 : 0``, then its Sobel magnitude
    is taken; pixels outside the array read 0.  Array row ``y`` is frame row
    ``y + row0`` of a frame of ``h_total`` rows, and only the frame's own
    1-pixel border is zero, so a shard with a 1-row halo gets real edges at
    its seams.
    """
    _check_frames(blurred_ext, "threshold_sobel_window")
    n, h, w = blurred_ext.shape
    row0, h_total = int(row0), int(h_total)
    _check_thresholds("threshold_sobel_window", thresholds, blurred_ext)
    _check_rows("threshold_sobel_window", row0, h_total)
    if not blurred_ext.is_cuda:
        return threshold_sobel_window_plain(blurred_ext, thresholds, row0, h_total=h_total,
                                            want_binary=want_binary)
    lib = _build.library()
    edges = torch.empty_like(blurred_ext)
    binary = torch.empty_like(blurred_ext) if want_binary else None
    with torch.cuda.device(blurred_ext.device):
        code = lib.gs_threshold_sobel_window(blurred_ext.data_ptr(), thresholds.data_ptr(),
                                             None if binary is None else binary.data_ptr(),
                                             edges.data_ptr(), n, h, w, row0, h_total,
                                             _build.stream_of(blurred_ext))
    _build.check(code, "threshold_sobel_window")
    launches["threshold_sobel_window"] += 1
    return binary, edges
