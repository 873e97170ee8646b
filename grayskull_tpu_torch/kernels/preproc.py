"""Stencil kernels of the preprocess main path, with their plain PyTorch versions.

* :func:`blur_hist` (K1, ``csrc/preproc.cu:gs_blur_hist``) replaces the Pallas
  kernels ``fused_blur_hist`` and ``blur_pallas``: the clipped-window box mean
  of ``gs_blur`` with truncating division and, optionally, each frame's
  256-bin histogram of the blurred pixels in the same pass.
* :func:`threshold_sobel` (K2, ``csrc/preproc.cu:gs_threshold_sobel``) replaces
  ``fused_threshold_sobel`` and ``sobel_pallas``: an optional per-frame
  ``p > t[n] ? 255 : 0`` binarization, then the interior Sobel magnitude.

A wrapper given a CUDA tensor launches its kernel or raises; given a CPU tensor
it runs the plain version (``*_plain``), which is also what the kernel is held
to on the card.  ``launches`` counts the kernel launches of each wrapper.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["blur_hist", "blur_hist_plain", "frame_histograms", "launches", "sobel_plain",
           "threshold_sobel", "threshold_sobel_plain"]

launches = {"blur_hist": 0, "threshold_sobel": 0}

_INT32_MAX = 2**31 - 1


def _check_frames(imgs: torch.Tensor, name: str) -> None:
    if not isinstance(imgs, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(imgs).__name__}")
    if imgs.dtype != torch.uint8:
        raise TypeError(f"{name}: frames must be torch.uint8, got {imgs.dtype}")
    if imgs.ndim != 3 or min(imgs.shape) < 1:
        raise ValueError(f"{name}: expected non-empty (N, H, W) frames, got {tuple(imgs.shape)}")
    if not imgs.is_contiguous():
        raise ValueError(f"{name}: frames must be contiguous")


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


def _window_counts(size: int, r: int, device) -> torch.Tensor:
    idx = torch.arange(size, device=device)
    return (idx + r).clamp(max=size - 1) - (idx - r).clamp(min=0) + 1


def blur_hist_plain(imgs: torch.Tensor, radius: int, with_hist: bool = True):
    """Plain version of :func:`blur_hist`: ``(blurred, hist or None)``."""
    n, h, w = imgs.shape
    r = int(radius)
    wide = torch.int32 if 255 * h * w <= _INT32_MAX else torch.int64
    s = _clipped_window_sum(_clipped_window_sum(imgs.to(wide), r, 2), r, 1)
    count = (_window_counts(h, r, imgs.device)[:, None]
             * _window_counts(w, r, imgs.device)[None, :]).to(wide)
    blurred = torch.div(s, count, rounding_mode="floor").to(torch.uint8)
    return blurred, frame_histograms(blurred) if with_hist else None


def sobel_plain(imgs: torch.Tensor) -> torch.Tensor:
    """Interior ``min((|gx|+|gy|)/2, 255)``, zero 1-pixel border, (N, H, W) uint8."""
    out = torch.zeros_like(imgs)
    h, w = imgs.shape[-2:]
    if h < 3 or w < 3:
        return out
    x = imgs.to(torch.int32)

    def sh(dy, dx):
        return x[:, 1 + dy : h - 1 + dy, 1 + dx : w - 1 + dx]

    gx = -sh(-1, -1) + sh(-1, 1) - 2 * sh(0, -1) + 2 * sh(0, 1) - sh(1, -1) + sh(1, 1)
    gy = -sh(-1, -1) - 2 * sh(-1, 0) - sh(-1, 1) + sh(1, -1) + 2 * sh(1, 0) + sh(1, 1)
    mag = torch.div(gx.abs() + gy.abs(), 2, rounding_mode="floor").clamp_(max=255)
    out[:, 1:-1, 1:-1] = mag.to(torch.uint8)
    return out


def threshold_sobel_plain(imgs: torch.Tensor, thresholds: torch.Tensor | None = None,
                          want_binary: bool = True):
    """Plain version of :func:`threshold_sobel`: ``(binary or None, edges)``."""
    if thresholds is None:
        return None, sobel_plain(imgs)
    binary = (imgs > thresholds.view(-1, 1, 1)).to(torch.uint8) * 255
    return (binary if want_binary else None), sobel_plain(binary)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def blur_hist(imgs: torch.Tensor, radius: int, with_hist: bool = True):
    """K1: (N, H, W) uint8 -> ``(blurred uint8, hist (N, 256) int32 or None)``.

    Any N, H, W >= 1 and any radius >= 0 whose clipped window sum fits int32.
    """
    _check_frames(imgs, "blur_hist")
    n, h, w = imgs.shape
    r = int(radius)
    if r < 0:
        raise ValueError(f"blur_hist: radius must be >= 0, got {r}")
    if 255 * min(2 * r + 1, h) * min(2 * r + 1, w) > _INT32_MAX:
        raise ValueError(f"blur_hist: radius {r} on {h}x{w} frames overflows the int32 window sum")
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
        if thresholds.dtype != torch.uint8 or tuple(thresholds.shape) != (n,):
            raise ValueError(f"threshold_sobel: thresholds must be ({n},) uint8, got "
                             f"{tuple(thresholds.shape)} {thresholds.dtype}")
        if thresholds.device != imgs.device or not thresholds.is_contiguous():
            raise ValueError("threshold_sobel: thresholds must be contiguous on the frames' device")
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
