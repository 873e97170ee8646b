"""Plain PyTorch versions of what ``grayskull.h`` computes, shared by the
references under ``reference/``.  They import nothing of the port.

Each is a frozen copy of the port's plain version of the same step
(``blur_hist_plain``, ``frame_histograms``, ``otsu_plain``, ``sobel_plain``,
``ccl_plain``, ``quad_warp_plain``): integer steps exact, float steps one
eagerly rounded float32 operation at a time, in C's order.  Where a step
computes in float, ``dtype`` selects the precision, so that the control can
run the same reference one precision lower.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF
_INT32_MAX = 2**31 - 1


def _clipped_window_sum(x, r, dim):
    """Sum over ``[i - r, i + r]`` clipped to the axis, along ``dim``, by prefix sums."""
    size = x.shape[dim]
    idx = torch.arange(size, device=x.device)
    hi = (idx + r).clamp(max=size - 1) + 1
    lo = (idx - r).clamp(min=0)
    zero_shape = list(x.shape)
    zero_shape[dim] = 1
    p = torch.cat([x.new_zeros(zero_shape), torch.cumsum(x, dim=dim, dtype=x.dtype)], dim=dim)
    return p.index_select(dim, hi) - p.index_select(dim, lo)


def _window_counts(size, r, device):
    idx = torch.arange(size, device=device)
    return (idx + r).clamp(max=size - 1) - (idx - r).clamp(min=0) + 1


def blur(frames, r, dtype=None):
    """``gs_blur``: the clipped-window box mean with truncating division, (N, H, W) uint8.

    With a float ``dtype`` the division is the window sum times the count's
    reciprocal in that precision, truncated: the control's blur.
    """
    n, h, w = frames.shape
    wide = torch.int32 if 255 * h * w <= _INT32_MAX else torch.int64
    s = _clipped_window_sum(_clipped_window_sum(frames.to(wide), r, 2), r, 1)
    count = (_window_counts(h, r, frames.device)[:, None]
             * _window_counts(w, r, frames.device)[None, :]).to(wide)
    if dtype is not None:
        return (s.to(dtype) * (1 / count.to(dtype))).to(torch.uint8)
    return torch.div(s, count, rounding_mode="floor").to(torch.uint8)


def histograms(frames):
    """(N, H, W) uint8 -> (N, 256) int32 counts."""
    n = frames.shape[0]
    offs = torch.arange(n, device=frames.device, dtype=torch.int32).mul_(256).view(n, 1, 1)
    keys = frames.to(torch.int32) + offs
    return torch.bincount(keys.reshape(-1), minlength=256 * n).view(n, 256).to(torch.int32)


def otsu(hist, total, dtype=torch.float32):
    """``gs_otsu_threshold``'s sweep over (N, 256) counts: (N,) uint8.

    Counts and weights wrap as uint32; the float sums run bin by bin; the
    ``wb == 0`` skip, the ``wf == 0`` break and the strict first maximum are C's.
    """
    counts = hist.to(torch.int64) & _U32
    terms = torch.arange(256, device=hist.device, dtype=dtype) * counts.to(dtype)
    total_sum = torch.zeros(hist.shape[0], device=hist.device, dtype=dtype)
    for i in range(256):
        total_sum = total_sum + terms[:, i]
    wbs = torch.cumsum(counts, dim=1) & _U32
    sum_b = torch.zeros_like(total_sum)
    var_max = torch.full_like(total_sum, -1.0)
    thr = torch.zeros(hist.shape[0], device=hist.device, dtype=torch.int64)
    done = torch.zeros(hist.shape[0], device=hist.device, dtype=torch.bool)
    for t in range(256):
        wb = wbs[:, t]
        wf = (int(total) - wb) & _U32
        live = (wb != 0) & ~done
        brk = live & (wf == 0)
        active = live & ~brk
        sum_b = torch.where(active, sum_b + terms[:, t], sum_b)
        fb = wb.to(dtype)
        ff = wf.to(dtype)
        d = sum_b / fb - (total_sum - sum_b) / ff
        var = ((fb * ff) * d) * d
        better = active & (var > var_max)
        var_max = torch.where(better, var, var_max)
        thr = torch.where(better, t, thr)
        done = done | brk
    return thr.to(torch.uint8)


def sobel(frames):
    """``gs_sobel``: interior ``min((|gx| + |gy|) / 2, 255)``, zero 1-pixel border."""
    h, w = frames.shape[-2:]
    x = torch.nn.functional.pad(frames.to(torch.int32), (1, 1, 1, 1))

    def sh(dy, dx):
        return x[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    gx = -sh(-1, -1) + sh(-1, 1) - 2 * sh(0, -1) + 2 * sh(0, 1) - sh(1, -1) + sh(1, 1)
    gy = -sh(-1, -1) - 2 * sh(-1, 0) - sh(-1, 1) + sh(1, -1) + 2 * sh(1, 0) + sh(1, 1)
    mag = torch.div(gx.abs() + gy.abs(), 2, rounding_mode="floor").clamp_(max=255)
    rows = torch.arange(h, device=frames.device)
    cols = torch.arange(w, device=frames.device)
    interior = (((rows >= 1) & (rows <= h - 2))[:, None]
                & ((cols >= 1) & (cols <= w - 2))[None, :])
    return torch.where(interior, mag, 0).to(torch.uint8)


def _reversed_cummax(x, dim):
    return torch.cummax(x.flip(dim), dim).values.flip(dim)


def component_minima(fg):
    """4-connected components of the (N, H, W) bool mask ``fg``: int64, each
    foreground pixel its component's least raster index ``y * W + x``, the
    background ``H * W``.

    Each round min-propagates along every foreground run of every row and
    column, both ways, with one ``cummax`` a direction over the key
    ``run_id << vbits | (vmask - label)``; rounds repeat until one changes
    nothing.
    """
    n, h, w = fg.shape
    big = h * w
    vbits = big.bit_length()
    vmask = (1 << vbits) - 1
    bg = ~fg
    idx = torch.arange(big, device=fg.device, dtype=torch.int64).view(1, h, w)
    labels = torch.where(fg, idx, big)
    no_col = torch.zeros((n, h, 1), dtype=torch.bool, device=fg.device)
    no_row = torch.zeros((n, 1, w), dtype=torch.bool, device=fg.device)
    fg_left = torch.cat([no_col, fg[:, :, :-1]], 2)
    fg_right = torch.cat([fg[:, :, 1:], no_col], 2)
    fg_top = torch.cat([no_row, fg[:, :-1]], 1)
    fg_bottom = torch.cat([fg[:, 1:], no_row], 1)

    def run_ids(starts, dim, reverse):
        s = starts.to(torch.int64)
        if reverse:
            return torch.cumsum(s.flip(dim), dim).flip(dim)
        return torch.cumsum(s, dim)

    scans = [(dim, reverse, run_ids(fg & ~before, dim, reverse) << vbits)
             for dim, reverse, before in ((2, False, fg_left), (2, True, fg_right),
                                          (1, False, fg_top), (1, True, fg_bottom))]
    while True:
        out = labels
        for dim, reverse, rid in scans:
            key = rid | (vmask - out)
            m = _reversed_cummax(key, dim) if reverse else torch.cummax(key, dim).values
            out = torch.minimum(out, torch.where(bg, big, vmask - (m & vmask)))
        if torch.equal(out, labels):
            return labels
        labels = out


def _warp_grid(n, device, dtype):
    """``i / (n - 1)``, one IEEE division an element (the divisor a tensor)."""
    num = torch.arange(n, dtype=dtype, device=device)
    return num / torch.full_like(num, float(n - 1))


def _clamp_coord(v, hi):
    v = torch.where(v > hi, hi, v)
    return torch.where(v >= 0, v, 0.0)


def quad_warp(src, corners, size, dtype=torch.float32):
    """``gs_perspective_correct``: the bilinear quad warp of (N, sh, sw) uint8
    frames to (N, dh, dw) pages by (N, 4, 2) int32 corners (TL, TR, BR, BL)."""
    n, sh, sw = src.shape
    dh, dw = size
    dev = src.device
    u = _warp_grid(dw, dev, dtype).view(1, 1, dw)
    v = _warp_grid(dh, dev, dtype).view(1, dh, 1)
    c = corners.to(dtype).view(n, 4, 2, 1, 1)

    def edge(p0, p1, t):
        return p0 * (1.0 - t) + p1 * t

    def less_one(size):
        return float(torch.tensor(float(size), dtype=dtype) - 1.0)

    top_x, top_y = edge(c[:, 0, 0], c[:, 1, 0], u), edge(c[:, 0, 1], c[:, 1, 1], u)
    bot_x, bot_y = edge(c[:, 3, 0], c[:, 2, 0], u), edge(c[:, 3, 1], c[:, 2, 1], u)
    src_x = _clamp_coord(edge(top_x, bot_x, v), less_one(sw))
    src_y = _clamp_coord(edge(top_y, bot_y, v), less_one(sh))
    x0 = src_x.to(torch.int64)
    y0 = src_y.to(torch.int64)
    x1 = (x0 + 1).clamp(max=sw - 1)
    y1 = (y0 + 1).clamp(max=sh - 1)
    dx = src_x - x0.to(dtype)
    dy = src_y - y0.to(dtype)
    x0r, y0r = x0.clamp(max=sw - 1), y0.clamp(max=sh - 1)
    flat = src.reshape(n, sh * sw)

    def sample(yi, xi):
        return flat.gather(1, (yi * sw + xi).view(n, dh * dw)).view(n, dh, dw).to(dtype)

    t1 = (sample(y0r, x0r) * (1.0 - dx)) * (1.0 - dy)
    t2 = (sample(y0r, x1) * dx) * (1.0 - dy)
    t3 = (sample(y1, x0r) * (1.0 - dx)) * dy
    t4 = (sample(y1, x1) * dx) * dy
    return (((t1 + t2) + t3) + t4).to(torch.uint8)
