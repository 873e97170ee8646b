"""Plain reference of ``lbp_faces_vga``: ``gs_integral`` then ``gs_lbp_detect``
(``grayskull.h:740-835``) over the scale ladder, in plain PyTorch on the
frames' device (nothing of the port; the cascade read as data by
``portbench/cascades.py``).

For each scale of the ladder (``scale`` from ``min_scale``, times
``scale_factor`` in float32 while ``scale <= max_scale`` and the window
``(int)(24 * scale)`` fits) every window at stride ``step`` runs the
cascade as ``gs_lbp_window`` does:

* a weak classifier's feature is scaled by a float32 multiply with C's
  truncation (width and height at least 1); its nine blocks are rect sums of
  the uint32 integral (``D + A - B - C`` with the edge guards: a padded
  leading zero row and column);
* the 8-bit MB-LBP code sets bit 7, 6, 5, 4, 3, 2, 1, 0 for the TL, TC, TR,
  R, BR, BC, BL, L block at least the centre's sum; the subset test is bit
  ``code % 32`` of word ``code / 32`` of the weak's subset words: set gives
  the left leaf value, clear the right;
* a stage's float32 sum adds its leaves in weak order from 0; a window whose
  sum is below the stage's threshold is rejected.

The windows are scored in blocks that bound memory, and after each stage
only the windows still alive go on: C leaves a window at its first failed
stage, so this changes no result.  The first ``max_rects`` accepted windows of
each frame in (scale, y, x) order are its rects (x, y, w, h), the rows past
``n`` zero.  A feature that reached past its window would read zeros past the
frame (the JAX package's guard); the bundled cascade has none.

``control=True`` takes the leaf values and the stage sums in bfloat16, the
next precision below the float32 that the configuration states.
"""

from __future__ import annotations

import torch

from portbench import cascades

_WINDOWS = 1 << 22  # windows a step: bounds the gathered corners, 16 int64 each
_U32 = 0xFFFFFFFF
# the 3 x 3 blocks row by row (TL TC TR / L C R / BL BC BR) -> the code's bit
_BIT_OF_BLOCK = (7, 6, 5, 0, None, 4, 1, 2, 3)


def ladder(window_w, window_h, h, w, params):
    """``[(scale, win_w, win_h)]``: the float32 scale ladder of scales whose
    window fits an (h, w) frame."""
    f32 = torch.float32
    scale = torch.tensor(float(params["min_scale"]), dtype=f32)
    factor = torch.tensor(float(params["scale_factor"]), dtype=f32)
    top = torch.tensor(float(params["max_scale"]), dtype=f32)
    out = []
    while scale <= top:
        win_w = int(torch.tensor(float(window_w), dtype=f32) * scale)
        win_h = int(torch.tensor(float(window_h), dtype=f32) * scale)
        if win_w > w or win_h > h:
            break
        out.append((scale, win_w, win_h))
        scale = scale * factor
    return out


def _scaled_weaks(cascade, scale):
    """Per weak classifier its feature's (fx, fy, fw, fh) at ``scale``: lists."""
    feats = torch.as_tensor(cascade["features"]).to(torch.float32) * scale
    feats = feats.to(torch.int32)  # C's truncation of the float32 product
    feats[:, 2:] = feats[:, 2:].clamp(min=1)
    return feats[torch.as_tensor(cascade["weak_feature_idx"]).to(torch.int64)].tolist()


def detect(frames, cascade, params, control=False):
    """``{"n": (N,) int32, "rects": (N, max_rects, 4) int32}`` of (N, H, W)
    uint8 ``frames`` under ``cascade`` (a dict of numpy arrays, as
    ``portbench/cascades.py`` gives)."""
    dev = frames.device
    n, h, w = frames.shape
    step, cap = int(params["step"]), int(params["max_rects"])
    acc = torch.bfloat16 if control else torch.float32

    def field(name, dtype):
        return torch.as_tensor(cascade[name]).to(dtype)

    left = field("weak_left_val", torch.float32).to(dev, acc)
    right = field("weak_right_val", torch.float32).to(dev, acc)
    thresholds = field("stage_threshold", torch.float32).tolist()
    words = field("subsets", torch.int64).to(dev)  # int32 words, sign-extended: bits 0..31 kept
    word_at = field("weak_subset_offset", torch.int64).tolist()
    stages = list(zip(field("stage_weak_start", torch.int64).tolist(),
                      field("stage_nweaks", torch.int64).tolist()))
    weights = torch.tensor([0 if b is None else 1 << b for b in _BIT_OF_BLOCK],
                           dtype=torch.int64, device=dev)

    plan = []
    for scale, win_w, win_h in ladder(int(cascade["window_w"]), int(cascade["window_h"]),
                                      h, w, params):
        plan.append((_scaled_weaks(cascade, scale), win_w, win_h,
                     (h - win_h) // step + 1, (w - win_w) // step + 1))
    # the padded integral: a zero row and column in front, zeros past the frame
    reach_y = max([max(fy + 3 * fh for _, fy, _, fh in g) - wh for g, _, wh, _, _ in plan] + [0])
    reach_x = max([max(fx + 3 * fw for fx, _, fw, _ in g) - ww for g, ww, _, _, _ in plan] + [0])
    hp, wp = h + 1 + reach_y, w + 1 + reach_x
    ii = torch.zeros((n, hp, wp), dtype=torch.int64, device=dev)
    ii[:, 1:h + 1, 1:w + 1] = frames.to(torch.int64).cumsum(2).cumsum(1)
    flat = ii.view(-1)

    found = []  # per block and scale: (frame, index in the frame's ladder order, rects)
    first = 0  # the scale's first window in ladder order
    for geo, win_w, win_h, ny, nx in plan:
        grid = ny * nx
        corners = [torch.tensor([(fy + bj * fh) * wp + fx + bi * fw
                                 for bj in range(4) for bi in range(4)], device=dev)
                   for fx, fy, fw, fh in geo]
        per_step = max(1, _WINDOWS // grid)
        for f0 in range(0, n, per_step):
            ids = torch.arange(f0 * grid, min(n, f0 + per_step) * grid, device=dev)
            frame, local = ids // grid, ids % grid
            base = frame * (hp * wp) + local // nx * step * wp + local % nx * step
            for (k0, nk), threshold in zip(stages, thresholds):
                total = torch.zeros(ids.shape, dtype=acc, device=dev)
                for k in range(k0, k0 + nk):
                    c = flat[base[:, None] + corners[k]].view(-1, 4, 4)
                    sums = (c[:, 1:, 1:] - c[:, :-1, 1:] - c[:, 1:, :-1] + c[:, :-1, :-1]) & _U32
                    sums = sums.reshape(-1, 9)
                    code = ((sums >= sums[:, 4:5]).to(torch.int64) * weights).sum(1)
                    bit = (words[word_at[k] + (code >> 5)] >> (code & 31)) & 1
                    total = total + torch.where(bit == 1, left[k], right[k])
                alive = total.to(torch.float32) >= threshold
                ids, base = ids[alive], base[alive]
                if not len(ids):
                    break
            frame, local = ids // grid, ids % grid
            rects = torch.stack([local % nx * step, local // nx * step,
                                 torch.full_like(local, win_w), torch.full_like(local, win_h)], 1)
            found.append((frame, first + local, rects))
        first += grid

    rects = torch.zeros((n, cap, 4), dtype=torch.int32, device=dev)
    count = torch.zeros(n, dtype=torch.int64, device=dev)
    if found:
        frame, index, fields = (torch.cat(v) for v in zip(*found))
        order = torch.argsort(frame * first + index)
        frame, fields = frame[order], fields[order]
        count = torch.bincount(frame, minlength=n)
        rank = torch.arange(len(frame), device=dev) - (count.cumsum(0) - count)[frame]
        kept = rank < cap
        rects[frame[kept], rank[kept]] = fields[kept].to(torch.int32)
    return {"n": count.clamp(max=cap).to(torch.int32), "rects": rects}


def reference(frames, params, control=False):
    """The outputs of ``detect_faces`` with the bundled frontal-face cascade."""
    return detect(frames, cascades.frontalface(), params, control)
