"""Pyramid ORB extraction and two-frame template tracking — ``extract_pyramid_orb_nm``
/ ``orb()`` (the C reference's ``examples/nanomagick/nanomagick.c:244-345``),
bit-exact with ``grayskull_tpu.pipelines.orb``.

Per level: halve with the 2x box downsample while both sides stay >= 32 (at
most 4 levels), extract ORB with the level's budget (an equal split; the last
level takes what the earlier levels left, per frame, as a tensor, so nothing
waits on the host), scale the coordinates back by ``2^level``, and concatenate
the levels' tables in level order.  On a CUDA tensor each level runs K6, K7 and
K8 once for the whole batch.
"""

from __future__ import annotations

import torch

from ..core import Keypoints, as_image
from ..ops.features import _rank_scatter, _unbatch, match_orb, orb_extract
from ..ops.pixel import downsample

__all__ = ["extract_pyramid_orb", "pyramid_levels", "track"]


def pyramid_levels(shape, n_levels: int = 3):
    """Static level plan: [(h, w), ...] halving while >= 32 px (nanomagick.c:255-264)."""
    n_levels = min(int(n_levels), 4)
    h, w = shape
    levels = [(h, w)]
    for _ in range(1, n_levels):
        h, w = h // 2, w // 2
        if h < 32 or w < 32:
            break
        levels.append((h, w))
    return levels


def extract_pyramid_orb(img, max_kps: int, threshold, n_levels: int = 3,
                        force_reference: bool = False) -> Keypoints:
    """Multi-scale ORB over a box-downsampled pyramid (nanomagick.c:245-290).

    ``img`` is (H, W) or a batch (N, H, W).  Returns a :class:`Keypoints` table
    of capacity ``max_kps`` per frame, coordinates in full-resolution pixels,
    the levels' keypoints in level order.
    """
    img = as_image(img)
    single = img.ndim == 2
    cur = (img[None] if single else img).contiguous()
    b = cur.shape[0]
    cap = int(max_kps)
    levels = pyramid_levels(cur.shape[-2:], n_levels)
    per_level = cap // len(levels)
    tables = []
    total = torch.zeros(b, dtype=torch.int32, device=cur.device)
    for lvl in range(len(levels)):
        if lvl > 0:
            cur = downsample(cur)
        if lvl == len(levels) - 1:
            budget = torch.clamp(cap - total, min=0)  # nanomagick.c:275-276
            t = orb_extract(cur, cap, threshold, limit=budget, force_reference=force_reference)
        elif per_level == 0:
            continue  # C skips a level whose budget is 0 (nanomagick.c:277)
        else:
            t = orb_extract(cur, per_level, threshold, force_reference=force_reference)
        tables.append(t._replace(x=t.x << lvl, y=t.y << lvl))
        total = total + t.n

    valid = torch.cat([torch.arange(t.x.shape[1], device=cur.device)[None, :] < t.n[:, None]
                       for t in tables], dim=1)
    fields = [torch.cat([getattr(t, f) for t in tables], dim=1)
              for f in ("x", "y", "response", "angle")]
    fields.append(torch.cat([t.descriptor.view(torch.int32) for t in tables], dim=1))
    n, (x, y, r, angle, desc) = _rank_scatter(valid, cap, fields)
    return _unbatch(Keypoints(n, x, y, r, angle, desc.view(torch.uint32)), single)


def track(template, scene, max_kps: int = 2500, threshold=20, max_matches: int = 300,
          max_distance=60.0, n_levels: int = 3, force_reference: bool = False):
    """Two-frame ORB template tracking — the compute core of ``nanomagick orb``
    (nanomagick.c:292-311).  Returns ``(template_kps, scene_kps, matches)``.

    Frames of one shape run as one batch-2 pyramid pass.
    """
    template, scene = as_image(template), as_image(scene)
    args = (max_kps, threshold, n_levels, force_reference)
    if template.shape == scene.shape:
        both = extract_pyramid_orb(torch.stack([template, scene]), *args)
        tk = Keypoints(*(v[0] for v in both))
        sk = Keypoints(*(v[1] for v in both))
    else:
        tk = extract_pyramid_orb(template, *args)
        sk = extract_pyramid_orb(scene, *args)
    return tk, sk, match_orb(tk, sk, max_matches, max_distance)
