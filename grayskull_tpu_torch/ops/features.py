"""FAST-9 corners, ORB (oriented rBRIEF) descriptors and Hamming matching —
``gs_fast`` / ``gs_compute_orientation`` / ``gs_brief_descriptor`` /
``gs_orb_extract`` / ``gs_match_orb`` (grayskull.h:482-699), bit-exact with
``grayskull_tpu.ops.features`` in the same trig mode (``libm32``).

* FAST: K6 (``kernels.fast``) writes the packed key map; the first ``cap``
  corners in raster order are the ``cap`` largest keys, which ``torch.topk``
  returns sorted (the JAX package's scheme, ``features.py:315-359``).
* ORB selection: the candidates' ``response << 13 | inverse_rank`` keys and one
  ``torch.topk`` give the stable response-descending order with the border
  filter, as ``_select_candidates_approx`` does; it equals the reference's
  stable sort (``_select_candidates_sort``).
* Orientation and rBRIEF: K7 and K8 (``kernels.patches``) read each keypoint's
  window from the frame; ``atan2f``, ``sinf`` and the reference's
  ``sinf(a + 1.57079f)`` cosine run between them in
  ``libm32.orientation_trig`` (in the ``freestanding`` mode one K21 launch
  from K7's int32 moments).
* Matching: XOR and a SWAR popcount over int64 words, then the reference's
  best / second-best bookkeeping as masked reductions (plain PyTorch, as the
  JAX package leaves it to XLA).

Every op takes one ``(H, W)`` frame or, where the JAX op does, an ``(N, H, W)``
batch, on any device, with no host sync outside the ``exact_host`` trig mode.
``force_reference=True`` runs the kernels' plain versions on the input's device,
the freestanding trig's too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import Keypoints, Matches, as_image, as_tensor
from ..kernels.fast import fast as fast_kernel
from ..kernels.fast import fast_plain
from ..kernels.integral import u32_to_int64
from ..kernels.patches import (BRIEF_PATTERN, orb_brief, orb_brief_plain, orb_moments,
                               orb_moments_plain)
from ..libm32 import atan2f, cosf_like_reference, orientation_trig, sinf

__all__ = ["BRIEF_PATTERN", "brief_descriptor", "compute_orientation", "fast", "fast_scoremap",
           "hamming_distance", "match_orb", "orb_extract"]

ORB_RADIUS = 15          # the orientation disc and the border filter (grayskull.h:655-661)
_MAX_CANDIDATES = 5000   # gs_orb_extract's candidate budget cap (grayskull.h:653)


def _frames(img) -> tuple[torch.Tensor, bool]:
    img = as_image(img)
    single = img.ndim == 2
    return (img[None] if single else img).contiguous(), single


def _unbatch(table, single: bool):
    return type(table)(*(v[0] for v in table)) if single else table


def _rank_scatter(mask: torch.Tensor, cap: int, values):
    """Rows of ``values`` (each (B, L, ...)) where the (B, L) ``mask`` is set, in
    order, into (B, cap, ...) tables padded with 0; returns (n (B,) int32, tables)."""
    rank = torch.cumsum(mask, dim=1) - 1
    dst = torch.where(mask & (rank < cap), rank, cap)
    out = []
    for v in values:
        idx = dst.view(dst.shape + (1,) * (v.ndim - 2)).expand(v.shape)
        buf = torch.zeros((v.shape[0], cap + 1) + v.shape[2:], dtype=v.dtype, device=v.device)
        out.append(buf.scatter_(1, idx, v)[:, :cap])
    n = torch.clamp(mask.sum(dim=1), max=cap).to(torch.int32)
    return n, out


def _emit(key: torch.Tensor, cap: int, h: int, w: int):
    """(B, h*w) packed keys -> (n, x, y, response): the first ``cap`` corners of
    each frame in raster order, int32, rows past ``n`` 0."""
    k = min(cap, key.shape[1])
    vals = torch.topk(key, k, dim=1, sorted=True).values
    if cap > k:
        vals = torch.nn.functional.pad(vals, (0, cap - k))
    ok = vals > 0
    ridx = torch.where(ok, h * w - (vals >> 8), 0)
    fields = (ridx % w, ridx // w, vals & 255)
    return ok.sum(dim=1, dtype=torch.int32), *(torch.where(ok, v, 0).to(torch.int32)
                                               for v in fields)


def fast_scoremap(img, threshold) -> torch.Tensor:
    """Dense FAST-9 score map (pass 1 of ``gs_fast``, grayskull.h:489-515), uint8,
    with the 3-pixel border 0."""
    frames, single = _frames(img)
    score, _ = fast_kernel(frames, threshold, want_score=True)
    return score[0] if single else score


def fast(img, max_kps: int, threshold, force_reference: bool = False):
    """FAST-9 with 3x3 NMS — ``gs_fast`` (grayskull.h:482-534).

    Returns ``(Keypoints, score map)``: up to ``max_kps`` corners in raster-scan
    order (angle and descriptor 0).  A batch gives batched tables.
    """
    frames, single = _frames(img)
    b, h, w = frames.shape
    cap = int(max_kps)
    score, key = (fast_plain if force_reference else fast_kernel)(frames, threshold,
                                                                  want_score=True)
    n, x, y, r = _emit(key.view(b, -1), cap, h, w)
    kps = Keypoints(n, x, y, r, torch.zeros((b, cap), dtype=torch.float32, device=frames.device),
                    torch.zeros((b, cap, 8), dtype=torch.int32, device=frames.device)
                    .view(torch.uint32))
    return _unbatch(kps, single), (score[0] if single else score)


def _select_candidates(x, y, resp, valid, cap: int, radius: int, h: int, w: int):
    """``gs_orb_extract``'s selection over (B, cand) candidate tables: stable
    descending response order, border filter, the first ``cap`` — one
    ``torch.topk`` over ``response << 13 | inverse_rank`` keys (the rank field
    holds the 5,000-candidate budget)."""
    cand = x.shape[1]
    border_ok = (x >= radius) & (y >= radius) & (x < w - radius) & (y < h - radius)
    inv = cand - torch.arange(cand, dtype=torch.int32, device=x.device)
    packed = torch.where(valid & border_ok, (resp << 13) | inv, 0)
    k = min(cap, cand)
    vals, idx = torch.topk(packed, k, dim=1, sorted=True)
    if cap > k:
        vals = torch.nn.functional.pad(vals, (0, cap - k))
        idx = torch.nn.functional.pad(idx, (0, cap - k))
    ok = vals > 0
    return (ok.sum(dim=1, dtype=torch.int32),
            *(torch.where(ok, v.gather(1, idx), 0) for v in (x, y, resp)))


def _limits(limit, b: int, device) -> torch.Tensor:
    """``limit`` as a (B,) int32 tensor; a number is filled in on the device, not copied."""
    if isinstance(limit, torch.Tensor):
        return limit.to(device=device, dtype=torch.int32).expand(b)
    return torch.full((b,), int(limit), dtype=torch.int32, device=device)


def _orb_select(frames, cap: int, threshold, limit, run_fast):
    """FAST candidates -> selection -> (n, x, y, response), each frame's count
    capped by its ``limit`` (a (B,) tensor, no host sync)."""
    b, h, w = frames.shape
    cand = min(cap * 4, _MAX_CANDIDATES)
    _, key = run_fast(frames, threshold)
    n_cand, x, y, r = _emit(key.view(b, -1), cand, h, w)
    if limit is not None:
        lim = _limits(limit, b, frames.device)
        n_cand = torch.minimum(n_cand, torch.clamp(lim * 4, max=_MAX_CANDIDATES))
    valid = torch.arange(cand, device=frames.device)[None, :] < n_cand[:, None]
    n, x, y, r = _select_candidates(x, y, r, valid, cap, ORB_RADIUS, h, w)
    if limit is not None:
        n = torch.minimum(n, torch.clamp(lim, max=cap))
        ok = torch.arange(cap, device=frames.device)[None, :] < n[:, None]
        x, y, r = (torch.where(ok, v, 0) for v in (x, y, r))
    return n, x, y, r


def orb_extract(img, max_kps: int, threshold, limit=None,
                force_reference: bool = False) -> Keypoints:
    """Full ORB extraction — ``gs_orb_extract`` (grayskull.h:651-669).

    ``img`` is (H, W) or a batch (N, H, W).  FAST with a ``min(4 * max_kps,
    5000)`` candidate budget, the stable response sort and radius-15 border
    filter, then orientation (K7 + ``atan2f``) and rBRIEF (K8) for the first
    ``max_kps``.  ``limit`` (None, a scalar or an (N,) tensor) caps each frame's
    count below ``max_kps`` and its candidate budget at ``min(4 * limit,
    5000)``, as a C caller passing a smaller count would get.
    """
    frames, single = _frames(img)
    b, h, w = frames.shape
    cap = int(max_kps)
    if force_reference:
        run_fast, moments, brief = fast_plain, orb_moments_plain, orb_brief_plain
    else:
        run_fast, moments, brief = fast_kernel, orb_moments, orb_brief
    n, x, y, r = _orb_select(frames, cap, threshold, limit, run_fast)
    # every row gets an angle and a descriptor; rows past n clamp into the frame
    sx = torch.clamp(x, ORB_RADIUS, w - ORB_RADIUS - 1)
    sy = torch.clamp(y, ORB_RADIUS, h - ORB_RADIUS - 1)
    m01, m10 = moments(frames, sx, sy, ORB_RADIUS)
    # force_reference also keeps the freestanding trig plain (not K21)
    angle, sin, cos = orientation_trig(m01, m10, force_reference)
    desc = brief(frames, sx, sy, sin, cos)
    ok = torch.arange(cap, device=frames.device)[None, :] < n[:, None]
    angle = torch.where(ok, angle, 0.0)
    desc = torch.where(ok[..., None], desc.view(torch.int32), 0).view(torch.uint32)
    return _unbatch(Keypoints(n, x, y, r, angle, desc), single)


def _points(img, x, y):
    frame = as_image(img)
    if frame.ndim != 2:
        raise ValueError(f"expected one (H, W) frame, got {tuple(frame.shape)}")
    xs = torch.as_tensor(x, dtype=torch.int32, device=frame.device)
    ys = torch.as_tensor(y, dtype=torch.int32, device=frame.device)
    return frame.contiguous()[None], xs.reshape(1, -1).contiguous(), ys.reshape(1, -1).contiguous()


def compute_orientation(img, x, y, radius: int = 15) -> torch.Tensor:
    """Intensity-centroid orientation — ``gs_compute_orientation``
    (grayskull.h:608-621): ``atan2f(m01, m10)`` over the radius disc.

    ``x, y`` are scalars or arrays of the same shape; the result has their shape.
    Keypoints should be ``radius`` from the border (the C contract); nearer
    ones read 0 outside the frame, as ``orb_extract``'s patches do.
    """
    frames, xs, ys = _points(img, x, y)
    m01, m10 = orb_moments(frames, xs, ys, radius)
    shape = torch.as_tensor(x).shape
    return atan2f(m01.to(torch.float32), m10.to(torch.float32)).view(shape)


def brief_descriptor(img, x, y, angle) -> torch.Tensor:
    """Rotated BRIEF descriptor(s) — ``gs_brief_descriptor`` (grayskull.h:623-637).

    (8,) ``torch.uint32`` for scalars, (K, 8) for arrays.  Samples outside the
    frame read 0 (``gs_get``), so keypoints outside the frame are exact too.
    """
    frames, xs, ys = _points(img, x, y)
    a = torch.as_tensor(angle, dtype=torch.float32, device=frames.device).reshape(1, -1)
    desc = orb_brief(frames, xs, ys, sinf(a).contiguous(), cosf_like_reference(a).contiguous())
    return desc[0, 0] if torch.as_tensor(x).ndim == 0 else desc[0]


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in [0, 2^32), SWAR."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def _descriptors(d) -> torch.Tensor:
    if isinstance(d, np.ndarray):
        d = as_tensor(np.ascontiguousarray(d, np.uint32))
    return u32_to_int64(d)


def hamming_distance(desc1, desc2) -> torch.Tensor:
    """Pairwise 256-bit Hamming distances — ``gs_hamming_distance``
    (grayskull.h:671-678).  (n1, 8) x (n2, 8) uint32 -> (n1, n2) int32."""
    a, b = _descriptors(desc1), _descriptors(desc2)
    dist = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int64, device=a.device)
    for j in range(a.shape[1]):  # word by word: one (n1, n2) int64 map live at a time
        dist += _popcount32(a[:, None, j] ^ b[None, :, j])
    return dist.to(torch.int32)


def _best_matches(desc1, rows, n1, desc2, n2, max_distance):
    """``gs_match_orb``'s per-query bookkeeping for the query descriptors ``desc1``,
    whose indices in the whole query table are ``rows`` (int32), against every
    target: (accepted, best target index int32, best distance int32), each
    aligned with ``rows``.  ``n1`` and ``n2`` are the tables' valid counts."""
    dev = desc1.device
    # float32 constants as Python floats: exact, and no host-to-device copy (a sync)
    maxd = np.float32(max_distance)
    sent = float(maxd + np.float32(1.0))
    maxd, ratio, inf = float(maxd), float(np.float32(0.8)), float("inf")
    n2cap = desc2.shape[0]
    d = hamming_distance(desc1, desc2).to(torch.float32)
    dv = torch.where(torch.arange(n2cap, device=dev)[None, :] < n2, d, inf)
    b1, best_idx = dv.min(dim=1)  # the first of tied minima
    b2 = dv.scatter(1, best_idx[:, None], inf).min(dim=1).values
    best = b1.clamp(max=sent)
    second = torch.where(b1 <= sent, b2.clamp(max=sent), sent)
    accept = (best <= maxd) & (best < second * ratio)
    mask = accept & (rows < n1) & (b1 < inf)
    return mask, best_idx.to(torch.int32), best.to(torch.int32)


def match_orb(kps1: Keypoints, kps2: Keypoints, max_matches: int, max_distance) -> Matches:
    """Brute-force best / second-best matching with the Lowe ratio test —
    ``gs_match_orb`` (grayskull.h:680-699).

    Best and second start at ``max_distance + 1``; a match needs
    ``best <= max_distance && best < 0.8f * second``; the first best among tied
    distances wins.  One frame's tables on each side.
    """
    rows = torch.arange(kps1.descriptor.shape[0], dtype=torch.int32,
                        device=kps1.descriptor.device)
    mask, best_idx, best = _best_matches(kps1.descriptor, rows, kps1.n, kps2.descriptor, kps2.n,
                                         max_distance)
    n, (i1, i2, dist) = _rank_scatter(mask[None], int(max_matches),
                                      (rows[None], best_idx[None], best[None]))
    return Matches(n[0], i1[0], i2[0], dist[0])
