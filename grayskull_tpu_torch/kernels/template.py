"""The SSD template match, with its plain PyTorch version.

:func:`match_template` (K19, ``csrc/template.cu:gs_match_template``) replaces
the XLA function ``grayskull_tpu/ops/template.py:30 _match_template``, which
the TPU computes as a windowed sum of squares, four float32 convolutions of
4-bit halves and the sum of the template's squares.  The card computes the same
``ssd = win(I^2) - 2 corr(I, T) + sum(T^2)`` mod 2^32 (exact for templates of
at most 66,051 pixels), the correlation as a u8 x u8 -> s32 matrix product on
the int8 tensor cores, or, for templates narrower or wider than the tensor
cores' range, sums the squared differences directly; it scores each placement
``255 - ssd // (255 * th * tw)`` as ``gs_match_template`` does
(grayskull.h:701-723).  The source says which design takes which template.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
:func:`match_template_plain`.  ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from .. import profiling
from . import _build
from .preproc import _check_frames

__all__ = ["MAX_TEMPLATE_PIXELS", "launches", "match_template", "match_template_plain"]

launches = {"match_template": 0}

# the largest template whose SSD fits uint32: th * tw * 255^2 <= 2^32 - 1
MAX_TEMPLATE_PIXELS = (2**32 - 1) // (255 * 255)


def match_template_plain(imgs: torch.Tensor, tmpl: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`match_template`: the squared differences added
    up in int64, one template offset ``(i, j)`` at a time over every
    placement, then scored."""
    n, h, w = imgs.shape
    th, tw = tmpl.shape
    rh, rw = h - th + 1, w - tw + 1
    x = imgs.to(torch.int64)
    t = tmpl.to(torch.int64)
    ssd = torch.zeros((n, rh, rw), dtype=torch.int64, device=imgs.device)
    for i in range(th):
        rows = x[:, i:i + rh]
        for j in range(tw):
            ssd += (rows[:, :, j:j + rw] - t[i, j]).square()
    return (255 - ssd // (255 * th * tw)).to(torch.uint8)


@profiling.spanned("gs.kernels.match_template")
def match_template(imgs: torch.Tensor, tmpl: torch.Tensor) -> torch.Tensor:
    """K19: (N, H, W) uint8 frames and an (th, tw) uint8 template on the same
    device -> (N, H - th + 1, W - tw + 1) uint8 scores, 255 a perfect match."""
    _check_frames(imgs, "match_template")
    if not isinstance(tmpl, torch.Tensor):
        raise TypeError(f"match_template: expected a torch.Tensor template, got "
                        f"{type(tmpl).__name__}")
    n, h, w = imgs.shape
    if (tmpl.dtype != torch.uint8 or tmpl.ndim != 2 or min(tmpl.shape) < 1
            or tmpl.device != imgs.device or not tmpl.is_contiguous()):
        raise ValueError(f"match_template: the template must be a contiguous non-empty (th, tw) "
                         f"uint8 tensor on the frames' device, got {tuple(tmpl.shape)} "
                         f"{tmpl.dtype} on {tmpl.device}")
    th, tw = tmpl.shape
    if th > h or tw > w:
        raise ValueError(f"match_template: template {(th, tw)} larger than the frames {(h, w)}")
    if th * tw > MAX_TEMPLATE_PIXELS:
        raise ValueError(f"match_template: template has {th * tw} pixels; exact uint32 scoring "
                         f"supports up to {MAX_TEMPLATE_PIXELS}")
    if not imgs.is_cuda:
        return match_template_plain(imgs, tmpl)
    lib = _build.library()
    out = torch.empty((n, h - th + 1, w - tw + 1), dtype=torch.uint8, device=imgs.device)
    with torch.cuda.device(imgs.device):
        code = lib.gs_match_template(imgs.data_ptr(), tmpl.data_ptr(), out.data_ptr(), n, h, w,
                                     th, tw, _build.stream_of(imgs))
    _build.check(code, "match_template")
    launches["match_template"] += 1
    return out
