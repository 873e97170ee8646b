"""Template matching — ``gs_match_template`` / ``gs_find_best_match``
(grayskull.h:701-738), bit-exact with ``grayskull_tpu.ops.template``.

The score map is K19 ``match_template`` (a CUDA tensor) or its plain version
(a CPU tensor): the sum of squared differences of every placement, exact in
uint32 for templates of at most 66,051 pixels, scored
``255 - ssd // (255 * th * tw)``.  A batch is one launch.
"""

from __future__ import annotations

import torch

from ..core import as_image, as_tensor
from ..kernels import template as _k

__all__ = ["find_best_match", "match_template"]


def match_template(img, tmpl) -> torch.Tensor:
    """SSD template match, normalized so 255 = perfect — ``gs_match_template``.

    ``img`` is one ``(H, W)`` frame or an ``(N, H, W)`` batch, ``tmpl`` an
    ``(th, tw)`` uint8 template (moved to the frames' device).  Returns uint8
    ``(..., H - th + 1, W - tw + 1)``.  Raises ``ValueError`` for a template
    larger than the frame or of more than 66,051 pixels (K19's wrapper checks).
    """
    img = as_image(img)
    tmpl = as_image(tmpl)
    single = img.ndim == 2
    frames = (img[None] if single else img).contiguous()
    out = _k.match_template(frames, tmpl.to(frames.device, non_blocking=True).contiguous())
    return out[0] if single else out


def find_best_match(result):
    """Argmax scan, first-occurrence tie-break — ``gs_find_best_match``
    (grayskull.h:725-738).  Returns ``(x, y)`` int32 tensors, scalars for one
    map and batched over any leading axes.

    The reference's strict ``>`` update means an all-zero map gives (0, 0).
    ``torch.argmax`` returns the first maximal index on every device.
    """
    result = as_tensor(result)
    w = result.shape[-1]
    idx = result.reshape(*result.shape[:-2], -1).argmax(-1)
    return (idx % w).to(torch.int32), (idx // w).to(torch.int32)
