"""Halo exchange between the H-shards of one frame batch.

The shards of one data row are a list of ``(..., h_loc, W)`` tensors in space
order, each on its own device.  A stencil of radius ``r`` needs ``r`` rows from
each neighbour; the frame's top and bottom get zeros, which composes exactly
with the reference's clipped-window and zero-pad borders (the counts and
interior masks are taken at global rows).  A neighbour's rows move with
``.to(device, non_blocking=True)``, which is a no-op on a repeated device.
"""

from __future__ import annotations

import torch

__all__ = ["bottom_halo", "exchange_halo"]


def _rows_zero(x: torch.Tensor, rows: int) -> torch.Tensor:
    return x.new_zeros((*x.shape[:-2], rows, x.shape[-1]))


def exchange_halo(shards, halo: int) -> list[torch.Tensor]:
    """Each shard extended by ``halo`` rows from its neighbours, zeros at the
    frame's top and bottom: ``(..., h_loc + 2*halo, W)`` each.

    ``halo`` may not exceed a shard's height (``grayskull_tpu``'s version
    builds a wrong shape there; :func:`bottom_halo` takes several hops).
    """
    shards = list(shards)
    halo = int(halo)
    if halo == 0:
        return shards
    h_loc = shards[0].shape[-2]
    if not 0 < halo <= h_loc:
        raise ValueError(f"exchange_halo: halo {halo} must be in 1 .. {h_loc}, the shard height")
    out = []
    for i, x in enumerate(shards):
        top = (shards[i - 1][..., -halo:, :].to(x.device, non_blocking=True) if i > 0
               else _rows_zero(x, halo))
        bottom = (shards[i + 1][..., :halo, :].to(x.device, non_blocking=True)
                  if i + 1 < len(shards) else _rows_zero(x, halo))
        out.append(torch.cat([top, x, bottom], dim=-2))
    return out


def bottom_halo(shards, halo: int) -> list[torch.Tensor]:
    """Each shard extended by ``halo`` rows from the shards below it:
    ``(..., h_loc + halo, W)``, zero past the frame's bottom.

    The halo may exceed the shard height: whole blocks of the next
    ``ceil(halo / h_loc)`` shards are fetched and the extension cut to ``halo`` rows.
    """
    shards = list(shards)
    halo = int(halo)
    if halo < 0:
        raise ValueError(f"bottom_halo: halo must be >= 0, got {halo}")
    if halo == 0:
        return shards
    h_loc = shards[0].shape[-2]
    hops = -(-halo // h_loc)
    out = []
    for i, x in enumerate(shards):
        parts = [x]
        for k in range(1, hops + 1):
            parts.append(shards[i + k].to(x.device, non_blocking=True) if i + k < len(shards)
                         else torch.zeros_like(x))
        out.append(torch.cat(parts, dim=-2)[..., : h_loc + halo, :])
    return out
