"""Otsu's threshold from per-frame histograms, with its plain PyTorch version.

:func:`otsu` (K3, ``csrc/otsu.cu:gs_otsu``) replaces the XLA sweep
``grayskull_tpu/ops/histogram.py:_otsu_from_hist``: one thread per frame replays
``gs_otsu_threshold``'s float32 sweep in C's order (sequential bin sums, the
``wb == 0`` continue, the ``wf == 0`` break before ``sumB`` is updated,
``((wb*wf)*d)*d`` and a strict first-max update), so thresholds are bit-exact.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
:func:`otsu_plain`.  ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["launches", "otsu", "otsu_plain"]

launches = {"otsu": 0}

_U32 = 0xFFFFFFFF


def otsu_plain(hist: torch.Tensor, total: int) -> torch.Tensor:
    """(N, 256) int32 counts -> (N,) uint8 thresholds, as a loop over the bins.

    Counts and weights wrap as uint32, as in C.  The float sum runs bin by bin:
    ``torch.cumsum`` does not promise an order for floats.  Each eager float
    operation rounds on its own.
    """
    counts = hist.to(torch.int64) & _U32
    terms = torch.arange(256, device=hist.device, dtype=torch.float32) * counts.to(torch.float32)
    total_sum = torch.zeros(hist.shape[0], device=hist.device, dtype=torch.float32)
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
        fb = wb.to(torch.float32)
        ff = wf.to(torch.float32)
        d = sum_b / fb - (total_sum - sum_b) / ff
        var = ((fb * ff) * d) * d
        better = active & (var > var_max)
        var_max = torch.where(better, var, var_max)
        thr = torch.where(better, t, thr)
        done = done | brk
    return thr.to(torch.uint8)


def otsu(hist: torch.Tensor, total: int) -> torch.Tensor:
    """K3: (N, 256) int32 histograms, ``total`` pixels per frame -> (N,) uint8."""
    if not isinstance(hist, torch.Tensor):
        raise TypeError(f"otsu: expected a torch.Tensor, got {type(hist).__name__}")
    if hist.dtype != torch.int32:
        raise TypeError(f"otsu: histograms must be torch.int32, got {hist.dtype}")
    if hist.ndim != 2 or hist.shape[1] != 256 or hist.shape[0] < 1:
        raise ValueError(f"otsu: expected (N, 256) histograms, got {tuple(hist.shape)}")
    if not hist.is_contiguous():
        raise ValueError("otsu: histograms must be contiguous")
    total = int(total)
    if not 0 <= total <= 2**31 - 1:
        raise ValueError(f"otsu: total must fit int32, got {total}")
    if not hist.is_cuda:
        return otsu_plain(hist, total)
    lib = _build.library()
    out = torch.empty(hist.shape[0], dtype=torch.uint8, device=hist.device)
    with torch.cuda.device(hist.device):
        code = lib.gs_otsu(hist.data_ptr(), out.data_ptr(), hist.shape[0], total,
                           _build.stream_of(hist))
    _build.check(code, "otsu")
    launches["otsu"] += 1
    return out
