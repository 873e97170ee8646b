"""The comparison that decides ``correct``.

Once the window has closed, the plain reference runs on the pool slices of
the batches the window's reservoir kept, and every output is compared
exactly:

* the small result of *every* batch of the window that ran one of those
  slices, as it reached the host (``<result>_frames_wrong``: frames whose
  result differs);
* each whole output of the kept batches, as the port returned it
  (``<output>_wrong``: elements that differ; an output of the wrong shape,
  or missing, counts every element).

Each count is held to the limit that the configuration states for it.
"""

from __future__ import annotations


def _wrong_elements(got, want) -> int:
    if got is None or tuple(got.shape) != tuple(want.shape):
        return want.numel()
    return int((got != want.to(got.device)).sum())


def _wrong_rows(got, want) -> int:
    if got is None or tuple(got.shape) != tuple(want.shape):
        return want.shape[0]
    return int((got != want).reshape(want.shape[0], -1).any(1).sum())


def compare(window, pool, batch, reference, result_key):
    """Counts by name and the set of wrong batches. ``reference(frames)``
    gives the expected outputs of one slice."""
    counts, wrong_batches = {}, set()
    slices = sorted({window.pool_index[i] for i, _ in window.kept})
    checked = 0
    for b in slices:
        want = reference(pool[b * batch:(b + 1) * batch])
        small = want[result_key].cpu()
        name = f"{result_key}_frames_wrong"
        for i, got in enumerate(window.results):
            if window.pool_index[i] == b:
                n = _wrong_rows(got, small)
                counts[name] = counts.get(name, 0) + n
                checked += 1
                if n:
                    wrong_batches.add(i)
        for i, outs in window.kept:
            if window.pool_index[i] != b:
                continue
            for key, value in want.items():
                name = f"{key}_wrong"
                n = _wrong_elements(outs.get(key), value)
                counts[name] = counts.get(name, 0) + n
                if n:
                    wrong_batches.add(i)
        del want
    return counts, wrong_batches, checked


def verdict(counts, limits):
    """``(correct, checks)``: each compared number beside its limit.  A number
    without a limit, or a limit without a number, is not correct."""
    checks = {name: {"value": counts.get(name), "limit": limits.get(name)}
              for name in sorted(set(counts) | set(limits))}
    correct = all(c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    return correct, checks

