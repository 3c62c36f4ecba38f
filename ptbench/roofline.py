"""A kernel's share of its roofline over the traced passes: the summed least
time of its launches (counted in the replay of those passes, see
``harness.counting``) over its device time in the profiler's trace. Nothing
is read where the replay counted no launch, or counted another number of
launches than the trace holds (another instance or caller of the kernel)."""

from __future__ import annotations

import torch


def share(rec, name: str, pattern: str):
    t, w = rec["trace"], rec["work"].get(name)
    if t is None or not w or w.get("failed") or not w["launches"]:
        return None
    seconds, launches = t.kernel_seconds(pattern)
    if launches != w["launches"] or seconds <= 0:
        return None
    return 100.0 * w["least_s"] / seconds


def sphere_rows(sph) -> int:
    """Real rows of a sphere table (column 3, ``|c|^2 - r^2``, is NaN on padding)."""
    return int(torch.isfinite(sph[:, 3]).sum())


def triangle_rows(tri) -> int:
    """Real rows of a triangle table (padding rows have zero edges)."""
    return int((tri[:, 3:9] != 0).any(dim=1).sum())
