"""The comparison that decides ``correct``: the framebuffer that the
measured window produced, at pixels drawn from the seed, against the plain
reference's radiance sums of the same samples.

Two numbers are compared, each with its limit from the cell's check file
(``ptbench/checks/<workload>.json``):

* ``l1_rel_err``: the summed absolute difference over the checked pixels
  and channels, over the reference's summed radiance. A path that parts
  from the reference's at a rounding knife edge (a ray that grazes an edge
  or a silhouette) moves it by its share of the image; it does not grow
  with the number of samples a pixel holds, since each parted sample's
  share shrinks as the count grows.
* ``median_rel_err``: the median over the checked pixels of that pixel's
  absolute difference over its radiance: the rounding level at which the
  two sides agree where no path parted.

The pixels are drawn over every frame of the configuration (framebuffer ids
``f * W * H + y * W + x``; one frame: exactly the draw over ``W * H``), and
both numbers are taken over all of them together. Where the frames are
rendered over ranks, the draw has to reach each rank's block of frames
(:func:`missed_blocks`).
"""

from __future__ import annotations

import torch

NUMBERS = ("l1_rel_err", "median_rel_err")


def pixel_sample(seed: int, num_pixels: int, count: int) -> torch.Tensor:
    """``count`` distinct pixel ids drawn from the seed, ascending."""
    g = torch.Generator().manual_seed(seed)
    return torch.sort(torch.randperm(num_pixels, generator=g)[:count]).values


def frame_blocks(frames: int, ranks: int) -> list:
    """Each rank's frames, by rank: contiguous blocks of ``ceil(F / ranks)``
    (the last may be short or empty), as frames lie over a ``dp = ranks``
    mesh."""
    per = -(-frames // ranks)
    return [range(d * per, min((d + 1) * per, frames)) for d in range(ranks)]


def missed_blocks(ids: torch.Tensor, frame_pixels: int, frames: int, ranks: int) -> list:
    """The ranks that render a frame of which no id in ``ids`` is a pixel."""
    hit = set((ids // frame_pixels).tolist())
    return [d for d, block in enumerate(frame_blocks(frames, ranks))
            if len(block) and not hit.intersection(block)]


def compare(program: torch.Tensor, reference: torch.Tensor) -> dict:
    """The compared numbers of program sums ``(P, 3)`` against reference
    sums ``(P, 3)`` (both taken to float64 on the CPU)."""
    p = program.detach().to("cpu", torch.float64)
    r = reference.detach().to("cpu", torch.float64)
    diff = (p - r).abs().sum(dim=1)
    level = r.abs().sum(dim=1)
    per_pixel = diff / torch.clamp_min(level, 1e-30)
    l1 = float(diff.sum() / torch.clamp_min(level.sum(), 1e-30))
    if not torch.isfinite(p).all():
        l1 = float("inf")
    return {"l1_rel_err": l1, "median_rel_err": float(per_pixel.median())}


def judge(numbers: dict, limits: dict) -> bool:
    """Every compared number at or under its limit (a NaN fails)."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)
