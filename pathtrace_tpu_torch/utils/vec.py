"""Batched 3-vector math over ``(..., 3)`` tensors (the subset the pool path
uses; counterpart of ``pathtrace_tpu/utils/vec.py``, same op order)."""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis, summed left to right."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Divide by the length; zero vectors pass through unchanged."""
    ln = torch.sqrt(dot(a, a))[..., None]
    pos = ln > 0.0
    return torch.where(pos, a / torch.where(pos, ln, torch.ones_like(ln)), a)
