"""3-vector helpers of the plain reference, on ``(N, 3)`` tensors in any
float dtype (float32, or bfloat16 for the control)."""

from __future__ import annotations

import math

import torch


def dot(a, b):
    p = a * b
    return p[:, 0] + p[:, 1] + p[:, 2]


def cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def length(a):
    return torch.sqrt(dot(a, a))


def normalize(a):
    """``a / |a|``; a zero vector stays zero."""
    n = length(a)[:, None]
    return torch.where(n > 0, a / torch.where(n > 0, n, torch.ones_like(n)), a)


def finite(a):
    """Non-finite entries become 0 (the estimator's guard on grazing GGX math)."""
    return torch.where(torch.isfinite(a), a, torch.zeros_like(a))


def luminance(rgb):
    """Rec. 709 luminance."""
    return 0.2126 * rgb[:, 0] + 0.7152 * rgb[:, 1] + 0.0722 * rgb[:, 2]


def axis(like, k: int):
    """The unit vector along axis ``k``, ``(1, 3)`` in the dtype of ``like``."""
    e = torch.zeros((1, 3), dtype=like.dtype, device=like.device)
    e[0, k] = 1.0
    return e


def tangent_frame(n):
    """``(tangent, bitangent)`` about the normal ``n``: up is +Y unless
    ``|n.y| > 0.999``, then +X."""
    up = torch.where((torch.abs(n[:, 1]) > 0.999)[:, None], axis(n, 0), axis(n, 1))
    t = normalize(cross(up, n))
    return t, cross(n, t)


def cosine_hemisphere(n, r1, r2):
    """Cosine-weighted direction about ``n`` from the uniforms ``r1, r2``."""
    phi = 2.0 * math.pi * r1
    cos_t = torch.sqrt(r2)
    sin_t = torch.sqrt(1.0 - cos_t * cos_t)
    t, b = tangent_frame(n)
    return normalize(t * (sin_t * torch.cos(phi))[:, None] + b * (sin_t * torch.sin(phi))[:, None]
                     + n * cos_t[:, None])
