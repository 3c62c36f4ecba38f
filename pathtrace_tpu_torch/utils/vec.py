"""Batched 3-vector math over ``(..., 3)`` tensors (counterpart of
``pathtrace_tpu/utils/vec.py``, same op order). Branches of the reference
renderer (refraction's total internal reflection, the tangent frame's
up-vector fallback) are masks."""

from __future__ import annotations

import math

import torch

# Rec.709 luminance weights.
_LUM_R = 0.2126
_LUM_G = 0.7152
_LUM_B = 0.0722


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


def length_squared(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length_squared(a))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Divide by the length; zero vectors pass through unchanged."""
    ln = length(a)[..., None]
    pos = ln > 0.0
    return torch.where(pos, a / torch.where(pos, ln, torch.ones_like(ln)), a)


def normal_from_triangle(v0, v1, v2) -> torch.Tensor:
    """Geometric normal of a triangle: the normalized ``(v1-v0) x (v2-v0)``."""
    return normalize(cross(v1 - v0, v2 - v0))


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of an incident direction."""
    return incident - normal * (2.0 * dot(incident, normal))[..., None]


def refract(incident, normal, eta):
    """Snell refraction: ``(refracted, valid)``, ``valid`` False on total
    internal reflection. ``eta`` (the IOR ratio n1/n2) broadcasts against the
    batch."""
    eta = torch.as_tensor(eta, dtype=incident.dtype, device=incident.device)
    cos_i = -dot(incident, normal)
    # (1-c)(1+c) rather than 1-c^2: stable near normal incidence.
    sin2_t = eta * eta * ((1.0 - cos_i) * (1.0 + cos_i))
    valid = sin2_t <= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    refracted = incident * eta[..., None] + normal * (eta * cos_i - cos_t)[..., None]
    return refracted, valid


def face_forward(v: torch.Tensor, ray_direction: torch.Tensor) -> torch.Tensor:
    """Flip ``v`` so it opposes ``ray_direction``."""
    return torch.where(dot(v, ray_direction)[..., None] < 0.0, v, -v)


def tangent_frame(normal: torch.Tensor):
    """``(tangent, bitangent)`` of a frame whose z is the normal: up is +Y
    unless ``|n.y| > 0.999``, then +X."""
    ny = torch.abs(normal[..., 1]) > 0.999
    x_axis = normal.new_tensor([1.0, 0.0, 0.0])
    y_axis = normal.new_tensor([0.0, 1.0, 0.0])
    up = torch.where(ny[..., None], x_axis, y_axis)
    tangent = normalize(cross(up, normal))
    bitangent = cross(normal, tangent)
    return tangent, bitangent


def from_tangent_frame(normal, tangent, bitangent, x, y, z):
    """Lift local coordinates ``(x, y, z)`` (z along the normal) to world space."""
    return tangent * x[..., None] + bitangent * y[..., None] + normal * z[..., None]


def uniform_hemisphere_direction(normal, r1, r2):
    """Uniform-hemisphere sample about ``normal`` from uniforms ``r1, r2``."""
    phi = 2.0 * math.pi * r1
    cos_theta = r2
    sin_theta = torch.sqrt(1.0 - cos_theta * cos_theta)
    x = sin_theta * torch.cos(phi)
    y = sin_theta * torch.sin(phi)
    tangent, bitangent = tangent_frame(normal)
    return normalize(from_tangent_frame(normal, tangent, bitangent, x, y, cos_theta))


def cosine_hemisphere_direction(normal, r1, r2):
    """Cosine-weighted hemisphere sample about ``normal``."""
    phi = 2.0 * math.pi * r1
    cos_theta = torch.sqrt(r2)
    sin_theta = torch.sqrt(1.0 - cos_theta * cos_theta)
    x = sin_theta * torch.cos(phi)
    y = sin_theta * torch.sin(phi)
    tangent, bitangent = tangent_frame(normal)
    return normalize(from_tangent_frame(normal, tangent, bitangent, x, y, cos_theta))


def vmax(a: torch.Tensor) -> torch.Tensor:
    """Componentwise max of a 3-vector."""
    return torch.amax(a, dim=-1)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance."""
    return _LUM_R * rgb[..., 0] + _LUM_G * rgb[..., 1] + _LUM_B * rgb[..., 2]


def finite_or_zero(a: torch.Tensor) -> torch.Tensor:
    """Non-finite entries become zero (the reference's NaN/inf guards on GGX
    math at grazing angles, as a lane-wide scrub)."""
    return torch.where(torch.isfinite(a), a, torch.zeros_like(a))
