"""Light sampling for next-event estimation and the MIS pdf query.

Counterpart of ``pathtrace_tpu/ops/lights.py``, same formulas and op order.
Each ray picks one light uniformly; the triangle (area) and sphere (cone)
lanes are both computed and selected per ray. Per-light geometry comes from
the scene's packed ``light_geom`` rows by an indexed load (the JAX package's
one-hot MXU product is a TPU workaround; it selects the same rows exactly).

The reference's quirk is kept: :func:`sample_light_point` divides the pdf by
the light count, :func:`light_pdf_toward` (the MIS bsdf-side query) does not.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.scene import Scene
from ..utils import vec

_PI = math.pi


class LightSample(NamedTuple):
    point: torch.Tensor     # (N, 3) sampled point on the light
    normal: torch.Tensor    # (N, 3) light-surface normal
    emission: torch.Tensor  # (N, 3)
    pdf: torch.Tensor       # (N,) solid-angle pdf / num_lights
    dir: torch.Tensor       # (N, 3) unit direction from the shading point
    dist: torch.Tensor      # (N,)


def _tri_lane_rows(row, from_point, target_point, r1, r2):
    """Triangle surface sample, or the pdf toward a given target point."""
    v0 = row[:, 1:4]
    e1 = row[:, 4:7]
    e2 = row[:, 7:10]
    normal = row[:, 10:13]
    area = row[:, 13]

    if target_point is None:
        sqrt_r1 = torch.sqrt(r1)
        u = 1.0 - sqrt_r1
        v = r2 * sqrt_r1
        point = v0 + e1 * u[:, None] + e2 * v[:, None]
    else:
        point = target_point

    to_light = point - from_point
    d = vec.length(to_light)
    ldir = to_light / torch.where(d > 0, d, 1.0)[:, None]
    # |n.(-ldir)|: two-sided emitters.
    cos_light = torch.abs(vec.dot(normal, -ldir))
    pdf_area = 1.0 / torch.clamp_min(area, 1e-20)
    pdf_omega = torch.where(
        cos_light > 1e-8, pdf_area * (d * d) / torch.clamp_min(cos_light, 1e-8), 1e-8
    )
    return point, normal, pdf_omega, ldir, d


def _sphere_lane_rows(row, from_point, target_point, r1, r2):
    """Sphere cone sample (uniform direction in the subtended cone, pdf
    1/solid angle), the point found by re-intersecting the cone ray."""
    center = row[:, 1:4]
    radius = row[:, 4]

    to_center = center - from_point
    dist_sq = vec.dot(to_center, to_center)
    sin2_max = (radius * radius) / torch.where(dist_sq > 0, dist_sq, 1.0)
    cos_max = torch.sqrt(torch.clamp_min(1.0 - sin2_max, 0.0))
    solid_angle = 2.0 * _PI * (1.0 - cos_max)
    pdf_omega = 1.0 / torch.clamp_min(solid_angle, 1e-12)

    if target_point is None:
        cos_theta = 1.0 - r1 + r1 * cos_max
        sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
        phi = 2.0 * _PI * r2

        w = vec.normalize(to_center)
        up = torch.where(
            (torch.abs(w[..., 1]) > 0.999)[..., None],
            w.new_tensor([1.0, 0.0, 0.0]),
            w.new_tensor([0.0, 1.0, 0.0]),
        )
        u = vec.normalize(vec.cross(up, w))
        v = vec.cross(w, u)
        direction = (
            u * (sin_theta * torch.cos(phi))[:, None]
            + v * (sin_theta * torch.sin(phi))[:, None]
            + w * cos_theta[:, None]
        )
        direction = vec.normalize(direction)

        oc = from_point - center
        a = vec.dot(direction, direction)
        half_b = vec.dot(oc, direction)
        c = vec.dot(oc, oc) - radius * radius
        disc = half_b * half_b - a * c
        t = (-half_b - torch.sqrt(torch.clamp_min(disc, 0.0))) / a
        point = from_point + direction * t[:, None]
    else:
        point = target_point

    normal = vec.normalize(point - center)
    to_light = point - from_point
    d = vec.length(to_light)
    ldir = to_light / torch.where(d > 0, d, 1.0)[:, None]
    return point, normal, pdf_omega, ldir, d


def _select_lanes(scene: Scene, row, from_point, target_point, r1, r2):
    """Both light-class lanes, merged by ``is_tri``; a scene whose lights are
    all of one class runs only that lane (the merge would pick it anyway)."""
    if scene.has_tri_lights and not scene.has_sph_lights:
        return _tri_lane_rows(row, from_point, target_point, r1, r2)
    if scene.has_sph_lights and not scene.has_tri_lights:
        return _sphere_lane_rows(row, from_point, target_point, r1, r2)
    tp, tn, tpdf, tdir, td = _tri_lane_rows(row, from_point, target_point, r1, r2)
    sp, sn, spdf, sdir, sd = _sphere_lane_rows(row, from_point, target_point, r1, r2)
    is_tri = row[:, 0] > 0.5
    it = is_tri[:, None]
    return (
        torch.where(it, tp, sp),
        torch.where(it, tn, sn),
        torch.where(is_tri, tpdf, spdf),
        torch.where(it, tdir, sdir),
        torch.where(is_tri, td, sd),
    )


def sample_light_point(scene: Scene, from_point, u_sel, r1, r2) -> LightSample:
    """Pick a light uniformly and sample its surface; the pdf includes the
    1/num_lights factor."""
    num_lights = max(scene.num_lights, 1)
    idx = torch.clamp_max((u_sel * num_lights).to(torch.int64), num_lights - 1)
    row = scene.light_geom[idx]

    point, normal, pdf, ldir, dist = _select_lanes(scene, row, from_point, None, r1, r2)
    return LightSample(
        point=point,
        normal=normal,
        emission=row[:, 14:17],
        pdf=pdf / num_lights,
        dir=ldir,
        dist=dist,
    )


def light_pdf_toward(scene: Scene, prim, from_point, target_point):
    """Solid-angle pdf of the shape sampler toward a known hit point (the MIS
    bsdf-side query), NOT divided by the light count. A ``prim`` that is no
    light selects an all-zero row (as the JAX one-hot product does) and gives
    a bogus pdf the caller masks out."""
    match = prim[:, None] == scene.light_prims[None, :]
    row = torch.where(
        match.any(dim=1)[:, None],
        scene.light_geom[torch.argmax(match.to(torch.int32), dim=1)],
        0.0,
    )
    _, _, pdf, _, _ = _select_lanes(scene, row, from_point, target_point, None, None)
    return pdf
