"""Material descriptions (host-side scene-building API).

A copy of ``pathtrace_tpu/models/materials.py`` (pure Python; copied because
importing the JAX package imports JAX). Plain frozen dataclasses that
:class:`~pathtrace_tpu_torch.models.scene.SceneBuilder` flattens into the
material table; the BSDF math lives in the kernels of
:mod:`pathtrace_tpu_torch.ops.shade`, selected per hit by ``mat_kind``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

Color = Tuple[float, float, float]

# Material-kind codes in the device table.
KIND_LAMBERT = 0
KIND_EMISSIVE = 1
KIND_MIRROR = 2
KIND_OREN_NAYAR = 3
KIND_PBR = 4


@dataclass(frozen=True)
class Lambertian:
    """Cosine-weighted Lambertian diffuse (material.rs:67-123)."""

    albedo: Color


@dataclass(frozen=True)
class Emissive:
    """Black-body area light: zero BSDF, constant radiance (material.rs:125-163)."""

    emission: Color


@dataclass(frozen=True)
class Mirror:
    """GGX microfacet metal/dielectric with VNDF sampling and stochastic
    reflect/refract selection (mirror.rs:5-320)."""

    roughness: float
    color: Color = (1.0, 1.0, 1.0)
    metallic: float = 0.0
    ior: float = 1.5


@dataclass(frozen=True)
class OrenNayar:
    """Qualitative Oren–Nayar diffuse (material.rs:165-296). Exported but unused
    by the reference's scene; a first-class lane here."""

    albedo: Color
    roughness: float


@dataclass(frozen=True)
class PBRMaterial:
    """Fresnel-blended specular (GGX Mirror) + diffuse (Oren–Nayar)
    uber-material (material.rs:298-389).

    Upstream this is dead code — private fields, no constructor, never
    exported or instantiated — and its sampling path delegates to
    ``Mirror::sample_direction``, which is an explicit stub returning the
    normal (mirror.rs:307-315). This lane implements the evidently intended
    semantics: the *evaluation* follows material.rs:311-355 term-for-term
    (Fresnel-weighted BRDF sum, kd energy conservation, normalized pdf
    blend), and the specular *sample* is the proper GGX VNDF reflection the
    stub stood in for. ``albedo`` serves as both the specular tint
    (``specular.color``) and the diffuse color (``diffuse.albedo``) — the
    dead upstream struct permits distinct values but nothing constructs one.
    """

    albedo: Color
    roughness: float
    metallic: float = 0.0
    ior: float = 1.5


Material = Lambertian | Emissive | Mirror | OrenNayar | PBRMaterial


def material_row(m: Material):
    """Flatten a material into the device table row
    ``(kind, color, emission, roughness, metallic, ior)``."""
    if isinstance(m, Lambertian):
        return (KIND_LAMBERT, m.albedo, (0.0, 0.0, 0.0), 0.0, 0.0, 1.0)
    if isinstance(m, Emissive):
        return (KIND_EMISSIVE, (0.0, 0.0, 0.0), m.emission, 0.0, 0.0, 1.0)
    if isinstance(m, Mirror):
        return (KIND_MIRROR, m.color, (0.0, 0.0, 0.0), m.roughness, m.metallic, m.ior)
    if isinstance(m, OrenNayar):
        return (KIND_OREN_NAYAR, m.albedo, (0.0, 0.0, 0.0), m.roughness, 0.0, 1.0)
    if isinstance(m, PBRMaterial):
        return (KIND_PBR, m.albedo, (0.0, 0.0, 0.0), m.roughness, m.metallic, m.ior)
    raise TypeError(f"unknown material {m!r}")


def is_emissive(m: Material) -> bool:
    """Light auto-detection probe, mirroring the emit()>0 check
    (world.rs:213-225).

    The predicate is ``dot(emission, emission) > 0`` — i.e. any *nonzero*
    channel — to match the in-kernel emissive gate
    (ops/pallas_shade.py ``emis``) and ``bsdf.is_emissive_params`` exactly.
    For physical (non-negative) emissions this equals the reference's
    ``any(c > 0)``; for unphysical negative channels all three predicates
    now agree, so the single-light MIS fast path's row-0 assumption holds
    for every scene the builder can produce.
    """
    return isinstance(m, Emissive) and any(c != 0.0 for c in m.emission)
