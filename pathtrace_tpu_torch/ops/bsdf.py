"""Branchless masked BSDF lanes of the composed path.

Counterpart of ``pathtrace_tpu/ops/bsdf.py``, same formulas and op order:
every ray evaluates each material lane present in the scene (Lambertian,
Oren-Nayar, GGX Mirror, PBR; Emissive is a zero BSDF with pdf 1) and the
result is selected by ``mat_kind``. The scene's ``has_oren_nayar``,
``has_mirror`` and ``has_pbr`` flags skip lanes its material table lacks.

Conventions: ``i`` is the unit vector toward the viewer (``-ray.direction``),
``o`` the outgoing direction, ``normal`` the face-forwarded shading normal,
``eta`` the IOR ratio carried on the ray. Vectors are ``(N, 3)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import profiler
from ..models import materials as mat
from ..models.scene import Scene
from ..utils import vec

_PI = math.pi


class MatParams(NamedTuple):
    """Per-ray material parameters, resolved once per bounce."""

    kind: torch.Tensor       # (N,) int32
    color: torch.Tensor      # (N, 3)
    emission: torch.Tensor   # (N, 3)
    roughness: torch.Tensor  # (N,)
    metallic: torch.Tensor   # (N,)
    ior: torch.Tensor        # (N,)


def mat_of(scene: Scene, mid) -> MatParams:
    """Resolve material ids to their table rows (plain gathers; the JAX
    package's one-hot MXU matmul is a TPU workaround)."""
    mid = mid.long()
    return MatParams(
        kind=scene.mat_kind[mid],
        color=scene.mat_color[mid],
        emission=scene.mat_emission[mid],
        roughness=scene.mat_roughness[mid],
        metallic=scene.mat_metallic[mid],
        ior=scene.mat_ior[mid],
    )


def emitted_params(m: MatParams):
    """Emission of resolved materials (zero for every non-emissive kind)."""
    return torch.where((m.kind == mat.KIND_EMISSIVE)[:, None], m.emission, 0.0)


def is_emissive_params(m: MatParams):
    return (m.kind == mat.KIND_EMISSIVE) & (vec.length(m.emission) > 0.0)


def emitted(scene: Scene, mid):
    """:func:`emitted_params` of material ids ``mid``."""
    return emitted_params(mat_of(scene, mid))


def is_emissive(scene: Scene, mid):
    """:func:`is_emissive_params` of material ids ``mid``."""
    return is_emissive_params(mat_of(scene, mid))


# ---------------------------------------------------------------------------
# GGX helpers
# ---------------------------------------------------------------------------

def _ggx_d(alpha2, n_dot_h):
    # nh^2(a^2-1)+1 written as a^2 c^2 + (1-c)(1+c), which does not cancel in
    # float32 when nh -> 1 and alpha is small.
    c = torch.clamp_max(torch.abs(n_dot_h), 1.0)
    denom = alpha2 * c * c + (1.0 - c) * (1.0 + c)
    return alpha2 / (_PI * denom * denom)


def _smith_g1(alpha2, cos_theta):
    term = torch.sqrt(alpha2 + (1.0 - alpha2) * cos_theta * cos_theta)
    g = 2.0 * cos_theta / (cos_theta + term)
    return torch.where(cos_theta > 0.0, g, 0.0)


def _smith_g2(alpha2, cos_i, cos_o):
    """Height-correlated G2; 0 if either cosine is <= 0."""
    def lam(c):
        num = torch.sqrt(alpha2 + (1.0 - alpha2) * c * c)
        return (num - c) / (2.0 * c)

    g = 1.0 / (1.0 + lam(cos_i) + lam(cos_o))
    return torch.where((cos_i > 0.0) & (cos_o > 0.0), g, 0.0)


def _fresnel(color, metallic, ior, cos_theta):
    """Schlick with F0 lerped between dielectric-from-IOR and tint: (N, 3)."""
    f0d = ((1.0 - ior) / (1.0 + ior)) ** 2
    f0 = f0d[:, None] * (1.0 - metallic)[:, None] + color * metallic[:, None]
    return f0 + (1.0 - f0) * ((1.0 - cos_theta) ** 5)[:, None]


def sample_ggx_vndf(view, normal, roughness, r1, r2):
    """Heitz VNDF half-vector sample (the reference's construction and
    tangent-frame convention)."""
    alpha = roughness * roughness
    tangent, bitangent = vec.tangent_frame(normal)
    v_local = torch.stack(
        [vec.dot(view, tangent), vec.dot(view, bitangent), vec.dot(view, normal)], dim=-1
    )
    vh = vec.normalize(
        torch.stack([alpha * v_local[..., 0], alpha * v_local[..., 1], v_local[..., 2]], dim=-1)
    )
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp_min(lensq, 1e-38))
    t1 = torch.where(
        (lensq > 0.0)[..., None],
        torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv, torch.zeros_like(inv)], dim=-1),
        profiler.from_host(vh, [1.0, 0.0, 0.0]),
    )
    t2 = vec.cross(vh, t1)

    r = torch.sqrt(r1)
    phi = 2.0 * _PI * r2
    t1c = r * torch.cos(phi)
    t2c = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    t2c = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - t1c * t1c, 0.0)) + s * t2c

    nh = (
        t1 * t1c[..., None]
        + t2 * t2c[..., None]
        + vh * torch.sqrt(torch.clamp_min(1.0 - t1c * t1c - t2c * t2c, 0.0))[..., None]
    )
    ne = vec.normalize(
        torch.stack(
            [alpha * nh[..., 0], alpha * nh[..., 1], torch.clamp_min(nh[..., 2], 0.0)], dim=-1
        )
    )
    return vec.normalize(
        tangent * ne[..., 0:1] + bitangent * ne[..., 1:2] + normal * ne[..., 2:3]
    )


# ---------------------------------------------------------------------------
# Evaluation (NEE and MIS queries)
# ---------------------------------------------------------------------------

def _eval_lambert(color, o, normal):
    brdf = color / _PI
    pdf = torch.clamp_min(vec.dot(o, normal), 0.0) / _PI
    return brdf, pdf


def _eval_oren_nayar(color, roughness, i, o, normal):
    sigma2 = roughness * roughness
    a = 1.0 - 0.5 * sigma2 / (sigma2 + 0.33)
    b = 0.45 * sigma2 / (sigma2 + 0.09)

    cos_i = torch.clamp_min(vec.dot(i, normal), 0.0)
    cos_o = torch.clamp_min(vec.dot(o, normal), 0.0)
    sin_i = torch.sqrt(torch.clamp_min(1.0 - cos_i * cos_i, 0.0))
    sin_o = torch.sqrt(torch.clamp_min(1.0 - cos_o * cos_o, 0.0))

    tangent, bitangent = vec.tangent_frame(normal)
    phi_i = torch.atan2(vec.dot(i, bitangent), vec.dot(i, tangent))
    phi_o = torch.atan2(vec.dot(o, bitangent), vec.dot(o, tangent))
    cos_phi_diff = torch.clamp_min(torch.cos(phi_i - phi_o), 0.0)

    # alpha = the larger angle, beta = the smaller, by the cosine comparison.
    i_steeper = cos_i > cos_o
    tan_beta = torch.where(
        i_steeper,
        torch.where(cos_i > 1e-6, sin_i / torch.clamp_min(cos_i, 1e-6), 0.0),
        torch.where(cos_o > 1e-6, sin_o / torch.clamp_min(cos_o, 1e-6), 0.0),
    )
    sin_alpha = torch.where(i_steeper, sin_o, sin_i)

    term = a + b * cos_phi_diff * sin_alpha * tan_beta
    brdf = color * (term / _PI)[:, None]
    pdf = cos_o / _PI
    return brdf, pdf


def _eval_mirror(m: MatParams, i, o, normal, eta):
    alpha = m.roughness * m.roughness
    alpha2 = alpha * alpha

    i_dot_n = vec.dot(i, normal)
    o_dot_n = vec.dot(o, normal)
    is_reflection = i_dot_n * o_dot_n > 0.0

    # BRDF branch
    h_r = vec.normalize(i + o)
    n_h_r = vec.dot(normal, h_r)
    d_r = _ggx_d(alpha2, n_h_r)
    i_n_r = torch.clamp_min(i_dot_n, 0.0)
    o_n_r = torch.clamp_min(o_dot_n, 0.0)
    g_r = _smith_g2(alpha2, i_n_r, o_n_r)
    cos_f = torch.clamp_min(vec.dot(i, h_r), 0.0)
    f_r = _fresnel(m.color, m.metallic, m.ior, cos_f)
    brdf = f_r * (d_r * g_r / (4.0 * i_n_r * o_n_r))[:, None]
    i_h_r = torch.abs(vec.dot(i, h_r))
    pdf_r = d_r * torch.abs(n_h_r) / (4.0 * i_h_r)

    # BTDF branch
    h_t = -vec.normalize(i * eta[:, None] + o)
    n_h_t = vec.dot(normal, h_t)
    d_t = _ggx_d(alpha2, n_h_t)
    i_n_t = torch.abs(i_dot_n)
    o_n_t = torch.abs(o_dot_n)
    g_t = _smith_g2(alpha2, i_n_t, o_n_t)
    i_h_t = vec.dot(i, h_t)
    o_h_t = vec.dot(o, h_t)
    denom_t = eta * i_h_t + o_h_t
    f_t = _fresnel(m.color, m.metallic, m.ior, torch.abs(i_h_t))
    btdf = (1.0 - f_t) * (
        d_t * g_t * torch.abs(i_h_t) * torch.abs(o_h_t) / (i_n_t * o_n_t * denom_t * denom_t)
    )[:, None]
    jac_t = torch.abs(o_h_t) / (denom_t * denom_t)
    pdf_t = d_t * torch.abs(n_h_t) * jac_t

    bsdf = torch.where(is_reflection[:, None], brdf, btdf)
    pdf = torch.where(is_reflection, pdf_r, pdf_t)

    # A metal blocks transmission entirely.
    metal_block = (m.metallic > 0.99) & ~is_reflection
    bsdf = torch.where(metal_block[:, None], 0.0, bsdf)
    pdf = torch.where(metal_block, 1.0, pdf)
    return bsdf, pdf


def _pbr_weights(m: MatParams, f_avg):
    """Specular weight by mean Fresnel; diffuse by what Fresnel lets through
    on the non-metallic fraction."""
    return f_avg, (1.0 - f_avg) * (1.0 - m.metallic)


def _eval_pbr(m: MatParams, i, o, normal):
    """Specular GGX reflection plus Oren-Nayar diffuse scaled by kd, with the
    pdf a Fresnel-weighted blend of the two techniques' pdfs."""
    alpha = m.roughness * m.roughness
    alpha2 = alpha * alpha

    h = vec.normalize(i + o)
    n_h = vec.dot(normal, h)
    d_ggx = _ggx_d(alpha2, n_h)
    cos_i = torch.clamp_min(vec.dot(i, normal), 0.0)
    cos_o = torch.clamp_min(vec.dot(o, normal), 0.0)
    g2 = _smith_g2(alpha2, cos_i, cos_o)
    cos_f = torch.clamp_min(vec.dot(i, h), 0.0)
    f = _fresnel(m.color, m.metallic, m.ior, cos_f)
    spec_brdf = f * (d_ggx * g2 / (4.0 * cos_i * cos_o))[:, None]
    spec_pdf = d_ggx * torch.abs(n_h) / (4.0 * torch.abs(vec.dot(i, h)))

    # Diffuse: Oren-Nayar x kd; metals do not diffuse.
    diff_raw, diff_pdf = _eval_oren_nayar(m.color, m.roughness, i, o, normal)
    kd = (1.0 - f) * (1.0 - m.metallic)[:, None]
    diff_brdf = torch.where((m.metallic < 1.0)[:, None], diff_raw * kd, 0.0)

    brdf = spec_brdf + diff_brdf
    f_avg = torch.mean(f, dim=-1)
    sw, dw = _pbr_weights(m, f_avg)
    tw = sw + dw
    pdf = torch.where(
        tw > 1e-6, (sw * spec_pdf + dw * diff_pdf) / torch.clamp_min(tw, 1e-6), spec_pdf
    )
    # Below-horizon queries can give 0/0 above: zero them.
    bad = (cos_o <= 0.0) | ~torch.isfinite(brdf).all(dim=-1) | ~torch.isfinite(pdf)
    brdf = torch.where(bad[:, None], 0.0, brdf)
    pdf = torch.where(bad, 1.0, pdf)
    return brdf, pdf


def _sample_pbr(m: MatParams, i, normal, r1, r2, u_coin, d_diff):
    """A coin weighted by the approximate Fresnel of the incoming angle picks
    the GGX VNDF reflection or the shared cosine sample ``d_diff``; the
    blended bsdf/pdf is then evaluated at the chosen direction."""
    cos_i = torch.clamp_min(vec.dot(i, normal), 0.0)
    f0s = torch.where(m.metallic > 0.5, torch.mean(m.color, dim=-1), 0.04)
    f_approx = f0s + (1.0 - f0s) * (1.0 - cos_i) ** 5
    sw, dw = _pbr_weights(m, f_approx)
    tw = sw + dw
    p_spec = torch.where(tw > 1e-6, sw / torch.clamp_min(tw, 1e-6), 1.0)
    use_spec = u_coin < p_spec

    h = sample_ggx_vndf(i, normal, m.roughness, r1, r2)
    o_spec = vec.normalize(2.0 * vec.dot(i, h)[:, None] * h - i)

    o = torch.where(use_spec[:, None], o_spec, d_diff)
    bsdf, pdf = _eval_pbr(m, i, o, normal)
    cos = torch.clamp_min(vec.dot(o, normal), 0.0)

    bad = ~torch.isfinite(bsdf).all(dim=-1) | ~torch.isfinite(pdf) | (pdf <= 0.0)
    o = torch.where(bad[:, None], normal, o)
    bsdf = torch.where(bad[:, None], 0.0, bsdf)
    pdf = torch.where(bad, 1.0, pdf)
    cos = torch.where(bad, 0.0, cos)
    return o, bsdf, pdf, cos


def eval_bsdf(scene: Scene, mid, i, eta, o, normal, params: MatParams | None = None):
    """``(bsdf (N,3), pdf (N,))`` toward ``o``. ``eta`` is the IOR ratio the
    incoming ray carries (NEE evaluates with the previous vertex's eta).
    ``params`` reuses an already resolved material row."""
    m = mat_of(scene, mid) if params is None else params
    kind = m.kind

    lam_bsdf, lam_pdf = _eval_lambert(m.color, o, normal)
    on_bsdf, on_pdf = (
        _eval_oren_nayar(m.color, m.roughness, i, o, normal)
        if scene.has_oren_nayar else (lam_bsdf, lam_pdf)
    )
    mir_bsdf, mir_pdf = (
        _eval_mirror(m, i, o, normal, eta) if scene.has_mirror else (lam_bsdf, lam_pdf)
    )

    bsdf = torch.where(
        (kind == mat.KIND_LAMBERT)[:, None],
        lam_bsdf,
        torch.where(
            (kind == mat.KIND_OREN_NAYAR)[:, None],
            on_bsdf,
            torch.where((kind == mat.KIND_MIRROR)[:, None], mir_bsdf, 0.0),
        ),
    )
    pdf = torch.where(
        kind == mat.KIND_LAMBERT,
        lam_pdf,
        torch.where(
            kind == mat.KIND_OREN_NAYAR,
            on_pdf,
            torch.where(kind == mat.KIND_MIRROR, mir_pdf, 1.0),
        ),
    )
    if scene.has_pbr:
        pbr_bsdf, pbr_pdf = _eval_pbr(m, i, o, normal)
        is_pbr = kind == mat.KIND_PBR
        bsdf = torch.where(is_pbr[:, None], pbr_bsdf, bsdf)
        pdf = torch.where(is_pbr, pbr_pdf, pdf)
    return bsdf, pdf


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _sample_mirror(m: MatParams, i, normal, eta, r1, r2, u_coin):
    """GGX sample: VNDF half vector, Fresnel coin, both branches computed and
    selected."""
    alpha = m.roughness * m.roughness
    alpha2 = alpha * alpha
    i_dot_n = vec.dot(i, normal)

    h = sample_ggx_vndf(i, normal, m.roughness, r1, r2)
    i_h = vec.dot(i, h)
    fail = i_h <= 0.0

    fresnel = _fresnel(m.color, m.metallic, m.ior, i_h)
    sin2_i = (1.0 - i_h) * (1.0 + i_h)
    cos2_t = 1.0 - (eta * eta) * sin2_i
    total_reflection = cos2_t < 0.0

    force_reflect = total_reflection | (m.metallic > 0.99)
    rr_f = torch.where(force_reflect, 1.0, fresnel[:, 0])
    fresnel = torch.where(force_reflect[:, None], 1.0, fresnel)
    is_reflect = u_coin < rr_f

    n_h = vec.dot(normal, h)
    d = _ggx_d(alpha2, n_h)

    # Reflect branch
    o_r = vec.normalize(2.0 * i_h[:, None] * h - i)
    o_n_r = torch.clamp_min(vec.dot(normal, o_r), 0.0)
    i_n_r = torch.clamp_min(i_dot_n, 0.0)
    g_r = _smith_g2(alpha2, i_n_r, o_n_r)
    brdf = fresnel * (d * g_r / (4.0 * i_n_r * o_n_r * rr_f))[:, None]
    pdf_vndf_r = _smith_g1(alpha2, i_n_r) * d * torch.clamp_min(i_h, 0.0) / i_n_r
    pdf_r = pdf_vndf_r / (4.0 * torch.abs(i_h))

    # Refract branch
    cos_t = torch.sqrt(torch.clamp_min(cos2_t, 0.0))
    o_t = vec.normalize(h * (eta * i_h - cos_t)[:, None] - i * eta[:, None])
    o_h_t = vec.dot(o_t, h)
    o_n_t = torch.abs(vec.dot(normal, o_t))
    i_n_t = torch.abs(i_dot_n)
    denom_t = eta * i_h + o_h_t
    g_t = _smith_g2(alpha2, i_n_t, o_n_t)
    btdf = (1.0 - fresnel) * (
        d * g_t * torch.abs(i_h) * torch.abs(o_h_t)
        / (i_n_t * o_n_t * denom_t * denom_t * (1.0 - rr_f))
    )[:, None]
    jac = torch.abs(o_h_t) / (denom_t * denom_t)
    pdf_vndf_t = _smith_g1(alpha2, i_n_t) * d * torch.clamp_min(i_h, 0.0) / i_n_t
    pdf_t = pdf_vndf_t * jac

    o = torch.where(is_reflect[:, None], o_r, o_t)
    bsdf = torch.where(is_reflect[:, None], brdf, btdf)
    pdf = torch.where(is_reflect, pdf_r, pdf_t)
    cos = torch.where(is_reflect, o_n_r, o_n_t)

    # Non-finite or non-positive pdf, or i.h <= 0: a zero-contribution sample.
    bad = fail | ~torch.isfinite(bsdf).all(dim=-1) | ~torch.isfinite(pdf) | (pdf <= 0.0)
    o = torch.where(bad[:, None], normal, o)
    bsdf = torch.where(bad[:, None], 0.0, bsdf)
    pdf = torch.where(bad, 1.0, pdf)
    cos = torch.where(bad, 0.0, cos)
    return o, bsdf, pdf, cos


def sample_bsdf(scene: Scene, mid, i, eta, normal, r1, r2, u_coin,
                params: MatParams | None = None):
    """``(direction (N,3), bsdf (N,3), pdf (N,), cos_theta (N,))``.

    Diffuse lanes share one cosine-weighted sample and evaluate at it (cos
    clamped >= 0); the Mirror lane samples VNDF with a stochastic
    reflect/refract choice; Emissive is terminal (direction = normal, zero
    BSDF, pdf 1).
    """
    m = mat_of(scene, mid) if params is None else params
    kind = m.kind

    d_diff = vec.cosine_hemisphere_direction(normal, r1, r2)
    lam_bsdf, lam_pdf = _eval_lambert(m.color, d_diff, normal)
    on_bsdf, on_pdf = (
        _eval_oren_nayar(m.color, m.roughness, i, d_diff, normal)
        if scene.has_oren_nayar else (lam_bsdf, lam_pdf)
    )
    cos_diff = torch.clamp_min(vec.dot(d_diff, normal), 0.0)

    mir_o, mir_bsdf, mir_pdf, mir_cos = (
        _sample_mirror(m, i, normal, eta, r1, r2, u_coin)
        if scene.has_mirror else (d_diff, lam_bsdf, lam_pdf, cos_diff)
    )

    is_mirror = kind == mat.KIND_MIRROR
    is_on = kind == mat.KIND_OREN_NAYAR
    is_emis = kind == mat.KIND_EMISSIVE

    o = torch.where(is_mirror[:, None], mir_o, d_diff)
    bsdf = torch.where(
        is_mirror[:, None], mir_bsdf, torch.where(is_on[:, None], on_bsdf, lam_bsdf)
    )
    pdf = torch.where(is_mirror, mir_pdf, torch.where(is_on, on_pdf, lam_pdf))
    cos = torch.where(is_mirror, mir_cos, cos_diff)

    if scene.has_pbr:
        pbr_o, pbr_bsdf, pbr_pdf, pbr_cos = _sample_pbr(m, i, normal, r1, r2, u_coin, d_diff)
        is_pbr = kind == mat.KIND_PBR
        o = torch.where(is_pbr[:, None], pbr_o, o)
        bsdf = torch.where(is_pbr[:, None], pbr_bsdf, bsdf)
        pdf = torch.where(is_pbr, pbr_pdf, pdf)
        cos = torch.where(is_pbr, pbr_cos, cos)

    o = torch.where(is_emis[:, None], normal, o)
    bsdf = torch.where(is_emis[:, None], 0.0, bsdf)
    pdf = torch.where(is_emis, 1.0, pdf)
    cos = torch.where(is_emis, 0.0, cos)
    return o, bsdf, pdf, cos


def eta_ratio(scene: Scene, mid, front_face, params: MatParams | None = None):
    """IOR ratio for a ray leaving a vertex: air to medium on front faces,
    medium to air on back faces."""
    ior = scene.mat_ior[mid.long()] if params is None else params.ior
    return torch.where(front_face, 1.0 / ior, ior)
