"""One path vertex per lane, and the NEE shadow test: the pool's two kernels.

Counterpart of ``pathtrace_tpu/ops/pallas_shade.py``. Two hand-written CUDA
kernels (``csrc/fused_bounce.cu``, ``csrc/shadow_any_hit.cu``) each have a
plain-torch twin here with the same op order:

* :func:`fused_bounce` / :func:`fused_bounce_reference`: closest hit over
  the sphere and triangle tables with the winner's material row, the
  emissive/MIS terminal term (the bsdf-side pdf deliberately NOT divided by
  the light count), the NEE light pick, sample and BSDF evaluation, the BSDF
  sample (Lambert, GGX mirror with VNDF, Fresnel coin, reflect/refract; the
  Oren-Nayar and PBR lanes when the scene's ``has_oren_nayar``/``has_pbr``
  flags set them), Russian roulette and the next ray state. By default the
  shadow ray is exported and tested by :func:`shadow_any_hit`; two modes,
  each a kernel instance of its own, fold more of the pool's iteration in:

  - ``raygen=(started, px, py, cam_row)``: the ray state comes in as it was
    before the pool's refill, and the kernel makes the started lanes'
    jittered primary rays (uniform slots 7-8, the op sequence of
    ``models/camera.py :: Camera.generate_rays``) and resets their ``eta``,
    ``pdf_prev`` and ``prefix`` itself. The pool's fused branch always runs
    this mode;
  - ``fuse_shadow=True``: the NEE shadow ray of each live lane is swept
    inside the kernel with :func:`shadow_any_hit`'s test, its visibility
    zeroes the direct light, and ``prefix * direct`` is added into
    ``rad_delta``; ``nee_gain`` comes back as zeros. No pool runs it yet.
* :func:`shadow_any_hit` / :func:`shadow_any_hit_reference`: occlusion of
  the NEE shadow rays, Moller-Trumbore over the triangles OR the sphere
  quadratic with the near-then-far root select, for t in [eps, t_max].

Everything is in kernel layout: 3-vectors ``(3, S)``, scalars ``(S,)``,
uniforms ``(9, S)`` (``utils/rng.py`` slots), in float32 or float64 (the
reference's precision; the tables, rays and uniforms of a call share one
dtype, and each kernel has an instance for each).

The wrappers dispatch on the device of their inputs: CPU tensors run the
twin, CUDA tensors launch the kernel (or raise); there is no fallback.

TPU workarounds of the JAX kernel left behind here:

* the bf16x3 one-hot MXU row select (``_select_rows``) is an indexed load;
* the MXU sphere quadratic-form tables (``_sphere_quad_tables``,
  ``_trunc_split3``, ``_bf16_split3``) are not built: the sphere test is the
  kernel's VPU form, which is also what the JAX package runs on the CPU;
* ``ray_tile`` lane padding is gone: any ``S`` is accepted;
* the ``_lift_tree``/``vma`` varying-axes plumbing has no counterpart.

Every mode of the JAX kernel is ported; the ``sections`` profiling knob is
left behind.
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple

import torch

from ..kernels.binding import SUFFIX as _SUFFIX, check as _check, device_kind as _device_kind
from ..models import materials as mat
from ..models.scene import Scene

_INF = float("inf")
_PI = 3.14159265358979323846

EPS = 1e-3          # ray t_min and shadow t_max margin
RR_MIN_DEPTH = 4
RR_MAX_DEPTH = 50

MAX_TRIS = 64
MAX_SPHERES = 512
MAX_LIGHTS = 64

# Sphere-table columns.
_SC_CX, _SC_K, _SC_KIND = 0, 3, 5      # 4 is 1/r
_SPH_COLS = 15
# Triangle-table columns.
_TC_N = 9
_TC_KIND = 12
_TRI_COLS = 22
# Material columns, relative to the kind column of either table:
# kind | color(3) | emission(3) | roughness | metallic | ior.
_MAT_COLS = 10
# Light-table columns (scene.light_geom layout + prim id appended).
_LC_ISTRI = 0
_LC_P = 1
_LC_RAD = 4
_LC_E1 = 4
_LC_E2 = 7
_LC_N = 10
_LC_AREA = 13
_LC_EMI = 14
_LC_PRIM = 17
_LGT_COLS = 18

# Kernel launches per wrapper, counted where the kernel is launched; a kernel
# with a further mode counts it apart (``fused_bounce_raygen``,
# ``fused_bounce_shadow``, ``fused_bounce_raygen_shadow``: the two modes;
# ``..._on_pbr``: the Oren-Nayar or PBR lanes on; ``*_clustered`` in
# ops/intersect.py), and a float64 instance under its name with ``_f64``
# appended.
LAUNCHES: collections.Counter = collections.Counter()


def _round8(n):
    return max(8, ((n + 7) // 8) * 8)


def _full_like(x, value):
    """A 0-dim tensor divisor on ``x``'s device: CUDA turns division by a
    host scalar into multiplication by its reciprocal, which is not IEEE
    division and would part the twin from the kernel."""
    return torch.tensor(float(value), dtype=x.dtype, device=x.device)


def _pad_rows(a, rows, fill=0.0):
    pad = rows - a.shape[0]
    if pad == 0:
        return a
    return torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)], 0)


class Tables(NamedTuple):
    """Scene tables packed for the kernels (built once per render)."""

    sph: torch.Tensor  # (Ps, 15): center, |c|^2-r^2 (NaN on padding), 1/r, material
    tri: torch.Tensor  # (Pt, 22): v0, e1, e2, normal, material
    lgt: torch.Tensor  # (L8, 18): light_geom row + global prim id (-2 on padding)


def kernel_flags(integrator: str, has_tri_lights: bool, has_sph_lights: bool,
                 has_oren_nayar: bool = False, has_pbr: bool = False) -> dict:
    """The fused kernel's static switches: which estimator terms run, which
    light-class lanes (a scene with one light class skips the other;
    inconsistent flags keep both), and whether the Oren-Nayar and PBR lanes
    run (the JAX ``has_on``/``has_pbr``; without them those kinds shade as
    Lambert)."""
    return dict(
        use_mis=integrator == "mis",
        use_nee=integrator in ("mis", "nee"),
        has_tri_l=has_tri_lights or not has_sph_lights,
        has_sph_l=has_sph_lights or not has_tri_lights,
        has_on=bool(has_oren_nayar),
        has_pbr=bool(has_pbr),
    )


def supports_scene(scene: Scene, integrator: str) -> bool:
    """Can the two kernels serve this scene and integrator (size caps)?"""
    return (
        integrator in ("mis", "nee", "brdf_only")
        and scene.tri_v0.shape[0] <= MAX_TRIS
        and scene.sph_center.shape[0] <= MAX_SPHERES
        and scene.light_geom.shape[0] <= MAX_LIGHTS
    )


def build_tables(scene: Scene) -> Tables:
    """Resolve each primitive's material into its row and pack the lights,
    in the scene's float dtype (material kinds and light prim ids too)."""
    dtype = scene.mat_color.dtype

    def mat_cols(mid):
        mid = mid.long()
        return [
            scene.mat_kind[mid].to(dtype)[:, None],
            scene.mat_color[mid],
            scene.mat_emission[mid],
            scene.mat_roughness[mid][:, None],
            scene.mat_metallic[mid][:, None],
            scene.mat_ior[mid][:, None],
        ]

    centers = scene.sph_center
    radius = scene.sph_radius
    c2 = centers * centers
    kq = torch.where(
        radius > 0.0, c2[:, 0] + c2[:, 1] + c2[:, 2] - radius * radius, math.nan
    )[:, None]
    pos = radius > 0
    inv_r = torch.where(pos, 1.0 / torch.where(pos, radius, 1.0), 0.0)[:, None]
    sph = torch.cat([centers, kq, inv_r] + mat_cols(scene.sph_mat), dim=1)
    sph = _pad_rows(sph, _round8(sph.shape[0]))
    sph[centers.shape[0]:, _SC_K] = math.nan   # added rows never hit

    tri = torch.cat(
        [scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_normal]
        + mat_cols(scene.tri_mat),
        dim=1,
    )
    tri = _pad_rows(tri, _round8(tri.shape[0]))

    lgt = torch.cat(
        [scene.light_geom, scene.light_prims.to(dtype)[:, None]], dim=1
    )
    n_real = lgt.shape[0]
    lgt = _pad_rows(lgt, _round8(n_real))
    lgt[n_real:, _LC_PRIM] = -2.0            # padding rows match no hit
    return Tables(sph=sph.contiguous(), tri=tri.contiguous(), lgt=lgt.contiguous())


class BounceResult(NamedTuple):
    """One vertex's outputs. With ``fuse_shadow`` the visible NEE gain is
    already in ``rad_delta`` and ``nee_gain`` is zeros, while ``shadow_d``
    and ``shadow_tmax`` still hold the shadow ray the kernel swept (the JAX
    kernel writes them in both modes)."""

    rad_delta: torch.Tensor    # (3, S) radiance gained this bounce
    next_o: torch.Tensor       # (3, S) hit point for live lanes (shadow origin)
    next_d: torch.Tensor       # (3, S)
    next_eta: torch.Tensor     # (S,)
    next_pdf: torch.Tensor     # (S,)
    next_prefix: torch.Tensor  # (3, S)
    live: torch.Tensor         # (S,) bool
    shade: torch.Tensor        # (S,) bool
    nee_gain: torch.Tensor     # (3, S) prefix * direct, pending visibility (zeros: fuse_shadow)
    shadow_d: torch.Tensor     # (3, S) shadow-ray direction
    shadow_tmax: torch.Tensor  # (S,) shadow range end; < eps for lanes w/o NEE


# ---------------------------------------------------------------------------
# Column helpers: a 3-vector is an (x, y, z) tuple of (S,) tensors.
# ---------------------------------------------------------------------------

def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _neg3(a):
    return (-a[0], -a[1], -a[2])


def _where3(c, a, b):
    return tuple(torch.where(c, a[i], b[i]) for i in range(3))


def _normalize3(a):
    """Components divided by the length; zero vectors pass through."""
    ln = torch.sqrt(_dot3(a, a))
    pos = ln > 0.0
    safe = torch.where(pos, ln, 1.0)
    return tuple(torch.where(pos, a[i] / safe, a[i]) for i in range(3))


def _finite3(a):
    return torch.isfinite(a[0]) & torch.isfinite(a[1]) & torch.isfinite(a[2])


def _forz(x):
    return torch.where(torch.isfinite(x), x, 0.0)


def _forz3(a):
    return tuple(_forz(a[i]) for i in range(3))


def _luminance3(a):
    return 0.2126 * a[0] + 0.7152 * a[1] + 0.0722 * a[2]


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def _tangent_frame(n):
    """Up is +Y unless |n.y| > 0.999, then +X."""
    ny_big = torch.abs(n[1]) > 0.999
    one = torch.ones_like(n[0])
    zero = torch.zeros_like(n[0])
    up = (torch.where(ny_big, one, zero), torch.where(ny_big, zero, one), zero)
    tangent = _normalize3(_cross3(up, n))
    bitangent = _cross3(n, tangent)
    return tangent, bitangent


def _ggx_d(alpha2, n_dot_h):
    c = torch.clamp_max(torch.abs(n_dot_h), 1.0)
    denom = alpha2 * c * c + (1.0 - c) * (1.0 + c)
    return alpha2 / (_PI * denom * denom)


def _smith_g1(alpha2, cos_theta):
    term = torch.sqrt(alpha2 + (1.0 - alpha2) * cos_theta * cos_theta)
    g = 2.0 * cos_theta / (cos_theta + term)
    return torch.where(cos_theta > 0.0, g, 0.0)


def _smith_g2(alpha2, cos_i, cos_o):
    def lam(c):
        num = torch.sqrt(alpha2 + (1.0 - alpha2) * c * c)
        return (num - c) / (2.0 * c)

    g = 1.0 / (1.0 + lam(cos_i) + lam(cos_o))
    return torch.where((cos_i > 0.0) & (cos_o > 0.0), g, 0.0)


def _fresnel3(color, metallic, ior, cos_theta):
    r = (1.0 - ior) / (1.0 + ior)
    f0d = r * r
    p5 = _pow5(1.0 - cos_theta)
    out = []
    for ch in range(3):
        f0 = f0d * (1.0 - metallic) + color[ch] * metallic
        out.append(f0 + (1.0 - f0) * p5)
    return tuple(out)


def _eval_mirror(color, rough, metal, ior, i, o, normal, eta):
    """GGX mirror bsdf and pdf toward ``o`` (reflection or transmission)."""
    alpha = rough * rough
    alpha2 = alpha * alpha

    i_dot_n = _dot3(i, normal)
    o_dot_n = _dot3(o, normal)
    is_reflection = i_dot_n * o_dot_n > 0.0

    h_r = _normalize3(_add3(i, o))
    n_h_r = _dot3(normal, h_r)
    d_r = _ggx_d(alpha2, n_h_r)
    i_n_r = torch.clamp_min(i_dot_n, 0.0)
    o_n_r = torch.clamp_min(o_dot_n, 0.0)
    g_r = _smith_g2(alpha2, i_n_r, o_n_r)
    cos_f = torch.clamp_min(_dot3(i, h_r), 0.0)
    f_r = _fresnel3(color, metal, ior, cos_f)
    spec = d_r * g_r / (4.0 * i_n_r * o_n_r)
    brdf = _scale3(f_r, spec)
    i_h_r = torch.abs(_dot3(i, h_r))
    pdf_r = d_r * torch.abs(n_h_r) / (4.0 * i_h_r)

    h_t = _neg3(_normalize3(_add3(_scale3(i, eta), o)))
    n_h_t = _dot3(normal, h_t)
    d_t = _ggx_d(alpha2, n_h_t)
    i_n_t = torch.abs(i_dot_n)
    o_n_t = torch.abs(o_dot_n)
    g_t = _smith_g2(alpha2, i_n_t, o_n_t)
    i_h_t = _dot3(i, h_t)
    o_h_t = _dot3(o, h_t)
    denom_t = eta * i_h_t + o_h_t
    f_t = _fresnel3(color, metal, ior, torch.abs(i_h_t))
    tt = d_t * g_t * torch.abs(i_h_t) * torch.abs(o_h_t) / (
        i_n_t * o_n_t * denom_t * denom_t
    )
    btdf = ((1.0 - f_t[0]) * tt, (1.0 - f_t[1]) * tt, (1.0 - f_t[2]) * tt)
    jac_t = torch.abs(o_h_t) / (denom_t * denom_t)
    pdf_t = d_t * torch.abs(n_h_t) * jac_t

    bsdf = _where3(is_reflection, brdf, btdf)
    pdf = torch.where(is_reflection, pdf_r, pdf_t)

    metal_block = (metal > 0.99) & ~is_reflection
    bsdf = _where3(metal_block, (0.0 * pdf,) * 3, bsdf)
    pdf = torch.where(metal_block, 1.0, pdf)
    return bsdf, pdf


def _sample_vndf(view, normal, rough, r1, r2):
    """Heitz VNDF half-vector sample."""
    alpha = rough * rough
    tangent, bitangent = _tangent_frame(normal)
    vl = (_dot3(view, tangent), _dot3(view, bitangent), _dot3(view, normal))
    vh = _normalize3((alpha * vl[0], alpha * vl[1], vl[2]))
    lensq = vh[0] * vh[0] + vh[1] * vh[1]
    inv = 1.0 / torch.sqrt(torch.clamp_min(lensq, 1e-38))
    has = lensq > 0.0
    t1 = (
        torch.where(has, -vh[1] * inv, 1.0),
        torch.where(has, vh[0] * inv, 0.0),
        torch.zeros_like(inv),
    )
    t2 = _cross3(vh, t1)

    r = torch.sqrt(r1)
    phi = 2.0 * _PI * r2
    t1c = r * torch.cos(phi)
    t2c = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[2])
    t2c = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - t1c * t1c, 0.0)) + s * t2c

    z = torch.sqrt(torch.clamp_min(1.0 - t1c * t1c - t2c * t2c, 0.0))
    nh = _add3(_add3(_scale3(t1, t1c), _scale3(t2, t2c)), _scale3(vh, z))
    ne = _normalize3((alpha * nh[0], alpha * nh[1], torch.clamp_min(nh[2], 0.0)))
    return _normalize3(
        _add3(
            _add3(_scale3(tangent, ne[0]), _scale3(bitangent, ne[1])),
            _scale3(normal, ne[2]),
        )
    )


def _cosine_hemisphere(normal, r1, r2):
    phi = 2.0 * _PI * r1
    cos_theta = torch.sqrt(r2)
    sin_theta = torch.sqrt(1.0 - cos_theta * cos_theta)
    x = sin_theta * torch.cos(phi)
    y = sin_theta * torch.sin(phi)
    tangent, bitangent = _tangent_frame(normal)
    return _normalize3(
        _add3(
            _add3(_scale3(tangent, x), _scale3(bitangent, y)),
            _scale3(normal, cos_theta),
        )
    )


def _sample_mirror(color, rough, metal, ior, i, normal, eta, r1, r2, u_coin):
    """GGX mirror sample: VNDF half vector, Fresnel coin, both branches."""
    alpha = rough * rough
    alpha2 = alpha * alpha
    i_dot_n = _dot3(i, normal)

    h = _sample_vndf(i, normal, rough, r1, r2)
    i_h = _dot3(i, h)
    fail = i_h <= 0.0

    fres = _fresnel3(color, metal, ior, i_h)
    sin2_i = (1.0 - i_h) * (1.0 + i_h)
    cos2_t = 1.0 - (eta * eta) * sin2_i
    total_reflection = cos2_t < 0.0

    force_reflect = total_reflection | (metal > 0.99)
    rr_f = torch.where(force_reflect, 1.0, fres[0])
    fres = _where3(force_reflect, (torch.ones_like(rr_f),) * 3, fres)
    is_reflect = u_coin < rr_f

    n_h = _dot3(normal, h)
    d = _ggx_d(alpha2, n_h)

    o_r = _normalize3(_sub3(_scale3(h, 2.0 * i_h), i))
    o_n_r = torch.clamp_min(_dot3(normal, o_r), 0.0)
    i_n_r = torch.clamp_min(i_dot_n, 0.0)
    g_r = _smith_g2(alpha2, i_n_r, o_n_r)
    spec = d * g_r / (4.0 * i_n_r * o_n_r * rr_f)
    brdf = _scale3(fres, spec)
    pdf_vndf_r = _smith_g1(alpha2, i_n_r) * d * torch.clamp_min(i_h, 0.0) / i_n_r
    pdf_r = pdf_vndf_r / (4.0 * torch.abs(i_h))

    cos_t = torch.sqrt(torch.clamp_min(cos2_t, 0.0))
    o_t = _normalize3(_sub3(_scale3(h, eta * i_h - cos_t), _scale3(i, eta)))
    o_h_t = _dot3(o_t, h)
    o_n_t = torch.abs(_dot3(normal, o_t))
    i_n_t = torch.abs(i_dot_n)
    denom_t = eta * i_h + o_h_t
    g_t = _smith_g2(alpha2, i_n_t, o_n_t)
    tt = d * g_t * torch.abs(i_h) * torch.abs(o_h_t) / (
        i_n_t * o_n_t * denom_t * denom_t * (1.0 - rr_f)
    )
    btdf = ((1.0 - fres[0]) * tt, (1.0 - fres[1]) * tt, (1.0 - fres[2]) * tt)
    jac = torch.abs(o_h_t) / (denom_t * denom_t)
    pdf_vndf_t = _smith_g1(alpha2, i_n_t) * d * torch.clamp_min(i_h, 0.0) / i_n_t
    pdf_t = pdf_vndf_t * jac

    o = _where3(is_reflect, o_r, o_t)
    bsdf = _where3(is_reflect, brdf, btdf)
    pdf = torch.where(is_reflect, pdf_r, pdf_t)
    cos = torch.where(is_reflect, o_n_r, o_n_t)

    bad = fail | ~_finite3(bsdf) | ~torch.isfinite(pdf) | (pdf <= 0.0)
    o = _where3(bad, normal, o)
    bsdf = _where3(bad, (0.0 * pdf,) * 3, bsdf)
    pdf = torch.where(bad, 1.0, pdf)
    cos = torch.where(bad, 0.0, cos)
    return o, bsdf, pdf, cos


def _eval_oren_nayar3(color, rough, i, o, normal):
    """Oren-Nayar bsdf and pdf toward ``o`` (the JAX ``_eval_oren_nayar3``,
    op for op ``ops/bsdf.py::_eval_oren_nayar``)."""
    sigma2 = rough * rough
    a = 1.0 - 0.5 * sigma2 / (sigma2 + 0.33)
    b = 0.45 * sigma2 / (sigma2 + 0.09)

    cos_i = torch.clamp_min(_dot3(i, normal), 0.0)
    cos_o = torch.clamp_min(_dot3(o, normal), 0.0)
    sin_i = torch.sqrt(torch.clamp_min(1.0 - cos_i * cos_i, 0.0))
    sin_o = torch.sqrt(torch.clamp_min(1.0 - cos_o * cos_o, 0.0))

    tangent, bitangent = _tangent_frame(normal)
    phi_i = torch.atan2(_dot3(i, bitangent), _dot3(i, tangent))
    phi_o = torch.atan2(_dot3(o, bitangent), _dot3(o, tangent))
    cos_phi_diff = torch.clamp_min(torch.cos(phi_i - phi_o), 0.0)

    # alpha = the larger angle, beta = the smaller, by the cosine comparison.
    i_steeper = cos_i > cos_o
    tan_beta = torch.where(
        i_steeper,
        torch.where(cos_i > 1e-6, sin_i / torch.clamp_min(cos_i, 1e-6), 0.0),
        torch.where(cos_o > 1e-6, sin_o / torch.clamp_min(cos_o, 1e-6), 0.0),
    )
    sin_alpha = torch.where(i_steeper, sin_o, sin_i)

    pi = _full_like(cos_i, _PI)
    term = (a + b * cos_phi_diff * sin_alpha * tan_beta) / pi
    return _scale3(color, term), cos_o / pi


def _eval_pbr3(color, rough, metal, ior, i, o, normal):
    """PBR bsdf and pdf toward ``o``: GGX specular reflection plus Oren-Nayar
    diffuse scaled by kd, the pdf a Fresnel-weighted blend of the two
    techniques (the JAX ``_eval_pbr3``, op for op ``ops/bsdf.py::_eval_pbr``)."""
    alpha = rough * rough
    alpha2 = alpha * alpha

    h = _normalize3(_add3(i, o))
    n_h = _dot3(normal, h)
    d_ggx = _ggx_d(alpha2, n_h)
    cos_i = torch.clamp_min(_dot3(i, normal), 0.0)
    cos_o = torch.clamp_min(_dot3(o, normal), 0.0)
    g2 = _smith_g2(alpha2, cos_i, cos_o)
    cos_f = torch.clamp_min(_dot3(i, h), 0.0)
    f = _fresnel3(color, metal, ior, cos_f)
    spec_brdf = _scale3(f, d_ggx * g2 / (4.0 * cos_i * cos_o))
    spec_pdf = d_ggx * torch.abs(n_h) / (4.0 * torch.abs(_dot3(i, h)))

    # Diffuse: Oren-Nayar x kd; metals do not diffuse.
    diff_raw, diff_pdf = _eval_oren_nayar3(color, rough, i, o, normal)
    not_metal = metal < 1.0
    one_m = 1.0 - metal
    diff_brdf = tuple(torch.where(not_metal, diff_raw[c] * (1.0 - f[c]) * one_m, 0.0)
                      for c in range(3))

    brdf = _add3(spec_brdf, diff_brdf)
    f_avg = (f[0] + f[1] + f[2]) / _full_like(cos_i, 3.0)
    sw = f_avg
    dw = (1.0 - f_avg) * one_m
    tw = sw + dw
    pdf = torch.where(tw > 1e-6, (sw * spec_pdf + dw * diff_pdf) / torch.clamp_min(tw, 1e-6),
                      spec_pdf)
    bad = (cos_o <= 0.0) | ~_finite3(brdf) | ~torch.isfinite(pdf)
    brdf = _where3(bad, (0.0 * pdf,) * 3, brdf)
    pdf = torch.where(bad, 1.0, pdf)
    return brdf, pdf


def _sample_pbr3(color, rough, metal, ior, i, normal, r1, r2, u_coin, d_diff):
    """PBR sample: a coin weighted by the approximate Fresnel picks the GGX
    VNDF reflection or the shared cosine sample ``d_diff``; the blended
    bsdf/pdf is evaluated there (the JAX ``_sample_pbr3``)."""
    cos_i = torch.clamp_min(_dot3(i, normal), 0.0)
    mean_c = (color[0] + color[1] + color[2]) / _full_like(cos_i, 3.0)
    f0s = torch.where(metal > 0.5, mean_c, 0.04)
    f_approx = f0s + (1.0 - f0s) * _pow5(1.0 - cos_i)
    sw = f_approx
    dw = (1.0 - f_approx) * (1.0 - metal)
    tw = sw + dw
    p_spec = torch.where(tw > 1e-6, sw / torch.clamp_min(tw, 1e-6), 1.0)
    use_spec = u_coin < p_spec

    h = _sample_vndf(i, normal, rough, r1, r2)
    o_spec = _normalize3(_sub3(_scale3(h, 2.0 * _dot3(i, h)), i))

    o = _where3(use_spec, o_spec, d_diff)
    bsdf, pdf = _eval_pbr3(color, rough, metal, ior, i, o, normal)
    cos = torch.clamp_min(_dot3(o, normal), 0.0)

    bad = ~_finite3(bsdf) | ~torch.isfinite(pdf) | (pdf <= 0.0)
    o = _where3(bad, normal, o)
    bsdf = _where3(bad, (0.0 * pdf,) * 3, bsdf)
    pdf = torch.where(bad, 1.0, pdf)
    cos = torch.where(bad, 0.0, cos)
    return o, bsdf, pdf, cos


def _tri_hits(tri, o3, d3, t_max, eps):
    """Moller-Trumbore of every lane against every triangle row: ``(ok, t)``,
    each ``(rows, S)``; ``ok`` means a hit with t in [eps, t_max]."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    v0x = tri[:, 0:1]; v0y = tri[:, 1:2]; v0z = tri[:, 2:3]
    e1x = tri[:, 3:4]; e1y = tri[:, 4:5]; e1z = tri[:, 5:6]
    e2x = tri[:, 6:7]; e2y = tri[:, 7:8]; e2z = tri[:, 8:9]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / a
    sx = ox - v0x; sy = oy - v0y; sz = oz - v0z
    uu = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    vv = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = (
        (torch.abs(a) >= 1e-8)
        & (uu >= 0.0) & (uu <= 1.0)
        & (vv >= 0.0) & (uu + vv <= 1.0)
        & (t >= eps) & (t <= t_max)
    )
    return ok, t


def _sphere_ts(sph, o3, d3, eps):
    """Per sphere row and lane, the near root if it is >= eps, else the far
    one: ``(rows, S)``, NaN on a miss and on padding rows (k = NaN)."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    od = _dot3(o3, d3)
    oo = _dot3(o3, o3)
    cx = sph[:, 0:1]; cy = sph[:, 1:2]; cz = sph[:, 2:3]
    k = sph[:, 3:4]
    cd = cx * dx + cy * dy + cz * dz
    co = cx * ox + cy * oy + cz * oz
    half_b = od - cd
    c = oo - 2.0 * co + k
    disc = half_b * half_b - c
    sq = torch.sqrt(disc)
    root1 = -half_b - sq
    return torch.where(root1 >= eps, root1, -half_b + sq)


def _select(table, arg, hit, col0, ncols):
    """Columns ``col0:col0+ncols`` of row ``arg`` per lane, zero where not
    ``hit`` (what the JAX kernel's one-hot select yields for an empty mask)."""
    rows = table[arg, col0:col0 + ncols].T              # (ncols, S)
    return torch.where(hit[None, :], rows, 0.0)


# ---------------------------------------------------------------------------
# The twins
# ---------------------------------------------------------------------------

def _raygen_state(raygen, u, ray_o, ray_d, eta, pdf_prev, prefix):
    """The raygen mode's prologue: the started lanes' jittered primary rays,
    with the op sequence of ``models/camera.py :: Camera.generate_rays`` (its
    divisors ``width - 1``/``height - 1`` as the 0-dim tensors
    ``cam_row[0, 6:8]``), and the five float merges of the pool's refill.
    Returns ``(o3, d3, eta, pdf_prev, pfx)``, the 3-vectors as tuples."""
    started, px, py, cam = raygen
    dtype = ray_o.dtype
    org = tuple(cam[0, c] for c in range(3))
    llc = tuple(cam[0, 3 + c] for c in range(3))
    hor = tuple(cam[1, c] for c in range(3))
    ver = tuple(cam[1, 3 + c] for c in range(3))
    uu = (px.to(dtype) + u[7]) / cam[0, 6]        # rng.SLOT_JITTER_X
    vv = (py.to(dtype) + u[8]) / cam[0, 7]        # rng.SLOT_JITTER_Y
    comps = [llc[c] + hor[c] * uu + ver[c] * vv - org[c] for c in range(3)]
    ln = torch.sqrt(comps[0] * comps[0] + comps[1] * comps[1] + comps[2] * comps[2])
    pos = ln > 0.0
    safe = torch.where(pos, ln, torch.ones_like(ln))
    cam_d = [torch.where(pos, c / safe, c) for c in comps]
    return (
        tuple(torch.where(started, org[c], ray_o[c]) for c in range(3)),
        tuple(torch.where(started, cam_d[c], ray_d[c]) for c in range(3)),
        torch.where(started, 1.0, eta),
        torch.where(started, 1.0, pdf_prev),
        tuple(torch.where(started, 1.0, prefix[c]) for c in range(3)),
    )


def fused_bounce_reference(
    tables: Tables, busy, bounce, ray_o, ray_d, eta, pdf_prev, prefix, u, *,
    num_tris: int, num_lights: int, integrator: str, max_bounces: int,
    eps: float = EPS, has_tri_lights: bool = True, has_sph_lights: bool = True,
    has_oren_nayar: bool = False, has_pbr: bool = False, raygen=None,
    fuse_shadow: bool = False,
) -> BounceResult:
    """Plain-torch twin of the ``fused_bounce`` kernel (same op order).

    ``num_tris`` is the scene's padded triangle row count: the global prim-id
    base of the spheres. ``has_oren_nayar``/``has_pbr`` (the scene's flags)
    add the Oren-Nayar and PBR lanes, as ``has_on``/``has_pbr`` do in the
    JAX kernel; without them those kinds shade as Lambert. ``raygen`` and
    ``fuse_shadow`` are the two modes of :func:`fused_bounce`.
    """
    flags = kernel_flags(integrator, has_tri_lights, has_sph_lights, has_oren_nayar, has_pbr)
    use_mis, use_nee = flags["use_mis"], flags["use_nee"]
    has_tri_l, has_sph_l = flags["has_tri_l"], flags["has_sph_l"]
    has_on, has_pbr = flags["has_on"], flags["has_pbr"]
    sph, tri, lgt = tables
    if raygen is None:
        o3 = (ray_o[0], ray_o[1], ray_o[2])
        d3 = (ray_d[0], ray_d[1], ray_d[2])
        eta_in = eta
        pfx = (prefix[0], prefix[1], prefix[2])
    else:
        o3, d3, eta_in, pdf_prev, pfx = _raygen_state(raygen, u, ray_o, ray_d, eta, pdf_prev,
                                                      prefix)
    ox, oy, oz = o3
    dx, dy, dz = d3

    # ---- 1. Closest hit: triangles (Moller-Trumbore), then spheres ----
    ok, t = _tri_hits(tri, o3, d3, _INF, eps)
    ts = torch.where(ok, t, _INF)
    tri_t, tri_arg = torch.min(ts, dim=0)       # first minimum, like argmin
    tri_hit = tri_t < _INF
    tn = _select(tri, tri_arg, tri_hit, _TC_N, 3)
    tmat = _select(tri, tri_arg, tri_hit, _TC_KIND, _MAT_COLS)

    t_c = _sphere_ts(sph, o3, d3, eps)
    oks = (t_c >= eps) & (t_c <= tri_t)
    tss = torch.where(oks, t_c, _INF)
    sph_t, sph_arg = torch.min(tss, dim=0)
    sph_hit = sph_t < tri_t                     # a triangle wins a tie
    sgeo = _select(sph, sph_arg, sph_hit, _SC_CX, 5)
    smat = _select(sph, sph_arg, sph_hit, _SC_KIND, _MAT_COLS)
    scx, scy, scz, sir = sgeo[0], sgeo[1], sgeo[2], sgeo[4]

    best_t = torch.where(sph_hit, sph_t, tri_t)
    hit_valid = sph_hit | tri_hit
    tt0 = torch.where(hit_valid, best_t, 0.0)
    point = (ox + tt0 * dx, oy + tt0 * dy, oz + tt0 * dz)
    outward = (
        torch.where(sph_hit, (point[0] - scx) * sir, tn[0]),
        torch.where(sph_hit, (point[1] - scy) * sir, tn[1]),
        torch.where(sph_hit, (point[2] - scz) * sir, tn[2]),
    )
    prim = torch.where(
        sph_hit, num_tris + sph_arg, torch.where(tri_hit, tri_arg, -1)
    )
    m = torch.where(sph_hit[None, :], smat, tmat)
    kind_i = m[0].to(torch.int32)
    m_col = (m[1], m[2], m[3])
    m_emi = (m[4], m[5], m[6])
    m_rough, m_metal, m_ior = m[7], m[8], m[9]

    front_face = _dot3(d3, outward) < 0.0
    normal = _where3(front_face, outward, _neg3(outward))

    # ---- 2. Emissive terminal rules ----
    emis = hit_valid & (kind_i == mat.KIND_EMISSIVE) & (_dot3(m_emi, m_emi) > 0.0)
    if not (use_mis or use_nee):  # brdf_only: lights visible at any depth
        emis_gain = m_emi
    else:
        if use_mis and num_lights > 0:
            # The hit primitive's light row (single light: row 0).
            if num_lights == 1:
                lsel = lgt[0, :_LC_EMI][:, None].expand(-1, ox.shape[0])
            else:
                match = lgt[:, _LC_PRIM:_LC_PRIM + 1] == prim.to(lgt.dtype)[None, :]
                lsel = _select(lgt, torch.argmax(match.to(torch.int32), 0),
                               match.any(0), 0, _LC_EMI)
            l_is_tri = lsel[_LC_ISTRI] > 0.5
            lpv = (lsel[_LC_P], lsel[_LC_P + 1], lsel[_LC_P + 2])
            l_rad = lsel[_LC_RAD]
            l_n = (lsel[_LC_N], lsel[_LC_N + 1], lsel[_LC_N + 2])
            l_area = lsel[_LC_AREA]
            if has_tri_l:
                to_l = _sub3(point, o3)
                dist_l = torch.sqrt(_dot3(to_l, to_l))
                safe_dl = torch.where(dist_l > 0.0, dist_l, 1.0)
                ldir_l = (to_l[0] / safe_dl, to_l[1] / safe_dl, to_l[2] / safe_dl)
                cos_light = torch.abs(_dot3(l_n, _neg3(ldir_l)))
                pdf_area = 1.0 / torch.clamp_min(l_area, 1e-20)
                pdf_tri = torch.where(
                    cos_light > 1e-8,
                    pdf_area * (dist_l * dist_l) / torch.clamp_min(cos_light, 1e-8),
                    1e-8,
                )
            if has_sph_l:
                to_c = _sub3(lpv, o3)
                dist_sq = _dot3(to_c, to_c)
                sin2_max = (l_rad * l_rad) / torch.where(dist_sq > 0.0, dist_sq, 1.0)
                cos_max = torch.sqrt(torch.clamp_min(1.0 - sin2_max, 0.0))
                solid = 2.0 * _PI * (1.0 - cos_max)
                pdf_sph = 1.0 / torch.clamp_min(solid, 1e-12)
            if has_tri_l and has_sph_l:
                pdf_shape = torch.where(l_is_tri, pdf_tri, pdf_sph)
            elif has_tri_l:
                pdf_shape = pdf_tri
            else:
                pdf_shape = pdf_sph
            # Quirk: the bsdf-side pdf is not divided by the light count.
            w_bsdf = pdf_prev / (pdf_prev + pdf_shape)
        else:
            w_bsdf = torch.zeros_like(pdf_prev)
        emis_gain = _where3(bounce == 0, m_emi, _scale3(m_emi, w_bsdf))

    gain = _forz3((pfx[0] * emis_gain[0], pfx[1] * emis_gain[1], pfx[2] * emis_gain[2]))
    zero3 = (0.0 * ox,) * 3
    rad = _where3(busy & emis, gain, zero3)

    shade = busy & hit_valid & ~emis & (bounce < max_bounces)
    i3 = _neg3(d3)
    u0, u1, u2, u3, u4, u5, u6 = (u[k] for k in range(7))

    # ---- 3. NEE: light pick, sample and BSDF evaluation ----
    if use_nee and num_lights > 0:
        if num_lights == 1:
            psel = lgt[0, :_LC_PRIM][:, None].expand(-1, ox.shape[0])
        else:
            lidx = torch.clamp_max((u0 * num_lights).to(torch.int32), num_lights - 1)
            psel = lgt[lidx.long(), :_LC_PRIM].T
        p_is_tri = psel[_LC_ISTRI] > 0.5
        p_p = (psel[_LC_P], psel[_LC_P + 1], psel[_LC_P + 2])
        p_rad = psel[_LC_RAD]
        p_e1 = (psel[_LC_E1], psel[_LC_E1 + 1], psel[_LC_E1 + 2])
        p_e2 = (psel[_LC_E2], psel[_LC_E2 + 1], psel[_LC_E2 + 2])
        p_n = (psel[_LC_N], psel[_LC_N + 1], psel[_LC_N + 2])
        p_area = psel[_LC_AREA]
        p_emi = (psel[_LC_EMI], psel[_LC_EMI + 1], psel[_LC_EMI + 2])

        if has_tri_l:
            # Triangle: sqrt-warp area sample.
            sqrt_r1 = torch.sqrt(u1)
            wu = 1.0 - sqrt_r1
            wv = u2 * sqrt_r1
            lp_tri = _add3(_add3(p_p, _scale3(p_e1, wu)), _scale3(p_e2, wv))
        if has_sph_l:
            # Sphere: uniform cone direction, re-intersected.
            to_c = _sub3(p_p, point)
            dist_sq = _dot3(to_c, to_c)
            rad_sq = p_rad * p_rad
            sin2_max = rad_sq / torch.where(dist_sq > 0.0, dist_sq, 1.0)
            cos_max = torch.sqrt(torch.clamp_min(1.0 - sin2_max, 0.0))
            solid = 2.0 * _PI * (1.0 - cos_max)
            pdf_sph = 1.0 / torch.clamp_min(solid, 1e-12)
            cth = 1.0 - u1 + u1 * cos_max
            sth = torch.sqrt(torch.clamp_min(1.0 - cth * cth, 0.0))
            phi = 2.0 * _PI * u2
            ln_c = torch.sqrt(dist_sq)
            pos_c = ln_c > 0.0
            safe_c = torch.where(pos_c, ln_c, 1.0)
            wdir = tuple(torch.where(pos_c, c / safe_c, c) for c in to_c)
            wy_big = torch.abs(wdir[1]) > 0.999
            onec = torch.ones_like(wdir[0])
            zeroc = torch.zeros_like(wdir[0])
            upv = (torch.where(wy_big, onec, zeroc), torch.where(wy_big, zeroc, onec), zeroc)
            uax = _normalize3(_cross3(upv, wdir))
            vax = _cross3(wdir, uax)
            cone = _normalize3(
                _add3(
                    _add3(_scale3(uax, sth * torch.cos(phi)),
                          _scale3(vax, sth * torch.sin(phi))),
                    _scale3(wdir, cth),
                )
            )
            ocv = _neg3(to_c)
            a_q = _dot3(cone, cone)
            hb_q = _dot3(ocv, cone)
            c_q = dist_sq - rad_sq
            disc_q = hb_q * hb_q - a_q * c_q
            t_q = (-hb_q - torch.sqrt(torch.clamp_min(disc_q, 0.0))) / a_q
            lp_sph = _add3(point, _scale3(cone, t_q))

        if has_tri_l and has_sph_l:
            lpoint = _where3(p_is_tri, lp_tri, lp_sph)
            lnorm = _where3(p_is_tri, p_n, _normalize3(_sub3(lp_sph, p_p)))
        elif has_tri_l:
            lpoint, lnorm = lp_tri, p_n
        else:
            lpoint, lnorm = lp_sph, _normalize3(_sub3(lp_sph, p_p))

        to_light = _sub3(lpoint, point)
        ldist = torch.sqrt(_dot3(to_light, to_light))
        safe_ld = torch.where(ldist > 0.0, ldist, 1.0)
        ldir = (to_light[0] / safe_ld, to_light[1] / safe_ld, to_light[2] / safe_ld)

        if has_tri_l:
            cos_li = torch.abs(_dot3(lnorm, _neg3(ldir)))
            pdf_area = 1.0 / torch.clamp_min(p_area, 1e-20)
            pdf_tri = torch.where(
                cos_li > 1e-8,
                pdf_area * (ldist * ldist) / torch.clamp_min(cos_li, 1e-8),
                1e-8,
            )
        if has_tri_l and has_sph_l:
            ls_pdf = torch.where(p_is_tri, pdf_tri, pdf_sph)
        elif has_tri_l:
            ls_pdf = pdf_tri
        else:
            ls_pdf = pdf_sph
        ls_pdf = ls_pdf / _full_like(ls_pdf, num_lights)

        ldir_n = _dot3(ldir, normal)
        cos_l = torch.abs(ldir_n)
        lam_b = _scale3(m_col, 1.0 / _PI)
        lam_p = torch.clamp_min(ldir_n, 0.0) * (1.0 / _PI)
        mir_b, mir_p = _eval_mirror(m_col, m_rough, m_metal, m_ior, i3, ldir, normal, eta_in)
        is_mir = kind_i == mat.KIND_MIRROR
        bsdf_l = _where3(is_mir, mir_b, lam_b)
        pdf_l = torch.where(is_mir, mir_p, lam_p)
        if has_on:
            on_b, on_p = _eval_oren_nayar3(m_col, m_rough, i3, ldir, normal)
            is_on = kind_i == mat.KIND_OREN_NAYAR
            bsdf_l = _where3(is_on, on_b, bsdf_l)
            pdf_l = torch.where(is_on, on_p, pdf_l)
        if has_pbr:
            pbr_b, pbr_p = _eval_pbr3(m_col, m_rough, m_metal, m_ior, i3, ldir, normal)
            is_pbr = kind_i == mat.KIND_PBR
            bsdf_l = _where3(is_pbr, pbr_b, bsdf_l)
            pdf_l = torch.where(is_pbr, pbr_p, pdf_l)
        is_em_k = kind_i == mat.KIND_EMISSIVE
        bsdf_l = _where3(is_em_k, zero3, bsdf_l)
        pdf_l = torch.where(is_em_k, 1.0, pdf_l)

        w_nee = ls_pdf / (ls_pdf + pdf_l) if use_mis else torch.ones_like(ls_pdf)
        cscale = cos_l / ls_pdf
        direct = _forz3(tuple(w_nee * bsdf_l[c] * p_emi[c] * cscale for c in range(3)))
        sdir = ldir
        stmax = torch.where(shade, ldist - eps, -1.0)
    else:
        direct = zero3
        sdir = (0.0 * ox + 1.0,) * 3
        stmax = 0.0 * ox - 1.0

    # ---- 4. BSDF sample, Russian roulette, next state ----
    eta_s = torch.where(front_face, 1.0 / m_ior, m_ior)
    d_diff = _cosine_hemisphere(normal, u3, u4)
    lam_b = _scale3(m_col, 1.0 / _PI)
    lam_p = torch.clamp_min(_dot3(d_diff, normal), 0.0) * (1.0 / _PI)
    cos_diff = torch.clamp_min(_dot3(d_diff, normal), 0.0)
    mo, mb, mp, mc = _sample_mirror(
        m_col, m_rough, m_metal, m_ior, i3, normal, eta_s, u3, u4, u5
    )
    is_mir = kind_i == mat.KIND_MIRROR
    o_dir = _where3(is_mir, mo, d_diff)
    bsdf_s = _where3(is_mir, mb, lam_b)
    pdf_s = torch.where(is_mir, mp, lam_p)
    cos_s = torch.where(is_mir, mc, cos_diff)
    if has_on:
        # The shared cosine sample: only the evaluated brdf/pdf differ.
        on_b, on_p = _eval_oren_nayar3(m_col, m_rough, i3, d_diff, normal)
        is_on = kind_i == mat.KIND_OREN_NAYAR
        bsdf_s = _where3(is_on, on_b, bsdf_s)
        pdf_s = torch.where(is_on, on_p, pdf_s)
    if has_pbr:
        pbr_o, pbr_b, pbr_p, pbr_c = _sample_pbr3(
            m_col, m_rough, m_metal, m_ior, i3, normal, u3, u4, u5, d_diff)
        is_pbr = kind_i == mat.KIND_PBR
        o_dir = _where3(is_pbr, pbr_o, o_dir)
        bsdf_s = _where3(is_pbr, pbr_b, bsdf_s)
        pdf_s = torch.where(is_pbr, pbr_p, pdf_s)
        cos_s = torch.where(is_pbr, pbr_c, cos_s)
    is_em_k = kind_i == mat.KIND_EMISSIVE
    o_dir = _where3(is_em_k, normal, o_dir)
    bsdf_s = _where3(is_em_k, zero3, bsdf_s)
    pdf_s = torch.where(is_em_k, 1.0, pdf_s)
    cos_s = torch.where(is_em_k, 0.0, cos_s)

    fscale = cos_s / pdf_s
    factor = _scale3(bsdf_s, fscale)
    next_tp = (pfx[0] * factor[0], pfx[1] * factor[1], pfx[2] * factor[2])

    lum = torch.clamp_max(_luminance3(_forz3(next_tp)), 1.0)
    decay = torch.exp2(-torch.clamp_min(bounce - RR_MIN_DEPTH, 0).to(lum.dtype))
    rr = torch.where(
        bounce < RR_MIN_DEPTH,
        torch.ones_like(lum),
        torch.where(bounce >= RR_MAX_DEPTH, lum * decay, lum),
    )
    live = shade & (u6 < rr)

    stmax = torch.where(live, stmax, -1.0)
    if fuse_shadow:
        # The live lanes' shadow rays swept here; the visibility zeroes the
        # direct light, which counts only for RR survivors.
        if use_nee and num_lights > 0:
            blocked = _occluded(sph, tri, point, sdir, stmax, eps)
            direct = _forz3(_where3(blocked, zero3, direct))
        dgain = _forz3((pfx[0] * direct[0], pfx[1] * direct[1], pfx[2] * direct[2]))
        rad = _add3(rad, _where3(live, dgain, zero3))
        dout = zero3
    else:
        # Split mode: export prefix * direct; the caller applies visibility
        # and `live` (NEE counts only for RR survivors).
        dout = _forz3((pfx[0] * direct[0], pfx[1] * direct[1], pfx[2] * direct[2]))
    new_pfx = _forz3((next_tp[0] / rr, next_tp[1] / rr, next_tp[2] / rr))

    def sel3(a, b):
        return torch.stack(_where3(live, a, b))

    return BounceResult(
        rad_delta=torch.stack(rad),
        next_o=sel3(point, o3),
        next_d=sel3(o_dir, d3),
        next_eta=torch.where(live, eta_s, eta_in),
        next_pdf=torch.where(live, pdf_s, pdf_prev),
        next_prefix=sel3(new_pfx, pfx),
        live=live,
        shade=shade,
        nee_gain=torch.stack(dout),
        shadow_d=torch.stack(sdir),
        shadow_tmax=stmax,
    )


def _occluded(sph, tri, o3, d3, t_max, eps):
    """Any triangle or sphere row hit with t in [eps, t_max], per lane."""
    ok_t, _ = _tri_hits(tri, o3, d3, t_max, eps)
    t_c = _sphere_ts(sph, o3, d3, eps)
    ok_s = (t_c >= eps) & (t_c <= t_max)
    return ok_t.any(0) | ok_s.any(0)


def shadow_any_hit_reference(tables: Tables, o, d, t_max, *, eps: float = EPS):
    """Plain-torch twin of the ``shadow_any_hit`` kernel: bool ``(S,)``."""
    return _occluded(tables.sph, tables.tri, (o[0], o[1], o[2]), (d[0], d[1], d[2]), t_max,
                     eps)


# ---------------------------------------------------------------------------
# Dispatching wrappers
# ---------------------------------------------------------------------------

def _float_dtype(x) -> torch.dtype:
    """The float dtype of a call, from its first float input: float32 or
    float64, the two the kernels have instances for."""
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"expected float32 or float64, got {x.dtype}")
    return x.dtype


def _check_tables(tables: Tables, device, dtype=torch.float32):
    _check("tables.sph", tables.sph, dtype, (tables.sph.shape[0], _SPH_COLS))
    _check("tables.tri", tables.tri, dtype, (tables.tri.shape[0], _TRI_COLS))
    _check("tables.lgt", tables.lgt, dtype, (tables.lgt.shape[0], _LGT_COLS))
    if (tables.sph.shape[0] > _round8(MAX_SPHERES) or tables.tri.shape[0] > _round8(MAX_TRIS)
            or tables.lgt.shape[0] > _round8(MAX_LIGHTS)):
        raise ValueError("scene tables exceed the kernels' size caps (supports_scene)")
    for tname, tab in zip(("sph", "tri", "lgt"), tables):
        if tab.device != device:
            raise ValueError(f"tables.{tname} on {tab.device}, rays on {device}")


def launch_name(raygen: bool, fuse_shadow: bool, on_pbr: bool, dtype) -> str:
    """The :data:`LAUNCHES` key of a ``fused_bounce`` launch in these modes."""
    return ("fused_bounce" + "_raygen" * bool(raygen) + "_shadow" * bool(fuse_shadow)
            + "_on_pbr" * bool(on_pbr) + _SUFFIX[dtype])


def fused_bounce(
    tables: Tables, busy, bounce, ray_o, ray_d, eta, pdf_prev, prefix, u, *,
    num_tris: int, num_lights: int, integrator: str, max_bounces: int,
    eps: float = EPS, has_tri_lights: bool = True, has_sph_lights: bool = True,
    has_oren_nayar: bool = False, has_pbr: bool = False, raygen=None,
    fuse_shadow: bool = False,
) -> BounceResult:
    """One full path vertex for every lane (see the module docstring).

    ``busy`` bool ``(S,)``, ``bounce`` int32 ``(S,)``, ``ray_o``/``ray_d``/
    ``prefix`` ``(3, S)``, ``eta``/``pdf_prev`` ``(S,)``, ``u`` ``(9, S)``,
    all float32 or all float64 with the tables. CPU tensors run
    :func:`fused_bounce_reference`; CUDA tensors launch the kernel's
    instance for the dtype and the modes.

    ``raygen``: ``(started bool (S,), px int32 (S,), py int32 (S,), cam_row
    (2, 8))``, the JAX contract: ``ray_o``/``ray_d``/``eta``/``pdf_prev``/
    ``prefix`` are the state from before the refill, ``busy``/``bounce`` the
    merged ones, ``px``/``py`` the started lanes' pixel (``py`` flipped), and
    ``cam_row`` the camera in the float dtype, ``[origin, lower_left,
    width - 1, height - 1]`` over ``[horizontal, vertical, 0, 0]``
    (``pool.camera_row``). ``fuse_shadow``: sweep the shadow rays here (see
    :class:`BounceResult`).
    """
    if integrator not in ("mis", "nee", "brdf_only"):
        raise ValueError(f"unknown integrator {integrator!r}")
    S = busy.shape[0]
    _check("busy", busy, torch.bool, (S,))
    _check("bounce", bounce, torch.int32, (S,))
    dtype = _float_dtype(ray_o)
    for name, x, shape in (("ray_o", ray_o, (3, S)), ("ray_d", ray_d, (3, S)),
                           ("eta", eta, (S,)), ("pdf_prev", pdf_prev, (S,)),
                           ("prefix", prefix, (3, S)), ("u", u, (9, S))):
        _check(name, x, dtype, shape)
    inputs = [bounce, ray_o, ray_d, eta, pdf_prev, prefix, u]
    if raygen is not None:
        if not isinstance(raygen, (tuple, list)) or len(raygen) != 4:
            raise ValueError("raygen: expected (started, px, py, cam_row)")
        raygen = tuple(raygen)
        for name, x, x_dtype, shape in zip(
                ("raygen started", "raygen px", "raygen py", "raygen cam_row"), raygen,
                (torch.bool, torch.int32, torch.int32, dtype), ((S,), (S,), (S,), (2, 8))):
            _check(name, x, x_dtype, shape)
        inputs += raygen
    kw = dict(num_tris=num_tris, num_lights=num_lights, integrator=integrator,
              max_bounces=max_bounces, eps=eps, has_tri_lights=has_tri_lights,
              has_sph_lights=has_sph_lights, has_oren_nayar=has_oren_nayar, has_pbr=has_pbr)
    device = busy.device
    for x in inputs:
        if x.device != device:
            raise ValueError(f"inputs on {x.device} and {device}")
    _check_tables(tables, device, dtype)
    if _device_kind(busy) == "cpu":
        return fused_bounce_reference(
            tables, busy, bounce, ray_o, ray_d, eta, pdf_prev, prefix, u, raygen=raygen,
            fuse_shadow=bool(fuse_shadow), **kw)

    from ..kernels import binding

    def empty(shape, out_dtype=dtype):
        return torch.empty(shape, dtype=out_dtype, device=device)

    out = BounceResult(
        rad_delta=empty((3, S)), next_o=empty((3, S)), next_d=empty((3, S)),
        next_eta=empty((S,)), next_pdf=empty((S,)), next_prefix=empty((3, S)),
        live=empty((S,), torch.bool), shade=empty((S,), torch.bool),
        nee_gain=empty((3, S)), shadow_d=empty((3, S)), shadow_tmax=empty((S,)),
    )
    binding.launch_fused_bounce(
        tables, busy, bounce, ray_o, ray_d, eta, pdf_prev, prefix, u, out,
        num_tris=num_tris, num_lights=num_lights, max_bounces=max_bounces, eps=eps,
        raygen=raygen, fuse_shadow=bool(fuse_shadow),
        **kernel_flags(integrator, has_tri_lights, has_sph_lights, has_oren_nayar, has_pbr))
    LAUNCHES[launch_name(raygen is not None, fuse_shadow, has_oren_nayar or has_pbr,
                         dtype)] += 1
    return out


def shadow_any_hit(tables: Tables, o, d, t_max, *, eps: float = EPS):
    """Occlusion of shadow rays ``o``/``d`` ``(3, S)`` over ``[eps, t_max]``
    (``t_max`` ``(S,)``; below ``eps`` means no query), all float32 or all
    float64 with the tables. Returns bool ``(S,)``. Counterpart of
    ``any_hit_quad`` (in float64, of the JAX ``any_hit`` the JAX pool takes
    there: the same hit criteria)."""
    S = t_max.shape[0]
    dtype = _float_dtype(o)
    _check("o", o, dtype, (3, S))
    _check("d", d, dtype, (3, S))
    _check("t_max", t_max, dtype, (S,))
    device = t_max.device
    if o.device != device or d.device != device:
        raise ValueError("o, d and t_max must share a device")
    _check_tables(tables, device, dtype)
    if _device_kind(t_max) == "cpu":
        return shadow_any_hit_reference(tables, o, d, t_max, eps=eps)

    from ..kernels import binding

    occ = torch.empty((S,), dtype=torch.bool, device=device)
    binding.launch_shadow_any_hit(tables, o, d, t_max, occ, eps=eps)
    LAUNCHES["shadow_any_hit" + _SUFFIX[dtype]] += 1
    return occ
