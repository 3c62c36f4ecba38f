"""GGX microfacet metal or dielectric (upstream ``mirror.rs``): VNDF
half-vector sampling (Heitz), Schlick Fresnel with F0 between the
dielectric's and the tint, a Fresnel coin between reflection and
refraction, height-correlated Smith G2. A metal (metallic > 0.99) never
transmits."""

from __future__ import annotations

import math

import torch

from ptbench import refmath as rm


def _ggx_d(alpha2, n_dot_h):
    # nh^2 (a^2 - 1) + 1 as a^2 c^2 + (1 - c)(1 + c): no cancellation at c -> 1.
    c = torch.clamp_max(torch.abs(n_dot_h), 1.0)
    den = alpha2 * c * c + (1.0 - c) * (1.0 + c)
    return alpha2 / (math.pi * den * den)


def _g1(alpha2, cos):
    g = 2.0 * cos / (cos + torch.sqrt(alpha2 + (1.0 - alpha2) * cos * cos))
    return torch.where(cos > 0.0, g, 0.0)


def _g2(alpha2, cos_i, cos_o):
    def lam(c):
        return (torch.sqrt(alpha2 + (1.0 - alpha2) * c * c) - c) / (2.0 * c)

    g = 1.0 / (1.0 + lam(cos_i) + lam(cos_o))
    return torch.where((cos_i > 0.0) & (cos_o > 0.0), g, 0.0)


def _fresnel(m, cos):
    f0d = ((1.0 - m["ior"]) / (1.0 + m["ior"])) ** 2
    f0 = f0d[:, None] * (1.0 - m["metallic"])[:, None] + m["color"] * m["metallic"][:, None]
    return f0 + (1.0 - f0) * ((1.0 - cos) ** 5)[:, None]


def _vndf(view, n, roughness, r1, r2):
    """A half vector drawn from the visible normals of the GGX lobe."""
    alpha = roughness * roughness
    t, b = rm.tangent_frame(n)
    vl = torch.stack([rm.dot(view, t), rm.dot(view, b), rm.dot(view, n)], dim=1)
    vh = rm.normalize(torch.stack([alpha * vl[:, 0], alpha * vl[:, 1], vl[:, 2]], dim=1))
    lensq = vh[:, 0] ** 2 + vh[:, 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp_min(lensq, 1e-38))
    t1 = torch.where((lensq > 0.0)[:, None],
                     torch.stack([-vh[:, 1] * inv, vh[:, 0] * inv, torch.zeros_like(inv)], 1),
                     rm.axis(vh, 0))
    t2 = rm.cross(vh, t1)
    r = torch.sqrt(r1)
    phi = 2.0 * math.pi * r2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[:, 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - p1 * p1, 0.0)) + s * p2
    nh = (t1 * p1[:, None] + t2 * p2[:, None]
          + vh * torch.sqrt(torch.clamp_min(1.0 - p1 * p1 - p2 * p2, 0.0))[:, None])
    ne = rm.normalize(torch.stack([alpha * nh[:, 0], alpha * nh[:, 1],
                                   torch.clamp_min(nh[:, 2], 0.0)], dim=1))
    return rm.normalize(t * ne[:, 0:1] + b * ne[:, 1:2] + n * ne[:, 2:3])


def eval(m, i, o, n, eta):
    alpha = m["roughness"] * m["roughness"]
    alpha2 = alpha * alpha
    i_n = rm.dot(i, n)
    o_n = rm.dot(o, n)
    reflect = i_n * o_n > 0.0

    h = rm.normalize(i + o)
    nh = rm.dot(n, h)
    d = _ggx_d(alpha2, nh)
    ci, co = torch.clamp_min(i_n, 0.0), torch.clamp_min(o_n, 0.0)
    f = _fresnel(m, torch.clamp_min(rm.dot(i, h), 0.0))
    brdf = f * (d * _g2(alpha2, ci, co) / (4.0 * ci * co))[:, None]
    pdf_r = d * torch.abs(nh) / (4.0 * torch.abs(rm.dot(i, h)))

    ht = -rm.normalize(i * eta[:, None] + o)
    nht = rm.dot(n, ht)
    dt = _ggx_d(alpha2, nht)
    ai, ao = torch.abs(i_n), torch.abs(o_n)
    iht, oht = rm.dot(i, ht), rm.dot(o, ht)
    den = eta * iht + oht
    ft = _fresnel(m, torch.abs(iht))
    btdf = (1.0 - ft) * (dt * _g2(alpha2, ai, ao) * torch.abs(iht) * torch.abs(oht)
                         / (ai * ao * den * den))[:, None]
    pdf_t = dt * torch.abs(nht) * (torch.abs(oht) / (den * den))

    bsdf = torch.where(reflect[:, None], brdf, btdf)
    pdf = torch.where(reflect, pdf_r, pdf_t)
    blocked = (m["metallic"] > 0.99) & ~reflect
    return torch.where(blocked[:, None], 0.0, bsdf), torch.where(blocked, 1.0, pdf)


def sample(m, i, n, eta, r1, r2, coin):
    alpha = m["roughness"] * m["roughness"]
    alpha2 = alpha * alpha
    i_n = rm.dot(i, n)
    h = _vndf(i, n, m["roughness"], r1, r2)
    ih = rm.dot(i, h)
    fresnel = _fresnel(m, ih)
    sin2_i = (1.0 - ih) * (1.0 + ih)
    cos2_t = 1.0 - (eta * eta) * sin2_i
    forced = (cos2_t < 0.0) | (m["metallic"] > 0.99)
    p_reflect = torch.where(forced, 1.0, fresnel[:, 0])
    fresnel = torch.where(forced[:, None], 1.0, fresnel)
    is_reflect = coin < p_reflect
    d = _ggx_d(alpha2, rm.dot(n, h))

    o_r = rm.normalize(2.0 * ih[:, None] * h - i)
    on_r = torch.clamp_min(rm.dot(n, o_r), 0.0)
    in_r = torch.clamp_min(i_n, 0.0)
    brdf = fresnel * (d * _g2(alpha2, in_r, on_r) / (4.0 * in_r * on_r * p_reflect))[:, None]
    pdf_r = _g1(alpha2, in_r) * d * torch.clamp_min(ih, 0.0) / in_r / (4.0 * torch.abs(ih))

    cos_t = torch.sqrt(torch.clamp_min(cos2_t, 0.0))
    o_t = rm.normalize(h * (eta * ih - cos_t)[:, None] - i * eta[:, None])
    oh_t = rm.dot(o_t, h)
    on_t = torch.abs(rm.dot(n, o_t))
    in_t = torch.abs(i_n)
    den = eta * ih + oh_t
    btdf = (1.0 - fresnel) * (d * _g2(alpha2, in_t, on_t) * torch.abs(ih) * torch.abs(oh_t)
                              / (in_t * on_t * den * den * (1.0 - p_reflect)))[:, None]
    pdf_t = _g1(alpha2, in_t) * d * torch.clamp_min(ih, 0.0) / in_t * (torch.abs(oh_t)
                                                                       / (den * den))

    o = torch.where(is_reflect[:, None], o_r, o_t)
    bsdf = torch.where(is_reflect[:, None], brdf, btdf)
    pdf = torch.where(is_reflect, pdf_r, pdf_t)
    cos = torch.where(is_reflect, on_r, on_t)
    bad = (ih <= 0.0) | ~torch.isfinite(bsdf).all(dim=1) | ~torch.isfinite(pdf) | (pdf <= 0.0)
    return (torch.where(bad[:, None], n, o), torch.where(bad[:, None], 0.0, bsdf),
            torch.where(bad, 1.0, pdf), torch.where(bad, 0.0, cos))
