"""Wavefront path-tracing integrators.

Counterpart of ``pathtrace_tpu/integrators.py``, same estimator and op
order. The whole wave advances together, one bounce per step of a Python
loop (the JAX ``lax.while_loop``), with alive masks: per bounce one shadow
trace per light sample and one peek trace, and the peek is the next
bounce's hit. The loop ends at ``max_bounces`` or when no lane is alive
(tested on the host every bounce; a bounce with no live lane would change
neither the radiance nor the ray count).

The reference's two quirks are kept:

1. Russian-roulette termination discards the NEE direct light gathered at
   the current vertex: ``direct`` counts only if the ray survives RR.
2. The balance-heuristic bsdf-side pdf is not divided by the light count
   while the NEE-side pdf is.

Lights are camera-visible only at depth 0 under MIS and NEE, at every depth
under BRDF-only; RR is 1 below depth 4, the throughput luminance capped at 1
above, decayed by 2^-(depth - 4) from depth 50; ray t_min is 1e-3 and the
shadow t_max is ``dist - 1e-3``; a vertex's NEE evaluates with the eta set at
the previous vertex, its BSDF sample with its own.

Every intersection goes through ``ops/intersect.py`` on the route of the
scene's tables (the small, flat or BVH kernels; their twins on the CPU).
Everything runs in the rays' dtype, the uniforms included (float64: the
small route only).

Each bounce and its steps are spans of :mod:`~pathtrace_tpu_torch.profiler`
(``wave.bounce`` with ``wave.rng``, ``wave.nee``, ``wave.scatter`` and
``wave.peek``; the calls into ``ops/intersect.py``, ``ops/lights.py`` and
``ops/bsdf.py`` as ``intersect``, ``lights`` and ``bsdf``; the host syncs
``sync.wave_alive``, ``sync.wave_rays`` and ``sync.h2d``, a copy of a host
constant), recorded only while tracing.
"""

from __future__ import annotations

import torch

from . import profiler
from .models.scene import Scene
from .ops import bsdf, intersect, lights
from .ops.shade import EPS, RR_MAX_DEPTH, RR_MIN_DEPTH, _full_like
from .utils import rng, vec

INTEGRATORS = ("mis", "nee", "brdf_only")


def _rr_probability(bounce: int, next_tp):
    """Russian-roulette survival at depth ``bounce``: 1 below RR_MIN_DEPTH,
    then the throughput luminance capped at 1, decayed by 2^-(bounce - 4)
    from RR_MAX_DEPTH on."""
    lum = torch.clamp_max(vec.luminance(vec.finite_or_zero(next_tp)), 1.0)
    if bounce < RR_MIN_DEPTH:
        return torch.ones_like(lum)
    if bounce >= RR_MAX_DEPTH:
        return lum * 2.0 ** -(bounce - RR_MIN_DEPTH)
    return lum


def _any_alive(alive) -> bool:
    """The loop's test of the wave's live lanes: a host sync."""
    with profiler.span("sync.wave_alive"):
        return bool(alive.any())


def trace_wave(
    scene: Scene,
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    keys,
    integrator: str = "mis",
    max_bounces: int = 64,
    return_stats: bool = False,
    num_light_samples: int = 1,
    tables: intersect.Tables | None = None,
):
    """Radiance ``(N, 3)`` for a wave of primary rays ``(N, 3)``, or
    ``(radiance, ray_queries)`` when ``return_stats``: the number of
    scene-traversal queries issued (primary + shadow + peek), the numerator
    of the Mrays/s metric.

    ``keys``: per-ray threefry keys ``(pixel, sample)`` (``rng.pixel_sample_keys``);
    bounce indices are folded in here, so results do not depend on how
    waves are batched. ``num_light_samples``: NEE light samples per vertex,
    averaged (ignored by ``brdf_only``). ``tables``: the scene packed by
    ``intersect.build_tables`` (built here when not given).
    """
    if integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator {integrator!r}; expected {INTEGRATORS}")
    if num_light_samples < 1:
        raise ValueError("num_light_samples must be >= 1")
    if tables is None:
        tables = intersect.build_tables(scene)
    if integrator == "brdf_only":
        radiance, rays = _trace_brdf_only(scene, tables, ray_o, ray_d, keys, max_bounces)
    else:
        radiance, rays = _trace_nee_mis(scene, tables, ray_o, ray_d, keys, max_bounces,
                                        integrator == "mis", num_light_samples)
    if not return_stats:
        return radiance
    with profiler.span("sync.wave_rays"):
        return radiance, int(rays)


def _trace_nee_mis(scene, tables, ray_o, ray_d, keys, max_bounces, use_mis,
                   num_light_samples):
    with profiler.span("intersect"):
        hit = intersect.intersect(tables, ray_o, ray_d, EPS, float("inf"))
    with profiler.span("bsdf"):
        mp = bsdf.mat_of(scene, hit.mat)
        emis0 = hit.valid & bsdf.is_emissive_params(mp)
        emitted = bsdf.emitted_params(mp)
    # Lights are visible to the camera only (depth 0).
    radiance = torch.where(emis0[:, None], emitted, 0.0)
    alive = hit.valid & ~emis0
    ray_eta = torch.ones_like(ray_d[:, 0])
    prefix = torch.ones_like(ray_d)
    rays = profiler.from_host(ray_o, ray_o.shape[0], torch.int64)
    light_keys = [keys] + [rng.light_sample_keys(keys, j) for j in range(1, num_light_samples)]

    def nee_once(u_l, i):
        with profiler.span("wave.nee"):
            with profiler.span("lights"):
                ls = lights.sample_light_point(
                    scene, hit.point, u_l[:, rng.SLOT_LIGHT_SELECT], u_l[:, rng.SLOT_LIGHT_U],
                    u_l[:, rng.SLOT_LIGHT_V])
            with profiler.span("intersect"):
                blocked = intersect.occluded(tables, hit.point, ls.dir, EPS, ls.dist - EPS)
            cos_l = torch.abs(vec.dot(hit.normal, ls.dir))
            with profiler.span("bsdf"):
                bsdf_l, pdf_bsdf_l = bsdf.eval_bsdf(scene, hit.mat, i, ray_eta, ls.dir,
                                                    hit.normal, params=mp)
            w_nee = ls.pdf / (ls.pdf + pdf_bsdf_l) if use_mis else torch.ones_like(ls.pdf)
            d = w_nee[:, None] * bsdf_l * ls.emission * (cos_l / ls.pdf)[:, None]
            return vec.finite_or_zero(torch.where(blocked[:, None], 0.0, d))

    def uniforms(k):
        with profiler.span("wave.rng"):
            return rng.bounce_uniforms(k, bounce, ray_d.dtype)

    bounce = 0
    while bounce < max_bounces and _any_alive(alive):
        with profiler.span("wave.bounce"):
            i = -ray_d
            u = uniforms(keys)
            direct = nee_once(u, i)
            for kj in light_keys[1:]:
                direct = direct + nee_once(uniforms(kj), i)
            if num_light_samples > 1:
                direct = direct / _full_like(direct, num_light_samples)

            # BSDF sample, Russian roulette; quirk 1: direct counts only on survival.
            with profiler.span("wave.scatter"):
                with profiler.span("bsdf"):
                    eta_s = bsdf.eta_ratio(scene, hit.mat, hit.front_face, params=mp)
                    o_dir, bsdf_s, pdf_s, cos_s = bsdf.sample_bsdf(
                        scene, hit.mat, i, eta_s, hit.normal, u[:, rng.SLOT_BSDF_U],
                        u[:, rng.SLOT_BSDF_V], u[:, rng.SLOT_FRESNEL], params=mp)
                factor = bsdf_s * (cos_s / pdf_s)[:, None]
                rr = _rr_probability(bounce, prefix * factor)
                live = alive & (u[:, rng.SLOT_RR] < rr)
                radiance = radiance + torch.where(
                    live[:, None], vec.finite_or_zero(prefix * direct), 0.0)

            # Peek: the BSDF ray's hit, which is also the next bounce's hit.
            with profiler.span("wave.peek"):
                with profiler.span("intersect"):
                    peek = intersect.intersect(tables, hit.point, o_dir, EPS, float("inf"))
                with profiler.span("bsdf"):
                    peek_mp = bsdf.mat_of(scene, peek.mat)
                    peek_emis = peek.valid & bsdf.is_emissive_params(peek_mp)
                if use_mis:
                    # Quirk 2: pdf_shape without the 1/num_lights factor.
                    with profiler.span("lights"):
                        pdf_shape = lights.light_pdf_toward(scene, peek.prim, hit.point,
                                                            peek.point)
                    w_bsdf = pdf_s / (pdf_s + pdf_shape)
                    with profiler.span("bsdf"):
                        peek_emitted = bsdf.emitted_params(peek_mp)
                    hit_light = (w_bsdf[:, None] * bsdf_s * peek_emitted
                                 * (cos_s / (pdf_s * rr))[:, None])
                    radiance = radiance + torch.where(
                        (live & peek_emis)[:, None], vec.finite_or_zero(prefix * hit_light), 0.0)
                # (NEE alone: a BSDF ray that lands on a light adds nothing.)

            cont = live & peek.valid & ~peek_emis
            prefix = torch.where(cont[:, None], vec.finite_or_zero(prefix * factor / rr[:, None]),
                                 prefix)
            rays = rays + (num_light_samples + 1) * alive.sum()
            bounce += 1
            # The spawned ray carries the eta chosen at this vertex.
            ray_d, ray_eta, hit, mp, alive = o_dir, eta_s, peek, peek_mp, cont
    return radiance, rays


def _trace_brdf_only(scene, tables, ray_o, ray_d, keys, max_bounces):
    """Pure BSDF-sampling path tracing: lights visible at every depth, one
    trace per bounce, the same RR schedule."""
    prefix = torch.ones_like(ray_d)
    radiance = torch.zeros_like(ray_d)
    alive = torch.ones_like(ray_d[:, 0], dtype=torch.bool)
    rays = torch.zeros((), dtype=torch.int64, device=ray_o.device)

    bounce = 0
    while bounce < max_bounces and _any_alive(alive):
        with profiler.span("wave.bounce"):
            with profiler.span("wave.rng"):
                u = rng.bounce_uniforms(keys, bounce, ray_d.dtype)
            with profiler.span("intersect"):
                hit = intersect.intersect(tables, ray_o, ray_d, EPS, float("inf"))
            with profiler.span("bsdf"):
                mp = bsdf.mat_of(scene, hit.mat)
                emis = hit.valid & bsdf.is_emissive_params(mp)
                emitted = bsdf.emitted_params(mp)
            radiance = radiance + torch.where(
                (alive & emis)[:, None], vec.finite_or_zero(prefix * emitted), 0.0)

            with profiler.span("wave.scatter"):
                with profiler.span("bsdf"):
                    eta_s = bsdf.eta_ratio(scene, hit.mat, hit.front_face, params=mp)
                    o_dir, bsdf_s, pdf_s, cos_s = bsdf.sample_bsdf(
                        scene, hit.mat, -ray_d, eta_s, hit.normal, u[:, rng.SLOT_BSDF_U],
                        u[:, rng.SLOT_BSDF_V], u[:, rng.SLOT_FRESNEL], params=mp)
                factor = bsdf_s * (cos_s / pdf_s)[:, None]
                rr = _rr_probability(bounce, prefix * factor)
                cont = alive & hit.valid & ~emis & (u[:, rng.SLOT_RR] < rr)
            prefix = torch.where(cont[:, None], vec.finite_or_zero(prefix * factor / rr[:, None]),
                                 prefix)
            rays = rays + alive.sum()
            bounce += 1
            ray_o, ray_d, alive = hit.point, o_dir, cont
    return radiance, rays
