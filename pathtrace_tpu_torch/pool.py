"""Persistent-pool renderer (path regeneration).

Counterpart of ``pathtrace_tpu/pool.py``. A fixed pool of ``num_slots`` path
slots stays saturated; a path that ends adds its radiance to the framebuffer
and its slot takes the next ``(pixel, sample)`` work item. Each iteration
runs one path vertex for every busy slot by one of two branches, chosen per
scene as the JAX package chooses them:

* the **fused** branch, for scenes within the fused kernels' caps (<= 64
  triangles, 512 spheres, 64 lights), Oren-Nayar and PBR materials included
  (the kernel's lanes for them run when the scene's ``has_oren_nayar``/
  ``has_pbr`` flags are set, as the JAX ``has_on``/``has_pbr`` do):
  :func:`~pathtrace_tpu_torch.ops.shade.fused_bounce` for the vertex and
  :func:`~pathtrace_tpu_torch.ops.shade.shadow_any_hit` for the NEE shadow
  rays; the kernel runs in its raygen mode (the JAX pool's
  ``PT_RAYGEN_FUSION=1``): it makes the refilled slots' primary rays and
  resets their state, so the glue does neither;
* the **composed** branch, for every other scene: :func:`composed_bounce`
  runs the vertex as separate ops (closest hit, emissive/MIS term, NEE light
  sample and BSDF evaluation, BSDF sample, Russian roulette) over the
  kernels of ``ops/intersect.py`` on the scene's route (the BVH for at least
  4096 triangles, the flat clusters for more than 64 triangles or beside
  more than 512 spheres, the fused small-scene closest hit for more than 64
  lights; or the route ``method`` asks for: ``"bvh"``, ``"binned"``,
  ``"resident"``; past 512 spheres every route runs the clustered sphere
  kernels), and :func:`~pathtrace_tpu_torch.ops.intersect.occluded` tests
  the shadow rays.

Nothing falls back to another kernel or to a twin.

Work assignment is the JAX package's, so the same sample indices trace the
same paths: slot ``s`` owns the work items ``w = chunk * S + s``, whose
pixels are a coprime-stride permutation of the image, and every random
decision is keyed by ``(pixel, sample, bounce, slot)`` (``utils/rng.py``).

Left behind from the JAX pool (TPU or no-x64 workarounds, or off by
default there):

* the deferred flush ring: a dying lane adds straight into its framebuffer
  cell. Each cell gets at most one add per iteration, in iteration order,
  so the sums equal the ring's;
* the uint32 ``perm`` arithmetic, the split ``perm_inv`` gather and the
  hi/lo counter pairs: int64 does each exactly;
* XOR work stealing, the ``PT_*`` knobs and ablations. Raygen fusion
  (``PT_RAYGEN_FUSION=1``) is not a knob here: the fused branch always runs
  it, since it gives the split glue's image, rays and iterations bit for
  bit with fewer device ops an iteration;
* ``set_fused``, the process-global override of the fused branch: the port
  picks the branch per call (:func:`route`; ``method="bruteforce"`` forces
  the composed branch).

As in the JAX pool, the exit test runs once per ``FLUSH_EVERY`` iterations
(one host sync per block), so ``iters`` is a multiple of it and equals the
JAX count; the trailing iterations of the last block are no-ops.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .models.camera import Camera
from .models.scene import Scene
from .ops import bsdf, intersect, lights, shade
from .utils import rng, vec

FLUSH_EVERY = 8
INTEGRATORS = ("mis", "nee", "brdf_only")


def route(scene: Scene, integrator: str, method: str | None = None) -> str:
    """``"fused"`` or ``"composed"``, as the JAX pool chooses: the fused
    branch only under the default method (``None``, ``"auto"`` or
    ``"pallas"``) for a scene within the fused kernels' caps; scenes with at
    least ``BVH_MIN_TRIS`` triangles, scenes past the caps and every other
    method (``"bruteforce"``, ``"bvh"``, ``"binned"``, ``"resident"``) take
    the composed branch on the route ``intersect.resolve_route(..., method)``
    picks. ``"bruteforce"`` goes there because the JAX pool's fused gate
    wants a Pallas method, so it runs such a call composed. Raises
    ``NotImplementedError`` for an unknown integrator or method."""
    if integrator not in INTEGRATORS:
        raise NotImplementedError(f"unknown integrator {integrator!r}; known: {INTEGRATORS}")
    method = method or "auto"
    n_tris = scene.tri_v0.shape[0]
    if (method in ("auto", "pallas") and n_tris < intersect.BVH_MIN_TRIS
            and shade.supports_scene(scene, integrator)):
        return "fused"
    intersect.resolve_route(n_tris, scene.sph_center.shape[0], method)
    return "composed"


def _rr_probability(bounce, next_tp):
    """Russian-roulette survival: 1 below depth RR_MIN_DEPTH, then the
    throughput luminance capped at 1, decayed by 2^-(depth - 4) from
    RR_MAX_DEPTH on."""
    lum = torch.clamp_max(vec.luminance(vec.finite_or_zero(next_tp)), 1.0)
    decay = torch.exp2(-torch.clamp_min(bounce - shade.RR_MIN_DEPTH, 0).to(lum.dtype))
    return torch.where(
        bounce < shade.RR_MIN_DEPTH,
        torch.ones_like(lum),
        torch.where(bounce >= shade.RR_MAX_DEPTH, lum * decay, lum),
    )


def composed_bounce(
    scene: Scene, tables: intersect.Tables, busy, bounce, ray_o, ray_d, ray_eta,
    pdf_prev, prefix, u, *, integrator: str, max_bounces: int, eps: float = shade.EPS,
    twin: bool = False,
) -> shade.BounceResult:
    """One path vertex for every lane as separate ops (the JAX pool's
    composed branch), in the pool's kernel layout: 3-vectors ``(3, S)``,
    uniforms ``(9, S)``.

    Returns the fused kernel's :class:`~pathtrace_tpu_torch.ops.shade.BounceResult`
    contract: ``nee_gain`` is ``prefix * direct`` pending visibility of the
    shadow ray ``(next_o, shadow_d)`` over ``[eps, shadow_tmax]``
    (``shadow_tmax < eps`` on lanes that do not live on: NEE counts only if
    Russian roulette keeps the path). ``twin=True`` intersects with the
    kernels' plain twins on any device (for checking them; never on the
    render path).
    """
    use_mis = integrator == "mis"
    use_nee = integrator in ("mis", "nee") and scene.num_lights > 0
    o, d, pfx = ray_o.T.contiguous(), ray_d.T.contiguous(), prefix.T
    hit = intersect.intersect(tables, o, d, eps, float("inf"), twin=twin)
    mp = bsdf.mat_of(scene, hit.mat)
    emis = hit.valid & bsdf.is_emissive_params(mp)
    emission = bsdf.emitted_params(mp)

    # Emissive terminal rules: raw emission at depth 0 (and at any depth
    # without NEE); MIS-weighted, the bsdf-side pdf from the previous vertex.
    if integrator == "brdf_only":
        emis_gain = emission
    else:
        if use_mis:
            pdf_shape = lights.light_pdf_toward(scene, hit.prim, o, hit.point)
            w_bsdf = pdf_prev / (pdf_prev + pdf_shape)
        else:
            w_bsdf = torch.zeros_like(pdf_prev)
        emis_gain = torch.where((bounce == 0)[:, None], emission, w_bsdf[:, None] * emission)
    rad = torch.where((busy & emis)[:, None], vec.finite_or_zero(pfx * emis_gain), 0.0)

    # A path may reach max_bounces only to collect a light hit.
    shade_m = busy & hit.valid & ~emis & (bounce < max_bounces)
    i_dir = -d

    if use_nee:
        ls = lights.sample_light_point(scene, hit.point, u[rng.SLOT_LIGHT_SELECT],
                                       u[rng.SLOT_LIGHT_U], u[rng.SLOT_LIGHT_V])
        cos_l = torch.abs(vec.dot(hit.normal, ls.dir))
        bsdf_l, pdf_l = bsdf.eval_bsdf(scene, hit.mat, i_dir, ray_eta, ls.dir, hit.normal,
                                       params=mp)
        w_nee = ls.pdf / (ls.pdf + pdf_l) if use_mis else torch.ones_like(ls.pdf)
        direct = vec.finite_or_zero(
            w_nee[:, None] * bsdf_l * ls.emission * (cos_l / ls.pdf)[:, None])
        nee_gain = vec.finite_or_zero(pfx * direct)
        shadow_d, shadow_t = ls.dir, ls.dist - eps
    else:
        nee_gain = torch.zeros_like(o)
        shadow_d, shadow_t = d, torch.full_like(pdf_prev, -1.0)

    eta_s = bsdf.eta_ratio(scene, hit.mat, hit.front_face, params=mp)
    o_dir, bsdf_s, pdf_s, cos_s = bsdf.sample_bsdf(
        scene, hit.mat, i_dir, eta_s, hit.normal, u[rng.SLOT_BSDF_U], u[rng.SLOT_BSDF_V],
        u[rng.SLOT_FRESNEL], params=mp)
    factor = bsdf_s * (cos_s / pdf_s)[:, None]
    next_tp = pfx * factor
    rr = _rr_probability(bounce, next_tp)
    live = shade_m & (u[rng.SLOT_RR] < rr)
    l2 = live[:, None]
    return shade.BounceResult(
        rad_delta=rad.T,
        next_o=torch.where(l2, hit.point, o).T,
        next_d=torch.where(l2, o_dir, d).T,
        next_eta=torch.where(live, eta_s, ray_eta),
        next_pdf=torch.where(live, pdf_s, pdf_prev),
        next_prefix=torch.where(l2, vec.finite_or_zero(pfx * factor / rr[:, None]), pfx).T,
        live=live,
        shade=shade_m,
        nee_gain=nee_gain.T,
        shadow_d=shadow_d.T,
        shadow_tmax=torch.where(live, shadow_t, -1.0),
    )


def camera_row(camera: Camera) -> torch.Tensor:
    """The camera packed for ``fused_bounce``'s raygen mode, as the JAX pool
    packs it: row 0 ``[origin, lower_left, width - 1, height - 1]``, row 1
    ``[horizontal, vertical, 0, 0]``, ``(2, 8)`` in the camera's dtype (the
    divisors are the camera's size, as ``Camera.generate_rays`` takes them)."""
    dims = torch.tensor([camera.width - 1, camera.height - 1], dtype=camera.origin.dtype,
                        device=camera.origin.device)
    return torch.stack([
        torch.cat([camera.origin, camera.lower_left_corner, dims]),
        torch.cat([camera.horizontal, camera.vertical, torch.zeros_like(dims)]),
    ]).contiguous()


def _coprime_stride(padded_pixels: int) -> int:
    """The JAX pool's pixel stride: the largest value <= 0.618 * padded that
    is coprime with it (capped so that w * perm fits in uint32)."""
    bound = max((2**32 - 1) // max(padded_pixels, 1), 1)
    perm = max(1, min(bound, int(0.6180339887 * padded_pixels)))
    while math.gcd(perm, padded_pixels) != 1:
        perm -= 1
    return perm


def render_pool(
    scene: Scene,
    camera: Camera,
    *,
    width: int,
    height: int,
    spp: int,
    integrator: str = "mis",
    max_bounces: int = 64,
    num_slots: int = 32768,
    seed: int = 0,
    sample_offset: int = 0,
    dtype=None,
    method: str | None = None,
):
    """Render the full frame with a saturated path pool on ``scene.device``.

    ``dtype`` is the estimator's precision: None keeps the scene/camera
    dtypes (float32); ``torch.float64`` is the reference's native precision
    (``render.cast_floats`` widens the scene and the camera, as the JAX
    pool does). Every state tensor and the framebuffer take it. float64 runs
    the fused branch and the composed branch on every route, ``method=``
    included.

    ``method`` picks the intersection traversal for this call (:func:`route`;
    ``None`` is ``"auto"``): ``"bvh"``, ``"binned"`` and ``"resident"`` run
    the composed branch on that route even for a small scene.

    ``sample_offset`` is the first global sample index: progressive passes
    render ``spp`` samples from there, continuing the same RNG streams, so
    passes at offsets 0, 1, ... sum to one render of their total spp.

    Returns ``(image_sum (H*W, 3) in the dtype, counters (4,) int64, iters)``;
    divide the image by ``spp`` for mean radiance. ``counters`` is
    ``(rays_hi, rays_lo, busy_hi, busy_lo)``, each a 32-bit half, decoded by
    :func:`ray_count` / :func:`busy_count` exactly as the JAX package's.

    The multi-process path is
    :func:`pathtrace_tpu_torch.parallel.sharding.render_pool_sharded`, which
    runs :func:`_pool_loop` on each rank's pixel and sample window.
    """
    if dtype is not None:
        from .render import cast_floats

        scene, camera = cast_floats(scene, dtype), cast_floats(camera, dtype)
    num_pixels = width * height
    return _pool_loop(scene, camera, 0, sample_offset, width=width, height=height,
                      total_pixels=num_pixels, local_pixels=num_pixels, spp=spp,
                      integrator=integrator, max_bounces=max_bounces, num_slots=num_slots,
                      seed=seed, method=method)


def _pool_loop(
    scene: Scene,
    camera: Camera,
    pixel_lo: int,
    sample_lo: int,
    *,
    width: int,
    height: int,
    total_pixels: int,
    local_pixels: int,
    spp: int,
    integrator: str,
    max_bounces: int,
    num_slots: int,
    seed: int,
    method: str | None = None,
):
    """Pool render of the global pixel window ``[pixel_lo, pixel_lo +
    local_pixels)`` and the sample window ``[sample_lo, sample_lo + spp)``;
    the work items of a window that overhangs the frame (global pixel
    ``>= total_pixels``) are skipped, their slots left idle.

    The RNG is keyed by the global ``(pixel, sample)``, and the raygen by
    the global pixel, so any split of the frame into windows traces the
    sample set of the whole frame, each pixel's samples in sample order in
    one slot. :func:`render_pool` is the window ``(0, sample_offset)`` of
    the whole frame.

    Returns ``(image_sum (local_pixels, 3), counters (4,) int64, iters)``.
    """
    composed = route(scene, integrator, method) == "composed"
    device = scene.device
    if camera.origin.device != device:
        raise ValueError(f"camera on {camera.origin.device}, scene on {device}")
    fdt = camera.origin.dtype
    if scene.tri_v0.dtype != fdt:
        raise ValueError(f"camera in {fdt}, scene in {scene.tri_v0.dtype} (pass dtype=)")
    use_nee = integrator in ("mis", "nee")
    eps = shade.EPS
    if composed:
        tables = intersect.build_tables(scene, method or "auto")
        bounce_kw = dict(integrator=integrator, max_bounces=max_bounces, eps=eps)
    else:
        tables = shade.build_tables(scene)
        bounce_kw = dict(
            num_tris=scene.tri_v0.shape[0], num_lights=scene.num_lights,
            integrator=integrator, max_bounces=max_bounces, eps=eps,
            has_tri_lights=scene.has_tri_lights, has_sph_lights=scene.has_sph_lights,
            has_oren_nayar=scene.has_oren_nayar, has_pbr=scene.has_pbr,
        )

    num_pixels = local_pixels
    overhang = pixel_lo + local_pixels > total_pixels
    S = min(num_slots, num_pixels)
    chunks = -(-num_pixels // S)
    work_per_slot = chunks * spp
    padded_pixels = chunks * S
    perm = _coprime_stride(padded_pixels)
    key = rng.base_key(seed, device)
    cam_row = None if composed else camera_row(camera)

    i32, i64 = torch.int32, torch.int64
    slot_ids = torch.arange(S, dtype=i64, device=device)
    pixel = torch.zeros(S, dtype=i64, device=device)
    chunk = torch.zeros(S, dtype=i64, device=device)
    sample = torch.zeros(S, dtype=i64, device=device)
    bounce = torch.zeros(S, dtype=i32, device=device)
    cursor = torch.zeros(S, dtype=i64, device=device)
    ray_o = torch.zeros((3, S), dtype=fdt, device=device)
    ray_d = torch.zeros((3, S), dtype=fdt, device=device)
    ray_d[2] = 1.0
    ray_eta = torch.ones(S, dtype=fdt, device=device)
    pdf_prev = torch.ones(S, dtype=fdt, device=device)
    prefix = torch.ones((3, S), dtype=fdt, device=device)
    radiance = torch.zeros((3, S), dtype=fdt, device=device)
    busy = torch.zeros(S, dtype=torch.bool, device=device)
    # Slot-strided framebuffer: work item w = chunk * S + slot at row w.
    image = torch.zeros((padded_pixels, 3), dtype=fdt, device=device)
    rays = torch.zeros((), dtype=i64, device=device)
    busy_total = torch.zeros((), dtype=i64, device=device)

    def step():
        nonlocal pixel, chunk, sample, bounce, cursor, ray_o, ray_d, ray_eta
        nonlocal pdf_prev, prefix, radiance, busy, rays, busy_total
        # ---- Refill: each free slot takes the next item of its stream ----
        refill = ~busy & (cursor < work_per_slot)
        q = cursor
        w_item = (q % chunks) * S + slot_ids
        new_local = (w_item * perm) % padded_pixels
        new_pixel = new_local + pixel_lo if pixel_lo else new_local
        pixel_ok = new_local < num_pixels
        if overhang:
            pixel_ok = pixel_ok & (new_pixel < total_pixels)
        cursor = torch.where(refill, cursor + 1, cursor)
        started = refill & pixel_ok
        pixel = torch.where(started, new_pixel, pixel)
        chunk = torch.where(started, q % chunks, chunk)
        sample = torch.where(started, q // chunks + sample_lo, sample)
        bounce = torch.where(started, 0, bounce)

        # One (9, S) draw covers every decision of this bounce, including
        # the camera jitter (slots 7-8) of refilled lanes.
        keys = rng.pixel_sample_keys(key, pixel, sample)
        u = rng.per_slot_uniforms(keys, bounce.to(i64), fdt)
        px, py = pixel % width, (height - 1) - pixel // width
        if composed:
            jitter = torch.stack([u[rng.SLOT_JITTER_X], u[rng.SLOT_JITTER_Y]], dim=1)
            cam_o, cam_d = camera.generate_rays(px, py, jitter)
            ray_o = torch.where(started, cam_o, ray_o)
            ray_d = torch.where(started, cam_d, ray_d)
            ray_eta = torch.where(started, 1.0, ray_eta)
            pdf_prev = torch.where(started, 1.0, pdf_prev)
            prefix = torch.where(started, 1.0, prefix)
        radiance = torch.where(started, 0.0, radiance)
        busy = busy | started

        # ---- One bounce for every busy slot, then the NEE shadow rays ----
        if composed:
            res = composed_bounce(scene, tables, busy, bounce, ray_o, ray_d, ray_eta,
                                  pdf_prev, prefix, u, **bounce_kw)
        else:
            # The kernel makes the started lanes' rays and resets from the
            # carried state; only the pixel split stays here.
            res = shade.fused_bounce(
                tables, busy, bounce, ray_o, ray_d, ray_eta, pdf_prev, prefix,
                u.contiguous(), raygen=(started, px.to(i32), py.to(i32), cam_row),
                **bounce_kw)
        radiance = radiance + res.rad_delta
        if use_nee and scene.num_lights > 0:
            if composed:
                blocked = intersect.occluded(tables, res.next_o.T.contiguous(),
                                             res.shadow_d.T.contiguous(), eps, res.shadow_tmax)
            else:
                blocked = shade.shadow_any_hit(
                    tables, res.next_o, res.shadow_d, res.shadow_tmax, eps=eps)
            radiance = radiance + torch.where(res.live & ~blocked, res.nee_gain, 0.0)
        live = res.live

        # ---- Termination: dying paths add into their framebuffer cell ----
        done = busy & ~live
        idx = (chunk * S + slot_ids)[done]
        image[idx] = image[idx] + radiance[:, done].T

        busy_inc = busy.sum()
        rays = rays + busy_inc + (res.shade.sum() if use_nee else 0)
        busy_total = busy_total + busy_inc
        bounce = torch.where(live, bounce + 1, bounce)
        ray_o, ray_d = res.next_o, res.next_d
        ray_eta, pdf_prev, prefix = res.next_eta, res.next_pdf, res.next_prefix
        radiance = torch.where(live, radiance, 0.0)
        busy = live

    iters = 0
    while bool(busy.any() | (cursor < work_per_slot).any()):
        for _ in range(FLUSH_EVERY):
            step()
        iters += FLUSH_EVERY

    # Pixel p holds work item (p * perm^-1) % padded: one inverse gather.
    perm_inv = pow(perm, -1, padded_pixels)
    p_ids = torch.arange(num_pixels, dtype=i64, device=device)
    image_sum = image[(p_ids * perm_inv) % padded_pixels]
    mask = 0xFFFFFFFF
    counters = torch.stack([rays >> 32, rays & mask, busy_total >> 32, busy_total & mask])
    return image_sum, counters, iters


def _decode(counters, hi: int) -> int:
    """Sum over ``(..., 4)`` counter rows of the 64-bit value whose 32-bit
    halves sit in columns ``hi`` and ``hi + 1``."""
    c = np.asarray(counters.cpu() if isinstance(counters, torch.Tensor) else counters)
    return sum((int(row[hi]) << 32) | int(row[hi + 1]) for row in c.reshape(-1, c.shape[-1]))


def ray_count(counters) -> int:
    """Exact traced-ray count from :func:`render_pool`'s counter vector
    (``(..., 4)`` rows of ``(rays_hi, rays_lo, busy_hi, busy_lo)``)."""
    return _decode(counters, 0)


def busy_count(counters) -> int:
    """Exact busy-slot-iteration count; occupancy = busy_count / (iters x slots)."""
    return _decode(counters, 2)
