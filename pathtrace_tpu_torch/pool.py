"""Persistent-pool renderer (path regeneration) on the two shading kernels.

Counterpart of ``pathtrace_tpu/pool.py`` (its fused branch). A fixed pool of
``num_slots`` path slots stays saturated: each iteration runs one
:func:`~pathtrace_tpu_torch.ops.shade.fused_bounce` for every busy slot and
one :func:`~pathtrace_tpu_torch.ops.shade.shadow_any_hit` for the NEE shadow
rays; a path that ends adds its radiance to the framebuffer and its slot takes
the next ``(pixel, sample)`` work item.

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
* XOR work stealing, raygen fusion, the ``PT_*`` knobs and ablations.

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
from .ops import shade
from .utils import rng

FLUSH_EVERY = 8


def _unsupported(scene: Scene, integrator: str) -> str | None:
    if not shade.supports_scene(scene, integrator):
        return (
            "scene exceeds the fused kernels' caps (<=64 triangles, <=512 "
            "spheres, <=64 lights) or the integrator is unknown; the composed "
            "path and the traversal kernels for it are ROADMAP Queue 1 item 4 "
            "and Queue 2"
        )
    if scene.has_oren_nayar or scene.has_pbr:
        return (
            "Oren-Nayar and PBR materials are not ported yet "
            "(ROADMAP Queue 1, item 5: the ON/PBR lanes)"
        )
    return None


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
):
    """Render the full frame with a saturated path pool on ``scene.device``.

    Returns ``(image_sum (H*W, 3) float32, counters (4,) int64, iters)``;
    divide the image by ``spp`` for mean radiance. ``counters`` is
    ``(rays_hi, rays_lo, busy_hi, busy_lo)``, each a 32-bit half, decoded by
    :func:`ray_count` / :func:`busy_count` exactly as the JAX package's.
    """
    reason = _unsupported(scene, integrator)
    if reason is not None:
        raise NotImplementedError(reason)
    device = scene.device
    if camera.origin.device != device:
        raise ValueError(f"camera on {camera.origin.device}, scene on {device}")
    use_nee = integrator in ("mis", "nee")
    eps = shade.EPS
    tables = shade.build_tables(scene)
    bounce_kw = dict(
        num_tris=scene.tri_v0.shape[0], num_lights=scene.num_lights,
        integrator=integrator, max_bounces=max_bounces, eps=eps,
        has_tri_lights=scene.has_tri_lights, has_sph_lights=scene.has_sph_lights,
    )

    num_pixels = width * height
    S = min(num_slots, num_pixels)
    chunks = -(-num_pixels // S)
    work_per_slot = chunks * spp
    padded_pixels = chunks * S
    perm = _coprime_stride(padded_pixels)
    key = rng.base_key(seed, device)

    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    slot_ids = torch.arange(S, dtype=i64, device=device)
    pixel = torch.zeros(S, dtype=i64, device=device)
    chunk = torch.zeros(S, dtype=i64, device=device)
    sample = torch.zeros(S, dtype=i64, device=device)
    bounce = torch.zeros(S, dtype=i32, device=device)
    cursor = torch.zeros(S, dtype=i64, device=device)
    ray_o = torch.zeros((3, S), dtype=f32, device=device)
    ray_d = torch.zeros((3, S), dtype=f32, device=device)
    ray_d[2] = 1.0
    ray_eta = torch.ones(S, dtype=f32, device=device)
    pdf_prev = torch.ones(S, dtype=f32, device=device)
    prefix = torch.ones((3, S), dtype=f32, device=device)
    radiance = torch.zeros((3, S), dtype=f32, device=device)
    busy = torch.zeros(S, dtype=torch.bool, device=device)
    # Slot-strided framebuffer: work item w = chunk * S + slot at row w.
    image = torch.zeros((padded_pixels, 3), dtype=f32, device=device)
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
        pixel_ok = new_local < num_pixels
        cursor = torch.where(refill, cursor + 1, cursor)
        started = refill & pixel_ok
        pixel = torch.where(started, new_local, pixel)
        chunk = torch.where(started, q % chunks, chunk)
        sample = torch.where(started, q // chunks, sample)
        bounce = torch.where(started, 0, bounce)

        # One (9, S) draw covers every decision of this bounce, including
        # the camera jitter (slots 7-8) of refilled lanes.
        keys = rng.pixel_sample_keys(key, pixel, sample)
        u = rng.per_slot_uniforms(keys, bounce.to(i64))
        jitter = torch.stack([u[rng.SLOT_JITTER_X], u[rng.SLOT_JITTER_Y]], dim=1)
        cam_o, cam_d = camera.generate_rays(
            pixel % width, (height - 1) - pixel // width, jitter)
        ray_o = torch.where(started, cam_o, ray_o)
        ray_d = torch.where(started, cam_d, ray_d)
        ray_eta = torch.where(started, 1.0, ray_eta)
        pdf_prev = torch.where(started, 1.0, pdf_prev)
        prefix = torch.where(started, 1.0, prefix)
        radiance = torch.where(started, 0.0, radiance)
        busy = busy | started

        # ---- One bounce for every busy slot: two kernels ----
        res = shade.fused_bounce(
            tables, busy, bounce, ray_o, ray_d, ray_eta, pdf_prev, prefix,
            u.contiguous(), **bounce_kw)
        radiance = radiance + res.rad_delta
        if use_nee and scene.num_lights > 0:
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
