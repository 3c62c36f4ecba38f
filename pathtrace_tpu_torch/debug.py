"""Deterministic sample-replay debugging.

Counterpart of ``pathtrace_tpu/debug.py``. Every random decision is keyed by
``(pixel, sample, bounce, slot)``, so the samples of one pixel traced as
their own wave are bit for bit the samples of a full-frame render with the
same seed, however the frame was batched: the reference renderer's
fixed-seed per-pixel replay, as an API.
"""

from __future__ import annotations

import numpy as np
import torch

from .integrators import trace_wave
from .models.camera import Camera
from .models.scene import Scene
from .ops import intersect
from .utils import rng, vec


def render_pixel_samples(
    scene: Scene,
    camera: Camera,
    x: int,
    y: int,
    *,
    width: int,
    height: int,
    spp: int,
    integrator: str = "mis",
    max_bounces: int = 64,
    seed: int = 0,
    method: str = "auto",
) -> np.ndarray:
    """Radiance of every sample of pixel ``(x, y)``: ``(spp, 3)``, traced on
    the intersection route of ``method`` (``intersect.resolve_route``)."""
    device = scene.device
    pixel_id = torch.full((spp,), y * width + x, dtype=torch.int64, device=device)
    sample_idx = torch.arange(spp, dtype=torch.int64, device=device)
    keys = rng.pixel_sample_keys(rng.base_key(seed, device), pixel_id, sample_idx)
    # Jitter in the camera's dtype, as the renders draw it (the JAX replay
    # draws float32 jitter even for a float64 camera, so its float64 replay
    # is not its float64 render's samples; this one is).
    jitter = rng.primary_jitter(keys, camera.origin.dtype)
    o, d = camera.generate_rays(pixel_id % width, height - 1 - pixel_id // width, jitter,
                                transposed=False)
    radiance = trace_wave(scene, o, d, keys, integrator=integrator, max_bounces=max_bounces,
                          tables=intersect.build_tables(scene, method))
    return radiance.cpu().numpy()


def replay_pixel(
    scene: Scene,
    camera: Camera,
    x: int,
    y: int,
    *,
    width: int,
    height: int,
    spp: int,
    integrator: str = "mis",
    max_bounces: int = 64,
    seed: int = 0,
    luminance_threshold: float = 10.0,
    method: str = "auto",
) -> dict:
    """Firefly report for one pixel: its mean, its brightest sample and the
    samples whose luminance exceeds ``luminance_threshold``."""
    samples = render_pixel_samples(
        scene, camera, x, y, width=width, height=height, spp=spp,
        integrator=integrator, max_bounces=max_bounces, seed=seed, method=method,
    )
    lum = vec.luminance(torch.from_numpy(samples)).numpy()
    mean = samples.mean(axis=0)
    hot = np.nonzero(lum > luminance_threshold)[0]
    top = int(np.argmax(lum))
    return {
        "pixel": [x, y],
        "spp": spp,
        "integrator": integrator,
        "mean_rgb_pre_gamma": [float(v) for v in mean],
        "mean_luminance": float(lum.mean()),
        "max_sample_index": top,
        "max_sample_luminance": float(lum[top]),
        "max_sample_rgb": [float(v) for v in samples[top]],
        "high_luminance_count": int(hot.size),
        "high_luminance_samples": [
            {"sample": int(i), "luminance": float(lum[i]),
             "rgb": [float(v) for v in samples[i]]}
            for i in hot[:20]
        ],
    }
