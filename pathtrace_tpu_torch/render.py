"""Render orchestration of the wave engine: pixel grids, sample batching,
accumulation, the checkpoint format and the display transform.

Counterpart of ``pathtrace_tpu/render.py``. The whole frame (or one pixel
chunk of it) is one wave of rays per sample, traced by
:func:`~pathtrace_tpu_torch.integrators.trace_wave` and accumulated into an
``(H, W, 3)`` float32 radiance sum on the scene's device. The accumulation
state doubles as the progressive-rendering checkpoint; its ``.npz`` format
is the JAX package's, so a checkpoint written by either package resumes in
the other.

Not ported yet: ``RenderConfig(dtype=float64)`` (ROADMAP Queue 1, item 4)
and ``cast_floats``; the port renders in float32 only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .integrators import trace_wave
from .models.camera import Camera
from .models.scene import Scene
from .ops import intersect
from .utils import rng, vec


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 400
    height: int = 400
    spp: int = 3000
    integrator: str = "mis"
    max_bounces: int = 64
    seed: int = 0
    samples_per_batch: int = 1           # samples traced per render_batch call
    num_light_samples: int = 1           # NEE light samples per vertex
    pixel_chunk: Optional[int] = None    # split the pixel wave to bound memory
    dtype: Optional[object] = None       # None or float32; float64 is not ported
    method: str = "auto"                 # intersection route (intersect.resolve_route)


def _check_dtype(dtype) -> None:
    if dtype is not None and dtype not in (torch.float32, "float32", "f32"):
        raise NotImplementedError(
            f"dtype {dtype!r}: the port renders in float32 only; float64 is "
            "ROADMAP Queue 1, item 4")


@dataclasses.dataclass
class RenderState:
    """Progressive accumulation state: the checkpoint format.

    ``ray_queries`` counts the scene-traversal queries traced into this
    state by this process (not saved: a loaded state starts at 0)."""

    image_sum: torch.Tensor  # (H, W, 3) pre-gamma radiance sum
    num_samples: int
    ray_queries: int = 0

    @property
    def image(self) -> torch.Tensor:
        """Mean pre-gamma radiance."""
        return self.image_sum / max(self.num_samples, 1)

    def save(self, path: str) -> None:
        np.savez(path, image_sum=self.image_sum.cpu().numpy(), num_samples=self.num_samples)

    @classmethod
    def load(cls, path: str, device="cuda") -> "RenderState":
        z = np.load(path)
        return cls(torch.from_numpy(np.array(z["image_sum"], np.float32)).to(device),
                   int(z["num_samples"]))


def pixel_grid(width: int, height: int, device=None) -> torch.Tensor:
    """Flat pixel ids in the framebuffer layout ``y * W + x``."""
    return torch.arange(width * height, dtype=torch.int64, device=device)


def render_batch(
    scene: Scene,
    camera: Camera,
    pixel_ids: torch.Tensor,
    sample_start: int,
    key,
    *,
    width: int,
    height: int,
    integrator: str,
    max_bounces: int,
    samples_per_batch: int,
    num_light_samples: int = 1,
    tables: intersect.Tables | None = None,
):
    """Radiance **sum** over ``samples_per_batch`` samples for each pixel id,
    one wave per sample: ``((N, 3), ray queries)``."""
    if tables is None:
        tables = intersect.build_tables(scene)
    px = pixel_ids % width
    py = pixel_ids // width
    acc = torch.zeros((pixel_ids.shape[0], 3), dtype=torch.float32, device=pixel_ids.device)
    rays = 0
    for s in range(samples_per_batch):
        keys = rng.pixel_sample_keys(key, pixel_ids,
                                     torch.full_like(pixel_ids, sample_start + s))
        o, d = camera.generate_rays(px, height - 1 - py, rng.primary_jitter(keys),
                                    transposed=False)
        radiance, n = trace_wave(scene, o, d, keys, integrator=integrator,
                                 max_bounces=max_bounces, return_stats=True,
                                 num_light_samples=num_light_samples, tables=tables)
        acc = acc + radiance
        rays += n
    return acc, rays


def render(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    state: Optional[RenderState] = None,
    progress_callback=None,
) -> RenderState:
    """Full render (or continuation of ``state``) on ``scene.device``."""
    _check_dtype(config.dtype)
    w, h = config.width, config.height
    if (camera.width, camera.height) != (w, h):
        raise ValueError(f"camera {camera.width}x{camera.height}, config {w}x{h}")
    device = scene.device
    tables = intersect.build_tables(scene, config.method)
    key = rng.base_key(config.seed, device)
    ids = pixel_grid(w, h, device)
    if state is None:
        state = RenderState(torch.zeros((h, w, 3), dtype=torch.float32, device=device), 0)

    image_sum = state.image_sum.to(device).reshape(-1, 3).clone()
    done, rays = state.num_samples, state.ray_queries
    step = config.pixel_chunk or ids.shape[0]
    while done < config.spp:
        nbatch = min(config.samples_per_batch, config.spp - done)
        for a in range(0, ids.shape[0], step):
            part, n = render_batch(
                scene, camera, ids[a:a + step], done, key, width=w, height=h,
                integrator=config.integrator, max_bounces=config.max_bounces,
                samples_per_batch=nbatch, num_light_samples=config.num_light_samples,
                tables=tables)
            image_sum[a:a + step] += part
            rays += n
        done += nbatch
        if progress_callback is not None:
            progress_callback(done)
    return RenderState(image_sum.reshape(h, w, 3), done, rays)


def to_srgb_u8(image) -> np.ndarray:
    """Gamma 2.0 (sqrt) and clamp to uint8: the reference's display transform."""
    img = torch.as_tensor(image, dtype=torch.float32).cpu()
    g = torch.sqrt(torch.clamp_min(img, 0.0))
    return (torch.clamp(g, 0.0, 1.0) * 255.0).numpy().astype(np.uint8)


def luminance_image(image: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance of the pre-gamma image."""
    return vec.luminance(image)
