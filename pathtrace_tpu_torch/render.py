"""Render orchestration of the wave engine: pixel grids, sample batching,
accumulation, the checkpoint format and the display transform.

Counterpart of ``pathtrace_tpu/render.py``. The whole frame (or one pixel
chunk of it) is one wave of rays per sample, traced by
:func:`~pathtrace_tpu_torch.integrators.trace_wave` and accumulated into an
``(H, W, 3)`` radiance sum on the scene's device, in the camera's dtype. The
accumulation state doubles as the progressive-rendering checkpoint; its
``.npz`` format is the JAX package's, so a checkpoint written by either
package resumes in the other.

``RenderConfig(dtype=torch.float64)`` renders in the reference's native
precision: :func:`cast_floats` widens the scene, the camera and the state,
as the JAX package does. float64 runs on every intersection route and
every ``method``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import profiler
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
    # Compute dtype of the whole estimator: None keeps the scene/camera
    # dtypes (float32); torch.float64 is the reference's native precision.
    dtype: Optional[object] = None
    method: str = "auto"                 # intersection route (intersect.resolve_route)


_DTYPES = {torch.float32: torch.float32, torch.float64: torch.float64,
           "float32": torch.float32, "f32": torch.float32,
           "float64": torch.float64, "f64": torch.float64}


def _float_dtype(dtype) -> torch.dtype:
    """``torch.float32`` or ``torch.float64`` from a torch dtype or its
    name (``"float64"``, ``"f64"``, ...); raises ``ValueError`` otherwise."""
    try:
        return _DTYPES[dtype]
    except (KeyError, TypeError):
        raise ValueError(f"dtype {dtype!r}: the estimator runs in float32 or float64") from None


def cast_floats(obj, dtype):
    """Cast every floating tensor field of ``obj`` (a :class:`Scene`,
    :class:`Camera` or :class:`RenderState`) to ``dtype``, leaving integer
    tensors (material ids, light prims) and plain fields alone. The
    counterpart of the JAX ``cast_floats``; torch has no process-global x64
    switch, so there is nothing to check."""
    dtype = _float_dtype(dtype)
    return dataclasses.replace(obj, **{
        f.name: v.to(dtype) for f in dataclasses.fields(obj)
        if isinstance(v := getattr(obj, f.name), torch.Tensor) and v.is_floating_point()})


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
        """The state of a checkpoint, its sum in the dtype it was saved in."""
        z = np.load(path)
        return cls(torch.from_numpy(np.array(z["image_sum"])).to(device),
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
    one wave per sample, in the camera's dtype: ``((N, 3), ray queries)``."""
    if tables is None:
        tables = intersect.build_tables(scene)
    px = pixel_ids % width
    py = pixel_ids // width
    dtype = camera.origin.dtype
    acc = torch.zeros((pixel_ids.shape[0], 3), dtype=dtype, device=pixel_ids.device)
    rays = 0
    for s in range(samples_per_batch):
        with profiler.span("wave.sample"):
            with profiler.span("wave.rng"):
                keys = rng.pixel_sample_keys(key, pixel_ids,
                                             torch.full_like(pixel_ids, sample_start + s))
                # Jitter in the camera dtype, as the pool draws it: the same samples.
                jitter = rng.primary_jitter(keys, dtype)
            o, d = camera.generate_rays(px, height - 1 - py, jitter, transposed=False)
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
    """Full render (or continuation of ``state``) on ``scene.device``, in
    ``config.dtype`` (None: the scene/camera dtypes). One pass of
    :mod:`~pathtrace_tpu_torch.profiler` (``wave.pass``, with a
    ``wave.sample`` a wave), recorded only while tracing."""
    with profiler.traced_pass("wave", scene.device):
        if config.dtype is not None:
            scene, camera = cast_floats(scene, config.dtype), cast_floats(camera, config.dtype)
            if state is not None:
                state = cast_floats(state, config.dtype)
        w, h = config.width, config.height
        if (camera.width, camera.height) != (w, h):
            raise ValueError(f"camera {camera.width}x{camera.height}, config {w}x{h}")
        device = scene.device
        tables = intersect.build_tables(scene, config.method)
        key = rng.base_key(config.seed, device)
        ids = pixel_grid(w, h, device)
        if state is None:
            state = RenderState(
                torch.zeros((h, w, 3), dtype=camera.origin.dtype, device=device), 0)

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
    """Gamma 2.0 (sqrt) and clamp to uint8: the reference's display
    transform, in the image's dtype (float32 for anything not floating)."""
    img = torch.as_tensor(image).cpu()
    if not img.is_floating_point():
        img = img.to(torch.float32)
    g = torch.sqrt(torch.clamp_min(img, 0.0))
    return (torch.clamp(g, 0.0, 1.0) * 255.0).numpy().astype(np.uint8)


def luminance_image(image: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance of the pre-gamma image."""
    return vec.luminance(image)
