"""PyTorch + CUDA port of the pathtrace_tpu path tracer.

The JAX package ``pathtrace_tpu`` is the reference; this package renders the
same scenes with the same estimator and the same counter-based sample
coordinates, on one NVIDIA GPU through hand-written CUDA kernels
(``ops/shade.py``, ``ops/intersect.py``), or on the CPU through their
plain-torch twins. Two engines: the persistent path pool
(:func:`render_pool`) and the wavefront engine (:func:`render`,
:func:`trace_wave`). It never imports JAX.

Scenes, cameras and loaded checkpoints are built on the GPU (``"cuda"``)
unless the caller passes ``device="cpu"``; without a GPU the default raises
and nothing falls back to the CPU. The engines run on the device of the
scene they are given.
"""

from .integrators import trace_wave
from .models.camera import Camera
from .models.materials import (
    Emissive,
    Lambertian,
    Mirror,
    OrenNayar,
    PBRMaterial,
)
from .models.scene import Scene, SceneBuilder
from .pool import busy_count, ray_count, render_pool
from .render import RenderConfig, RenderState, render, to_srgb_u8

__all__ = [
    "Camera",
    "Emissive",
    "Lambertian",
    "Mirror",
    "OrenNayar",
    "PBRMaterial",
    "RenderConfig",
    "RenderState",
    "Scene",
    "SceneBuilder",
    "busy_count",
    "ray_count",
    "render",
    "render_pool",
    "to_srgb_u8",
    "trace_wave",
]
