"""PyTorch + CUDA port of the pathtrace_tpu path tracer (persistent-pool slice).

The JAX package ``pathtrace_tpu`` is the reference; this package renders the
same scenes with the same estimator and the same counter-based sample
coordinates, on one NVIDIA GPU through two hand-written CUDA kernels
(``ops/shade.py``), or on the CPU through their plain-torch twins. It never
imports JAX.
"""

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

__all__ = [
    "Camera",
    "Emissive",
    "Lambertian",
    "Mirror",
    "OrenNayar",
    "PBRMaterial",
    "Scene",
    "SceneBuilder",
    "busy_count",
    "ray_count",
    "render_pool",
]
