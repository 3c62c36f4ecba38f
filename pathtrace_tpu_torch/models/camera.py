"""Pinhole camera with vectorized jittered ray generation.

Counterpart of ``pathtrace_tpu/models/camera.py`` with the same op order, in
the camera's dtype (float32, or float64 after ``render.cast_floats``), so
primary rays match the JAX package's bit for bit. Two conventions of
the reference renderer are kept on purpose:

* The FOV parameter drives the **vertical** viewport (width = height x
  aspect), although it is named as if horizontal.
* Pixel coordinates map to the screen as ``u = (x + jx) / (width - 1)``; the
  caller flips y.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import profiler
from ..utils import vec


@dataclasses.dataclass(frozen=True)
class Camera:
    origin: torch.Tensor             # (3,) float32 or float64
    lower_left_corner: torch.Tensor  # (3,)
    horizontal: torch.Tensor         # (3,)
    vertical: torch.Tensor           # (3,)
    width: int
    height: int

    @classmethod
    def perspective(cls, origin, width: int, height: int,
                    screen_distance: float = 1.0, fov_degrees: float = 35.0,
                    device="cuda") -> "Camera":
        """Axis-aligned camera looking down -Z."""
        fov = math.radians(fov_degrees)
        aspect = width / height
        viewport_height = 2.0 * math.tan(fov / 2.0) * screen_distance
        viewport_width = viewport_height * aspect

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        origin = f32(origin)
        horizontal = f32([viewport_width, 0.0, 0.0])
        vertical = f32([0.0, viewport_height, 0.0])
        llc = origin - horizontal / 2.0 - vertical / 2.0 - f32([0.0, 0.0, screen_distance])
        return cls(origin, llc, horizontal, vertical, width, height)

    @classmethod
    def look_at(cls, origin, target, up, width: int, height: int,
                fov_degrees: float = 35.0, device="cuda") -> "Camera":
        """Free-look constructor."""
        fov = math.radians(fov_degrees)
        aspect = width / height

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        origin, target, up = f32(origin), f32(target), f32(up)
        w = vec.normalize(origin - target)
        u = vec.normalize(vec.cross(up, w))
        v = vec.cross(w, u)

        screen_distance = 1.0
        viewport_height = 2.0 * math.tan(fov / 2.0) * screen_distance
        viewport_width = viewport_height * aspect

        horizontal = u * viewport_width
        vertical = v * viewport_height
        llc = origin - horizontal / 2.0 - vertical / 2.0 - w * screen_distance
        return cls(origin, llc, horizontal, vertical, width, height)

    def generate_rays(self, px: torch.Tensor, py: torch.Tensor, jitter: torch.Tensor,
                      transposed: bool = True, frame: torch.Tensor | None = None):
        """Primary rays for pixel coords ``px, py`` (already y-flipped by the
        caller) with sub-pixel ``jitter`` ``(N, 2)`` in [0, 1).

        ``frame``, int64 ``(N,)``, is given for a stack of cameras (each
        vector ``(F, 3)``, ``parallel.sharding.stack_cameras``): ray ``i``
        takes camera ``frame[i]``'s vectors, in the same arithmetic, so it is
        bit for bit the ray that camera alone makes.

        Returns ``(origins, directions)`` with unit directions, in kernel
        layout ``(3, N)`` (the pool's), or contiguous ``(N, 3)`` (the wave
        engine's) when ``transposed`` is False. The JAX camera computes both
        layouts with the same per-component arithmetic, so ``(N, 3)`` is the
        transpose of ``(3, N)`` bit for bit. Unlike the JAX camera, the
        default is the kernel layout.
        """
        if not transposed:
            o, d = self.generate_rays(px, py, jitter, frame=frame)
            return o.T.contiguous(), d.T.contiguous()
        # Divide by 0-dim tensors: CUDA would turn division by a host scalar
        # into multiplication by its reciprocal, which rounds differently.
        dtype = self.origin.dtype
        wm1, hm1 = profiler.from_host(jitter, [self.width - 1, self.height - 1], dtype)
        u = (px.to(dtype) + jitter[:, 0]) / wm1
        v = (py.to(dtype) + jitter[:, 1]) / hm1
        llc, hor, ver, org = self.lower_left_corner, self.horizontal, self.vertical, self.origin
        if frame is not None:    # each ray's own camera: (3, N) rows
            llc, hor, ver, org = (x[frame].T for x in (llc, hor, ver, org))
        comps = [llc[c] + hor[c] * u + ver[c] * v - org[c] for c in range(3)]
        direction = torch.stack(comps, dim=0)
        ln = torch.sqrt(comps[0] * comps[0] + comps[1] * comps[1] + comps[2] * comps[2])
        pos = ln > 0.0
        safe = torch.where(pos, ln, torch.ones_like(ln))
        direction = torch.where(pos[None, :], direction / safe[None, :], direction)
        origins = org if frame is not None else org[:, None].expand_as(direction)
        return origins, direction
