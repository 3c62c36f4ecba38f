"""The renderer's many-sphere scene, after the final scene of "Ray Tracing
in One Weekend" (Shirley): a ground quad, a grid of small spheres of random
material, three large spheres and an emissive dome. It departs from the
book where ``configs/rtiow_1080p.json`` lists under ``assumed``.

Its draws are those of ``pathtrace_tpu_torch.models.scenes.many_spheres``
(copied: numpy's ``default_rng(seed)`` in the same order), so the layout
seed 3 with 11 spheres a side gives the renderer's benchmark scene, 488
spheres and 2 triangles.
"""

from __future__ import annotations

import numpy as np

from ptbench.scene import SceneDescription


def build(seed: int = 3, n_per_side: int = 11) -> SceneDescription:
    rng = np.random.default_rng(seed)
    s = SceneDescription()
    s.add_quad((-60, 0, -60), (60, 0, -60), (60, 0, 60), (-60, 0, 60),
               s.material("Lambertian", albedo=(0.5, 0.5, 0.5)))
    for a in range(-n_per_side, n_per_side):
        for c in range(-n_per_side, n_per_side):
            choose = rng.random()
            center = (a + 0.9 * rng.random(), 0.2, c + 0.9 * rng.random())
            if choose < 0.7:
                m = s.material("Lambertian",
                               albedo=tuple((rng.random(3) * rng.random(3)).tolist()))
            elif choose < 0.9:
                color = tuple((0.5 + 0.5 * rng.random(3)).tolist())
                m = s.material("Mirror", roughness=0.5 * rng.random(), color=color,
                               metallic=1.0)
            else:
                m = s.material("Mirror", roughness=0.05, metallic=0.0, ior=1.5)
            s.add_sphere(center, 0.2, m)
    s.add_sphere((0.0, 1.0, 0.0), 1.0, s.material("Mirror", roughness=0.02, metallic=0.0,
                                                  ior=1.5))
    s.add_sphere((-4.0, 1.0, 0.0), 1.0, s.material("Lambertian", albedo=(0.4, 0.2, 0.1)))
    s.add_sphere((4.0, 1.0, 0.0), 1.0, s.material("Mirror", roughness=0.02,
                                                  color=(0.7, 0.6, 0.5), metallic=1.0))
    s.add_sphere((0.0, 55.0, 0.0), 30.0, s.material("Emissive", emission=(4.0, 4.0, 4.0)))
    return s
