"""Built-in scenes of the pool path (counterpart of
``pathtrace_tpu/models/scenes.py``, same constants and insertion order).

``cornell_box`` is the reference renderer's scene (the parity anchor and the
compile-check entry point's workload); ``many_spheres`` is the benchmark's
sphere field; ``default_spheres`` is the small bring-up scene; ``mesh_scene``
is the ~70k-triangle mesh scene (BASELINE config 4).
"""

from __future__ import annotations

import numpy as np

from .camera import Camera
from .materials import Emissive, Lambertian, Mirror
from .scene import Scene, SceneBuilder


def cornell_box(device="cuda") -> Scene:
    box_size = 1.0
    box_depth = -2.0
    light_size = 0.3

    red = Lambertian((0.8, 0.1, 0.1))
    green = Lambertian((0.1, 0.8, 0.1))
    blue = Lambertian((0.2, 0.2, 0.8))
    cyan = Lambertian((0.2, 0.8, 0.8))
    white = Lambertian((0.8, 0.8, 0.8))
    light = Emissive((15.0, 15.0, 15.0))
    glass = Mirror(roughness=0.3, color=(1.0, 1.0, 1.0), metallic=0.0, ior=1.5)

    b = SceneBuilder(device)
    s, d, ls = box_size, box_depth, light_size

    b.add_triangle((-s, -s, d - s), (-s, s, d - s), (-s, s, d + s), red)
    b.add_triangle((-s, -s, d - s), (-s, s, d + s), (-s, -s, d + s), red)
    b.add_triangle((s, -s, d - s), (s, s, d + s), (s, s, d - s), green)
    b.add_triangle((s, -s, d - s), (s, -s, d + s), (s, s, d + s), green)
    b.add_triangle((-s, -s, d - s), (s, -s, d - s), (s, s, d - s), blue)
    b.add_triangle((-s, -s, d - s), (s, s, d - s), (-s, s, d - s), blue)
    b.add_triangle((-s, -s, d - s), (s, -s, d + s), (s, -s, d - s), cyan)
    b.add_triangle((-s, -s, d - s), (-s, -s, d + s), (s, -s, d + s), cyan)
    b.add_triangle((-s, s, d - s), (s, s, d - s), (s, s, d + s), white)
    b.add_triangle((-s, s, d - s), (s, s, d + s), (-s, s, d + s), white)
    b.add_triangle((-ls, s - 0.01, d - ls), (ls, s - 0.01, d - ls), (ls, s - 0.01, d + ls), light)
    b.add_triangle((-ls, s - 0.01, d - ls), (ls, s - 0.01, d + ls), (-ls, s - 0.01, d + ls), light)
    b.add_sphere((0.4, -0.6, d), 0.4, glass)

    return b.build()


def cornell_camera(width: int = 400, height: int = 400, device="cuda") -> Camera:
    """Origin (0,0,2), screen distance 1, FOV 35 degrees."""
    return Camera.perspective((0.0, 0.0, 2.0), width, height, 1.0, 35.0, device=device)


def default_spheres(device="cuda") -> Scene:
    """Ground plane plus a few diffuse, metal, glass and emissive spheres."""
    b = SceneBuilder(device)
    ground = Lambertian((0.5, 0.5, 0.5))
    b.add_quad((-20, 0, -20), (20, 0, -20), (20, 0, 20), (-20, 0, 20), ground)
    b.add_sphere((0.0, 1.0, -3.0), 1.0, Lambertian((0.7, 0.3, 0.3)))
    b.add_sphere((-2.2, 1.0, -3.0), 1.0, Mirror(roughness=0.05, metallic=1.0))
    b.add_sphere((2.2, 1.0, -3.0), 1.0, Mirror(roughness=0.1, metallic=0.0, ior=1.5))
    b.add_sphere((0.0, 6.0, -3.0), 1.5, Emissive((12.0, 12.0, 12.0)))
    return b.build()


def default_spheres_camera(width: int = 256, height: int = 256, device="cuda") -> Camera:
    return Camera.look_at((0.0, 2.0, 4.0), (0.0, 1.0, -3.0), (0.0, 1.0, 0.0),
                          width, height, 55.0, device=device)


def many_spheres(seed: int = 3, n_per_side: int = 11, device="cuda") -> Scene:
    """Random sphere field (diffuse/metal/glass) under an emissive dome."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(device)
    b.add_quad((-60, 0, -60), (60, 0, -60), (60, 0, 60), (-60, 0, 60), Lambertian((0.5, 0.5, 0.5)))

    for a in range(-n_per_side, n_per_side):
        for c in range(-n_per_side, n_per_side):
            choose = rng.random()
            center = (a + 0.9 * rng.random(), 0.2, c + 0.9 * rng.random())
            if choose < 0.7:
                albedo = tuple((rng.random(3) * rng.random(3)).tolist())
                m = Lambertian(albedo)
            elif choose < 0.9:
                color = tuple((0.5 + 0.5 * rng.random(3)).tolist())
                m = Mirror(roughness=0.5 * rng.random(), color=color, metallic=1.0)
            else:
                m = Mirror(roughness=0.05, metallic=0.0, ior=1.5)
            b.add_sphere(center, 0.2, m)

    b.add_sphere((0.0, 1.0, 0.0), 1.0, Mirror(roughness=0.02, metallic=0.0, ior=1.5))
    b.add_sphere((-4.0, 1.0, 0.0), 1.0, Lambertian((0.4, 0.2, 0.1)))
    b.add_sphere((4.0, 1.0, 0.0), 1.0, Mirror(roughness=0.02, color=(0.7, 0.6, 0.5), metallic=1.0))
    b.add_sphere((0.0, 55.0, 0.0), 30.0, Emissive((4.0, 4.0, 4.0)))
    return b.build()


def many_spheres_camera(width: int = 512, height: int = 512, device="cuda") -> Camera:
    return Camera.look_at((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                          width, height, 30.0, device=device)


def mesh_scene(n_tris: int = 70000, device="cuda") -> Scene:
    """A ~``n_tris``-triangle torus knot (standing in for the Stanford bunny)
    among spheres on a ground plane, under an emissive dome."""
    from ..meshes import knot_mesh

    b = SceneBuilder(device)
    b.add_quad((-40, -1.0, -40), (40, -1.0, -40), (40, -1.0, 40), (-40, -1.0, 40),
               Lambertian((0.45, 0.45, 0.45)))
    verts, faces = knot_mesh(n_tris=n_tris, scale=1.2, center=(0.0, 0.35, 0.0))
    b.add_mesh(verts, faces, Lambertian((0.65, 0.45, 0.25)))
    b.add_sphere((-2.6, -0.3, 1.2), 0.7, Mirror(roughness=0.05, metallic=1.0,
                                                color=(0.9, 0.9, 0.95)))
    b.add_sphere((2.6, -0.3, 1.2), 0.7, Mirror(roughness=0.05, metallic=0.0, ior=1.5))
    b.add_sphere((0.0, 40.0, 0.0), 22.0, Emissive((5.0, 5.0, 5.0)))
    return b.build()


def mesh_scene_camera(width: int = 1920, height: int = 1080, device="cuda") -> Camera:
    return Camera.look_at((0.0, 1.6, 5.5), (0.0, 0.2, 0.0), (0.0, 1.0, 0.0),
                          width, height, 40.0, device=device)


def sweep_cameras(num_frames: int = 120, width: int = 640, height: int = 360,
                  radius: float = 5.5, target=(0.0, 0.2, 0.0), fov: float = 40.0,
                  device="cuda"):
    """BASELINE config 5: a circular camera sweep around the mesh scene."""
    cams = []
    for f in range(num_frames):
        a = 2.0 * np.pi * f / num_frames
        origin = (radius * np.sin(a), 1.6, radius * np.cos(a))
        cams.append(Camera.look_at(origin, target, (0.0, 1.0, 0.0), width, height, fov,
                                   device=device))
    return cams
