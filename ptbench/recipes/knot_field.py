"""A ~70k-triangle torus-knot tube (standing in for the Stanford bunny)
among two mirror spheres on a ground quad, under an emissive dome: the
renderer's mesh benchmark scene (``BASELINE.json`` config 4).

The mesh is the float64 arithmetic of ``pathtrace_tpu_torch.meshes.knot_mesh``
and ``grid_mesh`` (copied), and the scene the order of
``pathtrace_tpu_torch.models.scenes.mesh_scene``, so the same parameters
give the same triangles in the same order.
"""

from __future__ import annotations

import numpy as np

from ptbench.scene import SceneDescription


def grid_mesh(nu: int, nv: int) -> np.ndarray:
    """Quad-grid triangulation of a (nu, nv) parameter grid wrapped both ways."""
    faces = []
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = ((i + 1) % nu) * nv + (j + 1) % nv
            d = i * nv + (j + 1) % nv
            faces.append([a, b, c])
            faces.append([a, c, d])
    return np.asarray(faces, np.int64)


def knot_mesh(n_tris: int, p: int = 2, q: int = 3, tube_radius: float = 0.35,
              scale: float = 1.0, center=(0.0, 0.0, 0.0), bumps: float = 0.06):
    """Closed (p, q)-torus-knot tube of about ``n_tris`` triangles with a
    bumpy surface: ``(vertices (V, 3), faces (F, 3))``."""
    nv = max(int(np.sqrt(n_tris / 8)), 4)
    nu = max(n_tris // (2 * nv), 8)

    t = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    r = np.cos(q * t) + 2.0
    cl = np.stack([r * np.cos(p * t), r * np.sin(p * t), -np.sin(q * t)], axis=1)

    tang = np.roll(cl, -1, axis=0) - np.roll(cl, 1, axis=0)
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    nrm = np.cross(tang, np.asarray([0.0, 0.0, 1.0]))
    bad = np.linalg.norm(nrm, axis=1) < 1e-6
    nrm[bad] = np.cross(tang[bad], [0.0, 1.0, 0.0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    bin_ = np.cross(tang, nrm)

    s = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    cos_s, sin_s = np.cos(s), np.sin(s)
    rad = tube_radius * (
        1.0
        + bumps * np.sin(7 * t)[:, None] * np.cos(5 * s)[None, :]
        + bumps * np.cos(11 * t)[:, None] * np.sin(3 * s)[None, :]
    )
    pts = (
        cl[:, None, :]
        + rad[..., None] * (cos_s[None, :, None] * nrm[:, None, :]
                            + sin_s[None, :, None] * bin_[:, None, :])
    )
    verts = pts.reshape(-1, 3)
    lo, hi = verts.min(0), verts.max(0)
    verts = (verts - (lo + hi) / 2) / (hi - lo).max() * 2.0 * scale + np.asarray(center)
    return verts, grid_mesh(nu, nv)


def build(n_tris: int = 70000) -> SceneDescription:
    s = SceneDescription()
    s.add_quad((-40, -1.0, -40), (40, -1.0, -40), (40, -1.0, 40), (-40, -1.0, 40),
               s.material("Lambertian", albedo=(0.45, 0.45, 0.45)))
    verts, faces = knot_mesh(n_tris, scale=1.2, center=(0.0, 0.35, 0.0))
    s.add_mesh(verts, faces, s.material("Lambertian", albedo=(0.65, 0.45, 0.25)))
    s.add_sphere((-2.6, -0.3, 1.2), 0.7, s.material("Mirror", roughness=0.05, metallic=1.0,
                                                    color=(0.9, 0.9, 0.95)))
    s.add_sphere((2.6, -0.3, 1.2), 0.7, s.material("Mirror", roughness=0.05, metallic=0.0,
                                                   ior=1.5))
    s.add_sphere((0.0, 40.0, 0.0), 22.0, s.material("Emissive", emission=(5.0, 5.0, 5.0)))
    return s
