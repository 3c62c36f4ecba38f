"""Triangle meshes (numpy only): Wavefront OBJ I/O and procedural generators.

Counterpart of ``pathtrace_tpu/meshes.py``, same float64 arithmetic, so the
vertices and faces are identical: :func:`knot_mesh` is the ~70k-triangle
torus-knot tube that stands in for the Stanford bunny in the mesh benchmark
scene, and :func:`load_obj`/:func:`save_obj` round-trip Wavefront files for
users with real assets. :func:`load_obj` is the JAX package's pure-Python
reader; its native speed path (``csrc/meshio.cpp``) is not ported.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Wavefront OBJ reader: ``v`` and ``f`` records. Faces with more than 3
    vertices are fan-triangulated; ``v/vt/vn`` tokens keep their vertex
    index; negative indices count back from the last vertex read. Returns
    ``(vertices (V,3) float64, faces (F,3) int64)``."""
    verts = []
    faces = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def save_obj(path: str, vertices, faces) -> None:
    """Write ``v`` records (6 decimals) and 1-based triangle ``f`` records."""
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in np.asarray(faces):
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def grid_mesh(nu: int, nv: int, wrap_u: bool = True, wrap_v: bool = True):
    """Quad-grid triangulation indices for a (nu, nv) parameter grid."""
    faces = []
    umax = nu if wrap_u else nu - 1
    vmax = nv if wrap_v else nv - 1
    for i in range(umax):
        for j in range(vmax):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = ((i + 1) % nu) * nv + (j + 1) % nv
            d = i * nv + (j + 1) % nv
            faces.append([a, b, c])
            faces.append([a, c, d])
    return np.asarray(faces, np.int64)


def knot_mesh(n_tris: int = 70000, p: int = 2, q: int = 3, tube_radius: float = 0.35,
              scale: float = 1.0, center=(0.0, 0.0, 0.0), bumps: float = 0.06):
    """Closed (p,q)-torus-knot tube with ~``n_tris`` triangles and a bumpy
    surface, so normals vary like a scanned model.

    Returns ``(vertices (V,3) float64, faces (F,3) int64)``.
    """
    # n_tris = 2 * nu * nv with nu:nv about 4:1 along the knot.
    nv = max(int(np.sqrt(n_tris / 8)), 4)
    nu = max(n_tris // (2 * nv), 8)

    t = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    r = np.cos(q * t) + 2.0
    cl = np.stack([r * np.cos(p * t), r * np.sin(p * t), -np.sin(q * t)], axis=1)

    # Frame from finite differences of the centerline.
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
    # Fit into a unit-ish box, then place.
    lo, hi = verts.min(0), verts.max(0)
    verts = (verts - (lo + hi) / 2) / (hi - lo).max() * 2.0 * scale + np.asarray(center)
    return verts, grid_mesh(nu, nv)


def icosphere(subdivisions: int = 3, radius: float = 1.0, center=(0.0, 0.0, 0.0)):
    """Subdivided icosahedron (20 * 4**subdivisions triangles)."""
    phi = (1 + np.sqrt(5)) / 2
    verts = np.asarray(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        np.float64,
    )
    faces = np.asarray(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                verts.append((np.asarray(verts[a]) + np.asarray(verts[b])) / 2)
                edge_mid[key] = len(verts) - 1
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = np.asarray(new_faces, np.int64)
        verts = np.asarray(verts)

    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True) * radius
    return verts + np.asarray(center), faces
