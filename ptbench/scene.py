"""A scene as plain data: the one description that the benchmark hands to
both the program under test and the reference.

A recipe (``ptbench/recipes/<name>.py``, found by the name a configuration
gives) builds a :class:`SceneDescription` in float64 numpy: triangles as
vertex triples, spheres as centre and radius, and a material for each. The
program receives it through its public scene builder (``ptbench/program.py``)
and the reference through ``ptbench/reference.py``; neither sees what the
other made from it. So do the configuration's frames (:func:`cameras`).
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np

# Every parameter of each material kind, with the defaults of the renderer's
# published material API (the upstream ``material.rs`` / ``mirror.rs``).
MATERIAL_PARAMS = {
    "Lambertian": {"albedo": None},
    "Emissive": {"emission": None},
    "Mirror": {"roughness": None, "color": (1.0, 1.0, 1.0), "metallic": 0.0, "ior": 1.5},
    "OrenNayar": {"albedo": None, "roughness": None},
    "PBRMaterial": {"albedo": None, "roughness": None, "metallic": 0.0, "ior": 1.5},
}


@dataclasses.dataclass
class SceneDescription:
    materials: list = dataclasses.field(default_factory=list)   # (kind, {param: value})
    tri_vertices: list = dataclasses.field(default_factory=list)  # (3, 3) float64 arrays
    tri_mat: list = dataclasses.field(default_factory=list)
    sph_center: list = dataclasses.field(default_factory=list)
    sph_radius: list = dataclasses.field(default_factory=list)
    sph_mat: list = dataclasses.field(default_factory=list)
    # The triangles as added, (vertices, faces, material) a call, so the
    # program gets each mesh whole, in the same order.
    meshes: list = dataclasses.field(default_factory=list)

    def material(self, kind: str, **params) -> int:
        """Index of a new material of ``kind`` (a key of ``MATERIAL_PARAMS``),
        every parameter filled in: the given ones, else the default."""
        if kind not in MATERIAL_PARAMS:
            raise ValueError(f"unknown material kind {kind!r}")
        full = {}
        for name, default in MATERIAL_PARAMS[kind].items():
            value = params.pop(name, default)
            if value is None:
                raise ValueError(f"{kind} needs {name!r}")
            full[name] = tuple(float(x) for x in value) if isinstance(value, (tuple, list)) \
                else float(value)
        if params:
            raise ValueError(f"{kind} has no parameter {sorted(params)}")
        self.materials.append((kind, full))
        return len(self.materials) - 1

    def add_quad(self, v0, v1, v2, v3, mat: int) -> None:
        """Two triangles ``(v0, v1, v2)`` and ``(v0, v2, v3)``."""
        self.add_mesh(np.asarray([v0, v1, v2, v3], np.float64),
                      np.asarray([[0, 1, 2], [0, 2, 3]]), mat)

    def add_mesh(self, vertices, faces, mat: int) -> None:
        vertices = np.asarray(vertices, np.float64)
        faces = np.asarray(faces, np.int64)
        self.meshes.append((vertices, faces, mat))
        self.tri_vertices.extend(vertices[faces])
        self.tri_mat.extend([mat] * len(faces))

    def add_sphere(self, center, radius: float, mat: int) -> None:
        self.sph_center.append(np.asarray(center, np.float64))
        self.sph_radius.append(float(radius))
        self.sph_mat.append(mat)

    def arrays(self) -> dict:
        """The description as float64/int64 numpy arrays: ``tri (T, 3, 3)``,
        ``tri_mat (T,)``, ``sph_center (S, 3)``, ``sph_radius (S,)``,
        ``sph_mat (S,)``."""
        return {
            "tri": np.asarray(self.tri_vertices, np.float64).reshape(-1, 3, 3),
            "tri_mat": np.asarray(self.tri_mat, np.int64),
            "sph_center": np.asarray(self.sph_center, np.float64).reshape(-1, 3),
            "sph_radius": np.asarray(self.sph_radius, np.float64),
            "sph_mat": np.asarray(self.sph_mat, np.int64),
        }


def build(scene_spec: dict) -> SceneDescription:
    """The description a configuration's ``scene`` entry names:
    ``{"recipe": <name>, "params": {...}}`` runs ``ptbench/recipes/<name>.py``'s
    ``build(**params)``."""
    recipe = importlib.import_module(f"ptbench.recipes.{scene_spec['recipe']}")
    return recipe.build(**scene_spec.get("params", {}))


def cameras(cfg: dict) -> list:
    """The configuration's frames, one camera dict each (``origin``,
    ``target``, ``up``, ``fov``): its ``camera`` (one frame), or the list
    that its ``cameras`` entry, ``{"recipe": <name>, "params": {...}}``,
    builds with ``ptbench/cameras/<name>.py``'s ``build(**params)``."""
    if "camera" in cfg:
        return [cfg["camera"]]
    recipe = importlib.import_module(f"ptbench.cameras.{cfg['cameras']['recipe']}")
    return recipe.build(**cfg["cameras"].get("params", {}))
