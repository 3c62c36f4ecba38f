"""The program under test, reached through its public API only: a scene
description becomes a ``pathtrace_tpu_torch`` scene through its
``SceneBuilder`` and material classes, and the camera through
``Camera.look_at``. Nothing of the program's tables is read back."""

from __future__ import annotations

import dataclasses

import pathtrace_tpu_torch as pt
from pathtrace_tpu_torch.models.camera import Camera

from ptbench.scene import SceneDescription


@dataclasses.dataclass
class System:
    scene: object
    camera: object
    width: int
    height: int
    integrator: str
    max_bounces: int
    method: str


def build(desc: SceneDescription, cfg: dict, device) -> System:
    """The program's scene and camera for a configuration, on ``device``."""
    b = pt.SceneBuilder(device)
    mats = [getattr(pt, kind)(**params) for kind, params in desc.materials]
    for verts, faces, mat in desc.meshes:
        b.add_mesh(verts, faces, mats[mat])
    arr = desc.arrays()
    for c, r, m in zip(arr["sph_center"], arr["sph_radius"], arr["sph_mat"]):
        b.add_sphere(tuple(float(x) for x in c), float(r), mats[int(m)])
    cam = cfg["camera"]
    camera = Camera.look_at(tuple(cam["origin"]), tuple(cam["target"]), tuple(cam["up"]),
                            cfg["width"], cfg["height"], float(cam["fov"]), device=device)
    return System(b.build(), camera, cfg["width"], cfg["height"], cfg["integrator"],
                  cfg["max_bounces"], cfg.get("method", "auto"))
