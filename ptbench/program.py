"""The program under test, reached through its public API only: a scene
description becomes a ``pathtrace_tpu_torch`` scene through its
``SceneBuilder`` and material classes, and each frame's camera through
``Camera.look_at``. Nothing of the program's tables is read back. The ranks
of a multi-rank cell join and leave the program's own process group
(``parallel.distributed``)."""

from __future__ import annotations

import dataclasses

import torch

import pathtrace_tpu_torch as pt
from pathtrace_tpu_torch.models.camera import Camera
from pathtrace_tpu_torch.parallel import distributed

from ptbench import scene
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
    cameras: list     # every frame's camera; ``camera`` is the first


def build(desc: SceneDescription, cfg: dict, device) -> System:
    """The program's scene and cameras for a configuration, on ``device``."""
    b = pt.SceneBuilder(device)
    mats = [getattr(pt, kind)(**params) for kind, params in desc.materials]
    for verts, faces, mat in desc.meshes:
        b.add_mesh(verts, faces, mats[mat])
    arr = desc.arrays()
    for c, r, m in zip(arr["sph_center"], arr["sph_radius"], arr["sph_mat"]):
        b.add_sphere(tuple(float(x) for x in c), float(r), mats[int(m)])
    cams = [Camera.look_at(tuple(c["origin"]), tuple(c["target"]), tuple(c["up"]),
                           cfg["width"], cfg["height"], float(c["fov"]), device=device)
            for c in scene.cameras(cfg)]
    return System(b.build(), cams[0], cfg["width"], cfg["height"], cfg["integrator"],
                  cfg["max_bounces"], cfg.get("method", "auto"), cams)


def prepare(device) -> None:
    """Build the program's kernel library now where the ranks run on a GPU,
    before rank 0 starts its peers: each then finds it built, rather than
    all compiling it at once while the first to finish waits for the others
    at the warm-up's barrier."""
    if torch.device(device).type == "cuda":
        from pathtrace_tpu_torch.kernels import build as kernel_build

        kernel_build.build()


def join(coordinator: str, n: int, rank: int, device, timeout_s: float):
    """Join the program's process group as ``rank`` of ``n``; returns the
    rank's device (``cuda:<rank % GPUs>`` on the card, where the program
    picks NCCL with one GPU a rank and gloo where ranks share one)."""
    distributed.initialize(coordinator, n, rank, device=device, timeout_s=timeout_s)
    if torch.device(device).type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def leave() -> None:
    distributed.shutdown()
