"""Render observability: structured per-render statistics.

Counterpart of ``pathtrace_tpu/profiler.py``: :func:`profiled_render` runs a
pool render and returns a :class:`RenderStats` record beside the render
state, with the JAX package's fields, names and rounding. The timed window
ends with ``torch.cuda.synchronize()`` on the card (the JAX package's
``block_until_ready``), so it holds the device's work and not only its
enqueue. :func:`device_work` reads the device's side of a call from
``torch.profiler``: device time, device operations, and the time of each
named hand-written kernel.
"""

from __future__ import annotations

import dataclasses
import json
import re
import time
from typing import Callable, Iterable, Optional

import torch

from .models.camera import Camera
from .models.scene import Scene
from .pool import ray_count, render_pool
from .render import RenderState


@dataclasses.dataclass
class RenderStats:
    width: int
    height: int
    spp: int
    integrator: str
    traced_rays: int
    pool_iterations: int
    wall_s: float
    mrays_per_s: float
    spp_per_s: float
    platform: str   # "cuda" or "cpu": the device the render ran on

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def profiled_render(
    scene: Scene,
    camera: Camera,
    *,
    width: int,
    height: int,
    spp: int,
    integrator: str = "mis",
    max_bounces: int = 64,
    num_slots: int = 32768,
    seed: int = 0,
    sample_offset: int = 0,
    state: Optional[RenderState] = None,
):
    """Pool render on ``scene.device`` returning ``(RenderState, RenderStats)``;
    ``state``, when given, is the progressive state this render adds to.

    The wall includes building the CUDA kernels on a process's first launch;
    render once before (or pre-warm) for steady-state numbers.
    """
    t0 = time.perf_counter()
    image_sum, rays, iters = render_pool(
        scene,
        camera,
        width=width,
        height=height,
        spp=spp,
        integrator=integrator,
        max_bounces=max_bounces,
        num_slots=num_slots,
        seed=seed,
        sample_offset=sample_offset,
    )
    if image_sum.is_cuda:
        torch.cuda.synchronize(image_sum.device)
    wall = time.perf_counter() - t0

    traced = ray_count(rays)
    image = image_sum.reshape(height, width, 3)
    if state is not None:
        image = state.image_sum + image
        spp_total, queries = state.num_samples + spp, state.ray_queries + traced
    else:
        spp_total, queries = spp, traced

    stats = RenderStats(
        width=width,
        height=height,
        spp=spp,
        integrator=integrator,
        traced_rays=traced,
        pool_iterations=int(iters),
        wall_s=round(wall, 4),
        mrays_per_s=round(traced / wall / 1e6, 3),
        spp_per_s=round(spp / wall, 4),
        platform=scene.device.type,
    )
    return RenderState(image, spp_total, queries), stats


def device_work(fn: Callable[[], object], kernel_names: Iterable[str]
                ) -> tuple[float | None, int, dict]:
    """``(ms, ops, kernel_ms)`` of one call of ``fn`` on the card, from
    ``torch.profiler`` with CUDA activity only: the device time, the number
    of device operations (kernels, copies, fills), and the device ms of each
    kernel of ``kernel_names`` that ran (the hand-written kernels are
    ``<name>_kernel`` in ``csrc/``). ``ms`` is None when the profiler saw no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    pattern = re.compile(r"(?<!\w)(" + "|".join(kernel_names) + r")_kernel\b")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us, ops, kernel_us = 0.0, 0, {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            us += t
            ops += e.count
            match = pattern.search(e.key)
            if match:
                kernel_us[match[1]] = kernel_us.get(match[1], 0.0) + t
    return (us / 1e3 if us > 0 else None), ops, {k: v / 1e3 for k, v in kernel_us.items()}
