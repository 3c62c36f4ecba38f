"""Multi-process rendering: pixel (or frame) windows x sample windows.

Counterpart of ``pathtrace_tpu/parallel/sharding.py``, over the ranks of a
:class:`~pathtrace_tpu_torch.parallel.distributed.Mesh` (one process and one
device a rank) where the JAX module runs ``shard_map`` over a device mesh:

* ``dp`` -- pixel windows (frames, for the frame batches). Rank ``(d, s)``
  renders the contiguous window ``d`` of the flat pixel array; windows need
  no communication until the final gather.
* ``sp`` -- sample windows. The ranks of one ``sp`` group render disjoint
  sample ranges of the same pixels and ``all_reduce`` their radiance sums.

Every rank calls the same collectives in the same order, windows with no
work included: one ``all_reduce`` over ``sp`` per frame, then one gather of
the windows over ``dp`` and one of the counters over every rank.

The RNG is keyed by the global ``(pixel, sample)``, so every mesh shape
traces the sample set of the single-process render. Under ``dp`` alone each
pixel's samples run in sample order in one slot, so the pool's image equals
the single-process :func:`~pathtrace_tpu_torch.pool.render_pool` bit for
bit; ``sp > 1`` reassociates the sums (the ``all_reduce``). Ray counts are
exact for every shape.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.camera import Camera
from ..models.scene import Scene
from ..ops import intersect
from ..pool import _pool_loop
from ..render import RenderState, cast_floats, pixel_grid, render_batch
from ..utils import rng
from .distributed import Mesh, all_reduce_sum, make_global_mesh


def make_mesh(dp: Optional[int] = None, sp: Optional[int] = None) -> Mesh:
    """A ``(dp, sp)`` mesh over every rank (every rank on the pixel axis by
    default), or the 1x1 mesh when not distributed."""
    return make_global_mesh(dp, sp)


def _sample_window(mesh: Mesh, spp: int) -> tuple[int, int]:
    """This rank's ``(first sample, samples)`` of ``spp``."""
    sp = mesh.shape["sp"]
    if spp % sp:
        raise ValueError(f"spp={spp} must divide by sample-axis size {sp}")
    return mesh.coord[1] * (spp // sp), spp // sp


def _pad_to(ids: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-ids.shape[0]) % multiple
    if pad:
        # Padding pixels re-render pixel 0; their results are dropped on unpad.
        ids = torch.cat([ids, torch.zeros(pad, dtype=ids.dtype, device=ids.device)])
    return ids


def _wave_setup(scene, camera, config):
    """The scene and camera in ``config.dtype``, the route's tables and the
    RNG key, as :func:`~pathtrace_tpu_torch.render.render` makes them."""
    if config.dtype is not None:
        scene, camera = cast_floats(scene, config.dtype), cast_floats(camera, config.dtype)
    return (scene, camera, intersect.build_tables(scene, config.method),
            rng.base_key(config.seed, scene.device))


def _wave_sum(scene, camera, ids, start, n, key, tables, config):
    """``render_batch`` of ``n`` samples from ``start``: ``(sum (N, 3), rays)``."""
    return render_batch(
        scene, camera, ids, start, key, width=config.width, height=config.height,
        integrator=config.integrator, max_bounces=config.max_bounces, samples_per_batch=n,
        num_light_samples=config.num_light_samples, tables=tables)


def render_sharded(scene: Scene, camera: Camera, config, mesh: Optional[Mesh] = None
                   ) -> RenderState:
    """The wave engine over the mesh: the same :class:`RenderState` as
    :func:`~pathtrace_tpu_torch.render.render` on every rank (its
    ``ray_queries`` this rank's). Rank ``(d, s)`` traces window ``d`` of the
    pixel grid (padded with pixel 0 to a multiple of ``dp``) over sample
    window ``s``, in one :func:`render_batch`."""
    mesh = mesh or make_mesh()
    scene, camera, tables, key = _wave_setup(scene, camera, config)
    start, n = _sample_window(mesh, config.spp)
    w, h = config.width, config.height
    ids = _pad_to(pixel_grid(w, h, scene.device), mesh.shape["dp"])
    n_local = ids.shape[0] // mesh.shape["dp"]
    d = mesh.coord[0]
    acc, rays = _wave_sum(scene, camera, ids[d * n_local:(d + 1) * n_local], start, n, key,
                          tables, config)
    acc = all_reduce_sum(acc, mesh.sp_group)
    image = torch.from_numpy(mesh.gather_dp(acc).reshape(-1, 3)[:w * h]).to(scene.device)
    return RenderState(image.reshape(h, w, 3), config.spp, rays)


def render_pool_sharded(
    scene: Scene,
    camera: Camera,
    *,
    mesh: Mesh,
    width: int,
    height: int,
    spp: int,
    integrator: str = "mis",
    max_bounces: int = 64,
    num_slots: int = 32768,
    seed: int = 0,
    sample_offset: int = 0,
    method: str | None = None,
):
    """The persistent pool over the mesh: rank ``(d, s)`` runs its own pool
    (:func:`~pathtrace_tpu_torch.pool._pool_loop`) on pixel window ``[d *
    ceil(N / dp), ...)`` (the last may overhang the frame) and sample window
    ``[sample_offset + s * spp / sp, ...)``; the sample windows'
    sums ``all_reduce`` over ``sp``. Each rank's pool drains on its own until
    that ``all_reduce``.

    Returns, on every rank, ``(image_sum (H*W, 3) on the scene's device,
    counters (dp, sp, 4) int64, iters (dp, sp))``; decode the counters with
    :func:`~pathtrace_tpu_torch.pool.ray_count` /
    :func:`~pathtrace_tpu_torch.pool.busy_count`.
    """
    start, n = _sample_window(mesh, spp)
    num_pixels = width * height
    local_n = -(-num_pixels // mesh.shape["dp"])
    img, counters, iters = _pool_loop(
        scene, camera, mesh.coord[0] * local_n, start + sample_offset, width=width,
        height=height, total_pixels=num_pixels, local_pixels=local_n, spp=n,
        integrator=integrator, max_bounces=max_bounces, num_slots=num_slots, seed=seed,
        method=method)
    img = all_reduce_sum(img, mesh.sp_group)
    image = torch.from_numpy(mesh.gather_dp(img).reshape(-1, 3)[:num_pixels])
    return (image.to(scene.device), torch.from_numpy(mesh.gather_all(counters)),
            torch.from_numpy(mesh.gather_all(np.int64(iters))))


def stack_cameras(cameras) -> Camera:
    """Stack same-resolution cameras into one camera with a leading frame
    axis on each vector (the unit the frame batches shard over ``dp``)."""
    w, h = cameras[0].width, cameras[0].height
    if any(c.width != w or c.height != h for c in cameras):
        raise ValueError("all cameras in a frame batch must share a resolution")
    return dataclasses.replace(cameras[0], **{
        f.name: torch.stack([getattr(c, f.name) for c in cameras])
        for f in dataclasses.fields(Camera) if f.name not in ("width", "height")})


def _frame(cams: Camera, i: int) -> Camera:
    return dataclasses.replace(cams, **{
        f.name: getattr(cams, f.name)[i]
        for f in dataclasses.fields(Camera) if f.name not in ("width", "height")})


def _frame_block(mesh: Mesh, n_frames: int) -> range:
    """This rank's frames: the contiguous block ``d`` of ``ceil(F / dp)``.
    Frames past the last (padding, which the ranks of one ``sp`` group
    share) are not rendered (JAX renders them and drops them); their zero
    rows keep every rank's gather the same size."""
    per = -(-n_frames // mesh.shape["dp"])
    return range(mesh.coord[0] * per, (mesh.coord[0] + 1) * per)


def frames_pool_sharded(
    scene: Scene,
    cameras,
    config,
    mesh: Optional[Mesh] = None,
    num_slots: int = 32768,
    method: str | None = None,
    chunk_frames: int | None = 8,
):
    """A camera batch on the persistent pool (BASELINE config 5): frames
    shard over ``dp`` in contiguous blocks of ``ceil(F / dp)``, sample
    windows over ``sp``; each frame is a whole-frame pool render, its sample
    windows summed by an ``all_reduce`` over ``sp``. ``method`` None takes
    ``config.method``, and ``config.dtype`` widens the scene and cameras as
    in ``render_pool``.

    ``chunk_frames`` is accepted for the JAX signature and has no effect:
    there it bounded the frames of one TPU dispatch (a workaround for the
    runtime's watchdog), and a rank here renders one frame a call.

    Returns ``(frames (F, H, W, 3) mean radiance on the scene's device,
    counters (F, sp, 4), iters (F, sp))`` in input order.
    """
    mesh = mesh or make_mesh()
    start, n = _sample_window(mesh, config.spp)
    cams = stack_cameras(list(cameras))
    if config.dtype is not None:
        scene, cams = cast_floats(scene, config.dtype), cast_floats(cams, config.dtype)
    method = method if method is not None else config.method
    n_frames = cams.origin.shape[0]
    w, h = config.width, config.height
    fdt = cams.origin.cpu().numpy().dtype
    accs, counters, iters = [], [], []
    for f in _frame_block(mesh, n_frames):
        if f >= n_frames:
            accs.append(np.zeros((w * h, 3), fdt))
            counters.append(np.zeros(4, np.int64))
            iters.append(0)
            continue
        img, ctr, it = _pool_loop(
            scene, _frame(cams, f), 0, start, width=w, height=h, total_pixels=w * h,
            local_pixels=w * h, spp=n, integrator=config.integrator,
            max_bounces=config.max_bounces, num_slots=min(num_slots, w * h),
            seed=config.seed, method=method)
        accs.append(all_reduce_sum(img, mesh.sp_group).cpu().numpy())
        counters.append(ctr.cpu().numpy())
        iters.append(it)
    acc = mesh.gather_dp(np.stack(accs)).reshape(-1, w * h, 3)[:n_frames]
    # (dp, sp, frames of a block, ...) -> (F, sp, ...)
    ctr = mesh.gather_all(np.stack(counters)).swapaxes(1, 2).reshape(-1, mesh.shape["sp"], 4)
    its = mesh.gather_all(np.asarray(iters, np.int64)).swapaxes(1, 2).reshape(
        -1, mesh.shape["sp"])
    frames = torch.from_numpy(acc).to(scene.device).reshape(n_frames, h, w, 3) / config.spp
    return frames, torch.from_numpy(ctr[:n_frames]), torch.from_numpy(its[:n_frames])


def frames_sharded(scene: Scene, cameras, config, mesh: Optional[Mesh] = None
                   ) -> torch.Tensor:
    """A camera batch on the wave engine (BASELINE config 5): frames shard
    over ``dp`` in contiguous blocks of ``ceil(F / dp)``, sample windows over
    ``sp``, summed by an ``all_reduce``. Returns ``(F, H, W, 3)`` mean
    radiance on the scene's device, in input order."""
    mesh = mesh or make_mesh()
    cams = stack_cameras(list(cameras))
    scene, cams, tables, key = _wave_setup(scene, cams, config)
    start, n = _sample_window(mesh, config.spp)
    n_frames = cams.origin.shape[0]
    ids = pixel_grid(config.width, config.height, scene.device)
    accs = []
    for f in _frame_block(mesh, n_frames):
        if f >= n_frames:
            accs.append(np.zeros((ids.shape[0], 3), cams.origin.cpu().numpy().dtype))
            continue
        acc, _ = _wave_sum(scene, _frame(cams, f), ids, start, n, key, tables, config)
        accs.append(all_reduce_sum(acc, mesh.sp_group).cpu().numpy())
    acc = mesh.gather_dp(np.stack(accs)).reshape(-1, ids.shape[0], 3)[:n_frames]
    return (torch.from_numpy(acc).to(scene.device)
            .reshape(n_frames, config.height, config.width, 3) / config.spp)
