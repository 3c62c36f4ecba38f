"""Batched ray-scene intersection of the wave engine and the pool's composed
branch.

Counterpart of ``pathtrace_tpu/ops/intersect.py`` on the three routes that
``resolve_auto`` picks by default (:func:`resolve_route`):

* **small** (<= 64 triangle rows and <= 512 sphere rows): one fused closest
  hit, :func:`combined_closest_small` (``csrc/combined_closest_small.cu``,
  each ray's sweep split over a team of threads), replacing
  ``pallas_intersect.combined_closest_small``;
* **flat** (64 < triangles < 4096, or fewer triangles beside more than 512
  spheres): :func:`sphere_closest`, then :func:`triangle_closest`
  (``csrc/triangle_closest.cu``, replacing
  ``pallas_intersect.triangle_closest``) over 256-row clusters, walked
  nearest-first by a team of threads a ray up to the table's real rows,
  capped by the sphere hits;
* **bvh** (>= 4096 triangles): :func:`sphere_closest`, then
  :func:`bvh_closest` (``csrc/bvh.cu``, replacing
  ``bvh_intersect.triangle_closest_bvh``, with its ``counters=True`` mode)
  over the two-level hierarchy the JAX package derives from row order
  (128-row leaves under 16-leaf groups), walked nearest-first by a team of
  threads a ray; :func:`bvh_traversal_reference` is that walk in plain
  torch, with its per-ray counts;

and on the two opt-in per-ray traversals that ``method="binned"`` and
``method="resident"`` pick for every scene past 64 triangles:

* **binned**: :func:`sphere_closest`, then the round-by-round driver of
  ``ops/binned.py`` over the flat route's 256-row clusters (its round
  kernels ``csrc/binned.cu`` replace ``binned_intersect._run_round_*``);
* **resident**: :func:`sphere_closest`, then :func:`resident_closest`
  (``csrc/resident.cu``, replacing ``resident_intersect``'s kernels): one
  launch walks each ray's 128-row clusters nearest-first with a team of
  threads (its any hit sweeps them in id order);
  :func:`resident_walk_reference` is that walk in plain torch, with its
  per-ray counts.

Past 512 sphere rows (the JAX ``sph_small`` gate) every route passes the
sphere kernels the 256-row sphere cluster boxes (``Tables.sph_box``), and
:func:`sphere_closest` and :func:`any_hit` run their clustered mode, as the
JAX ``sphere_closest``/``any_hit`` do: a team of threads walks each ray's
entered clusters nearest-first (``csrc/intersect.cu``);
:func:`cluster_walk_reference` is that walk in plain torch, with its
per-ray counts. A scene with <= 64 triangles and more
than 512 spheres takes the flat route: the JAX package skips
``combined_closest_small`` there and runs the one-tile ``triangle_closest``
beside the clustered spheres; the flat route's one padded 256-row cluster,
swept up to its real rows, gives the same answers.

Shadow rays go through :func:`any_hit` (``csrc/intersect.cu``, replacing
``pallas_intersect.any_hit``) over the spheres and every triangle row on the
small and flat routes (the flat route with its triangle cluster boxes); on
the bvh, binned and resident routes through the route's triangle any-hit
(:func:`bvh_anyhit`, ``binned.triangle_anyhit_binned``,
:func:`resident_anyhit`) plus :func:`any_hit` over the spheres alone.

Every kernel has a plain-torch twin here, brute force over every row in the
kernels' op order (triangles in chunks of ``TWIN_CHUNK``); a kernel must give
the same answer, which is what ``chip_smoke.py`` checks on the card. The
wrappers dispatch on the device of their inputs: CPU tensors run the twin,
CUDA tensors launch the kernel (or raise); there is no fallback. Each launch
adds one to ``shade.LAUNCHES`` under the kernel's name, the clustered mode of
``sphere_closest``/``any_hit`` under ``*_clustered``, a float64 instance
under ``*_f64``.

:func:`intersect` and :func:`occluded` compose them as the JAX package does:
global prim ids are triangle rows, then spheres offset by the padded
triangle row count; a sphere wins only when strictly nearer. Epsilons are
the reference's: 1e-8 parallel reject, inclusive barycentric bounds, closed
``[t_min, t_max]``.

Left behind from the JAX routes: the ray sort before each trace on big
meshes (``_ray_sort_key``/``_sort_rays_by_key``/``_unsort``), which changes
no result and keeps TPU subtiles union-coherent (on the GPU, rays sorted by
first entered group move the BVH kernels by under 0.01 ms, less than a sort
costs: PERF.md), the ``coherent`` hint, and the ``_lift_tree`` varying-axes
plumbing. Rays are ``(N, 3)`` float32 or float64; ``t_min``/``t_max`` are
``(N,)``.

float64 (the reference's precision) runs on every route: every wrapper
here and the binned driver take float64 rays and tables (boxes included,
built in the scene's dtype), launch their kernels' float64 instances and
count them under ``*_f64``; their twins run in the rays' dtype.

Left behind from the JAX module, none of which a user of the port's entry
points reaches:

* ``occluded_transposed``: the JAX pool calls it only with the quad shadow
  off (``pathtrace_tpu/pool.py:489-502``); the port's pool computes the same
  occlusion of its ``(3, S)`` shadow rays with ``shade.shadow_any_hit``;
* the ``*_interpret`` methods (the Pallas kernels in interpret mode, a
  TPU-less debugging aid: the twins here are the port's);
* ``method="mxu"`` with ``sphere_hit_ts_mxu``/``triangle_hit_ts_mxu`` (the
  hit tests as TPU matrix products);
* ``fused_bounce``'s ``sections`` knob (how the TPU kernel tiles its
  sweep; the port's split is ``kernels/binding.py :: sweep_split``);
* the process-global ``set_default_method``/``default_method``: the port
  takes ``method=`` per call (``render_pool``, ``RenderConfig``, the CLI's
  ``--method``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import profiler
from ..models.scene import CLUSTER_SIZE, SPH_CLUSTER_SIZE, Scene
from ..utils import vec
from .shade import _SUFFIX, LAUNCHES, _check, _device_kind, _sphere_ts, _tri_hits

_INF = float("inf")

SMALL_MAX_TRIS = 64       # one-tile triangle bound of resolve_auto's routes
SMALL_MAX_SPHERES = 512   # one-tile sphere bound; the clustered modes lie above
BVH_MIN_TRIS = 4096       # RAY_SORT_MIN_TRIS: the BVH route from here up
LEAF = 128         # triangles per BVH leaf and per resident cluster
GROUP = 16         # leaves per supergroup
TWIN_CHUNK = 2048  # triangle rows per step of the brute-force twins
# bvh_closest(counters=True): sums over spans of 256 lanes (the JAX SUB_W)
# of the wave padded to whole tiles of 1024 lanes (the JAX RAY_TILE).
_COUNTER_SPAN, _COUNTER_TILE = 256, 1024
_TRI_COLS = 16     # v0, e1, e2, normal, material, 3 zeros
_SPH_COLS = 8      # center, |c|^2 - r^2 (NaN on padding), 1/r, material, 2 zeros
_BOX_COLS = 8      # min, max, 2 zeros (sphere boxes: min, max, reach, least radius)
# Outward margin of the cluster boxes of the flat, binned and resident
# routes, relative to 1 + their largest coordinate: slab-test rounding then
# never culls a cluster that holds a hit the brute-force twin accepts.
_BOX_MARGIN = 1e-4
# csrc/intersect.cu RootErr: the sphere root's error over L^2, 128 u of the
# dtype (u = 2^-24 in float32, 2^-53 in float64).
_ROOT_ERR = {torch.float32: 2.0**-17, torch.float64: 2.0**-46}


class Hit(NamedTuple):
    """Hit records of a wave; a miss is ``prim == -1`` and ``t == inf``."""

    t: torch.Tensor           # (N,)
    prim: torch.Tensor        # (N,) int32 global prim id, -1 = miss
    point: torch.Tensor       # (N, 3)
    normal: torch.Tensor      # (N, 3) face-forwarded normal
    front_face: torch.Tensor  # (N,) bool
    mat: torch.Tensor         # (N,) int32 material id (0 on a miss)

    @property
    def valid(self) -> torch.Tensor:
        return self.prim >= 0


class Tables(NamedTuple):
    """Scene tables packed for one route's kernels (built once per render)."""

    tri: torch.Tensor    # (rows, 16): the scene's rows (small), zero-padded to
    #                      whole 256-row clusters (flat, binned), 128-row
    #                      clusters (resident) or 16-leaf groups (bvh)
    leaf: torch.Tensor   # (blocks, 8) AABBs of the triangle blocks the route culls
    #                      by: 256-row clusters (flat, binned), 128-row leaves
    #                      (bvh) or clusters (resident, a multiple of 8 rows);
    #                      inverted on padding; no rows on the small route
    group: torch.Tensor  # bvh: (max(8, ceil8(n_groups)), 8) group AABBs; else no rows
    sph: torch.Tensor    # (Ps, 8)
    sph_box: torch.Tensor  # past 512 sphere rows: (ceil(Ps / 256), 8) rows
    #                      [min | max | reach | least radius] of the 256-row
    #                      sphere clusters (sphere_cluster_boxes); else no rows
    tri_rows: int        # the scene's triangle rows: the sphere prim-id base
    n_groups: int        # bvh: 16-leaf groups; else 0
    route: str           # "small", "flat", "bvh", "binned" or "resident"


PER_RAY_METHODS = ("bvh", "binned", "resident")   # per-ray mesh traversals


def resolve_route(num_tris: int, num_spheres: int, method: str = "auto") -> str:
    """The route ``resolve_auto`` and ``intersect`` take in the JAX package
    for a scene of ``num_tris`` triangle rows and ``num_spheres`` sphere rows.

    ``method``: ``"auto"`` (the default routes), ``"pallas"`` (no BVH: the
    flat route for every scene past the small bounds), ``"bruteforce"``
    (the route ``"pallas"`` takes: the JAX package's brute force tests every
    row, and every route of the port gives that brute-force answer exactly,
    so the same hits come from the hand-written kernels), or ``"bvh"``,
    ``"binned"``, ``"resident"`` (that traversal for every scene past 64
    triangles; below, as the JAX ``tri_small`` gate, the small route, or the
    flat one beside more than 512 spheres). An unknown method raises
    ``NotImplementedError``."""
    if method not in ("auto", "pallas", "bruteforce") + PER_RAY_METHODS:
        raise NotImplementedError(
            f"method {method!r} has no route in the port (it has auto, pallas, "
            f"bruteforce, {', '.join(PER_RAY_METHODS)})")
    small_tris = num_tris <= SMALL_MAX_TRIS
    if not small_tris and (method in PER_RAY_METHODS
                           or method == "auto" and num_tris >= BVH_MIN_TRIS):
        return "bvh" if method == "auto" else method
    return "small" if small_tris and num_spheres <= SMALL_MAX_SPHERES else "flat"


def _block_boxes(v0, e1, e2, n_blocks: int):
    """``(min, max)``, each ``(n_blocks, 3)``, of the triangles in each run of
    ``LEAF`` rows; rows past the last triangle (padding) contribute inverted
    boxes, so a block of padding has ``min > max`` and is never entered."""
    p1 = v0 + e1
    p2 = v0 + e2
    lo = torch.minimum(torch.minimum(v0, p1), p2)
    hi = torch.maximum(torch.maximum(v0, p1), p2)
    pad = n_blocks * LEAF - v0.shape[0]
    lo = torch.cat([lo, lo.new_full((pad, 3), _INF)])
    hi = torch.cat([hi, hi.new_full((pad, 3), -_INF)])
    return lo.reshape(n_blocks, LEAF, 3).amin(dim=1), hi.reshape(n_blocks, LEAF, 3).amax(dim=1)


def resident_boxes(v0, e1, e2):
    """The resident route's unwidened ``(C8, 8)`` cluster AABB rows,
    ``[min | max | 0 0]``, one per 128-row cluster, padded with inverted
    rows to a multiple of 8 (at least 8): ``resident_intersect._derived_aabbs``
    at ``prim_tile=128``."""
    n = -(-v0.shape[0] // LEAF)
    lo, hi = _block_boxes(v0, e1, e2, max(8, -(-n // 8) * 8))
    return torch.cat([lo, hi, lo.new_zeros((lo.shape[0], 2))], dim=1).contiguous()


def bvh_aabbs(v0, e1, e2):
    """Leaf and group AABB tables, ``[min | max | 0 0]`` rows, of the
    two-level hierarchy over the triangle rows: the JAX package's
    ``_derived_aabbs`` + ``_group_aabbs`` (bvh_intersect.py). A padding leaf
    or group is inverted and never entered."""
    n_leaves = -(-v0.shape[0] // LEAF)
    n_groups = -(-n_leaves // GROUP)
    lmin, lmax = _block_boxes(v0, e1, e2, n_groups * GROUP)
    zeros = lmin.new_zeros((lmin.shape[0], 2))
    leaf = torch.cat([lmin, lmax, zeros], dim=1)
    gmin = lmin.reshape(n_groups, GROUP, 3).amin(dim=1)
    gmax = lmax.reshape(n_groups, GROUP, 3).amax(dim=1)
    g_pad = max(8, -(-n_groups // 8) * 8)
    gmin = torch.cat([gmin, gmin.new_full((g_pad - n_groups, 3), _INF)])
    gmax = torch.cat([gmax, gmax.new_full((g_pad - n_groups, 3), -_INF)])
    group = torch.cat([gmin, gmax, gmin.new_zeros((g_pad, 2))], dim=1)
    return leaf.contiguous(), group.contiguous()


def _widen(lo, hi):
    """``(C, 8)`` AABB rows ``[min | max | 0 0]`` of the boxes ``lo``/``hi``
    ``(C, 3)`` widened outward by ``_BOX_MARGIN``; inverted (empty) boxes
    stay inverted."""
    real = (lo <= hi).all(dim=1, keepdim=True)
    big = torch.where(real, torch.maximum(lo.abs(), hi.abs()), 0.0).amax(dim=1, keepdim=True)
    margin = _BOX_MARGIN * (1.0 + big)
    lo = torch.where(real, lo - margin, lo)
    hi = torch.where(real, hi + margin, hi)
    return torch.cat([lo, hi, lo.new_zeros((lo.shape[0], 2))], dim=1).contiguous()


def sphere_cluster_boxes(scene: Scene):
    """``(C, 8)`` rows ``[min | max | reach | least radius]`` of the 256-row
    sphere clusters: ``Scene.sph_cluster_min/max`` widened by ``_widen``,
    then the largest ``|c| + r`` and the smallest ``r`` over the cluster's
    spheres (``csrc/intersect.cu`` derives each ray's cull margin from them;
    0 and 1 on a cluster without spheres, whose box is inverted)."""
    box = _widen(scene.sph_cluster_min, scene.sph_cluster_max)
    n = box.shape[0] * SPH_CLUSTER_SIZE
    radius = scene.sph_radius
    real = radius > 0.0
    reach = torch.where(real, torch.linalg.vector_norm(scene.sph_center, dim=1) + radius, 0.0)
    least = torch.where(real, radius, _INF)
    reach = torch.cat([reach, reach.new_zeros(n - reach.shape[0])])
    least = torch.cat([least, least.new_full((n - least.shape[0],), _INF)])
    reach = reach.reshape(-1, SPH_CLUSTER_SIZE).amax(dim=1)
    least = least.reshape(-1, SPH_CLUSTER_SIZE).amin(dim=1)
    box[:, 6] = reach
    box[:, 7] = torch.where(least < _INF, least, 1.0)
    return box


def build_tables(scene: Scene, method: str = "auto") -> Tables:
    """Pack ``scene`` for the route :func:`resolve_route` picks. The flat and
    binned routes cull by ``Scene.tri_cluster_min/max`` (256-row clusters),
    the resident route by :func:`resident_boxes`, both widened by
    ``_BOX_MARGIN``; past 512 sphere rows every route gets the sphere
    cluster boxes (:func:`sphere_cluster_boxes`)."""
    t = scene.tri_v0.shape[0]
    s_rows = scene.sph_center.shape[0]
    route = resolve_route(t, s_rows, method)
    dtype = scene.tri_v0.dtype
    tri = torch.cat([scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_normal,
                     scene.tri_mat.to(dtype)[:, None],
                     scene.tri_v0.new_zeros((t, 3))], dim=1)
    no_boxes = tri.new_zeros((0, _BOX_COLS))
    n_groups = 0
    if route == "bvh":
        leaf, group = bvh_aabbs(scene.tri_v0, scene.tri_e1, scene.tri_e2)
        n_groups = leaf.shape[0] // GROUP
        rows = leaf.shape[0] * LEAF
    elif route in ("flat", "binned"):
        leaf, group = _widen(scene.tri_cluster_min, scene.tri_cluster_max), no_boxes
        rows = leaf.shape[0] * CLUSTER_SIZE
    elif route == "resident":
        boxes = resident_boxes(scene.tri_v0, scene.tri_e1, scene.tri_e2)
        leaf, group = _widen(boxes[:, 0:3], boxes[:, 3:6]), no_boxes
        rows = leaf.shape[0] * LEAF
    else:
        leaf, group, rows = no_boxes, no_boxes, t
    tri = torch.cat([tri, tri.new_zeros((rows - t, _TRI_COLS))])

    centers, radius = scene.sph_center, scene.sph_radius
    c2 = centers * centers
    pos = radius > 0.0
    k = torch.where(pos, c2[:, 0] + c2[:, 1] + c2[:, 2] - radius * radius, math.nan)
    inv_r = torch.where(pos, 1.0 / torch.where(pos, radius, 1.0), 0.0)
    sph = torch.cat([centers, k[:, None], inv_r[:, None],
                     scene.sph_mat.to(dtype)[:, None],
                     centers.new_zeros((centers.shape[0], 2))], dim=1)
    sph_box = sphere_cluster_boxes(scene) if s_rows > SMALL_MAX_SPHERES else no_boxes
    return Tables(tri=tri.contiguous(), leaf=leaf, group=group, sph=sph.contiguous(),
                  sph_box=sph_box, tri_rows=t, n_groups=n_groups, route=route)


# ---------------------------------------------------------------------------
# Plain hit tests
# ---------------------------------------------------------------------------

def _tri_ts(tri, o, d, t_min, t_max):
    """Moller-Trumbore of the rows of ``tri`` (v0, e1, e2 in columns 0:9)
    against rays ``(N, 3)``: ``(rows, N)`` hit distances, inf unless in
    ``[t_min, t_max]`` (``(N,)`` or broadcastable). The kernels' op order
    (``shade._tri_hits``, ``csrc/geom.cuh``)."""
    ok, t = _tri_hits(tri, o.T, d.T, t_max, t_min)
    return torch.where(ok, t, _INF)


def _sph_ts(sph, o, d, t_min, t_max):
    """The kernels' sphere test for unit directions (``shade._sphere_ts``,
    ``csrc/geom.cuh`` ``sphere_root``): ``k = |c|^2 - r^2`` per row, the near
    root if it is ``>= t_min`` else the far one; ``(rows, N)``, inf unless in
    ``[t_min, t_max]`` (NaN rows and no-root cases fail every compare)."""
    t_c = _sphere_ts(sph, o.T, d.T, t_min)
    return torch.where((t_c >= t_min) & (t_c <= t_max), t_c, _INF)


def triangle_hit_ts(v0, e1, e2, o, d, t_min, t_max):
    """Moller-Trumbore of every ray against every triangle: ``(N, T)`` hit
    distances, inf on a miss; ``t_min``/``t_max`` broadcast against
    ``(N, T)``."""
    lo, hi = (x.T if torch.is_tensor(x) else x for x in (t_min, t_max))
    return _tri_ts(torch.cat([v0, e1, e2], dim=1), o, d, lo, hi).T


def sphere_hit_ts(center, radius, o, d, t_min, t_max):
    """Half-b quadratic with any direction length, the near root if in range
    else the far one: ``(N, S)`` hit distances, inf on a miss. The JAX
    package's CPU form; the kernels use the ``k = |c|^2 - r^2`` form."""
    oc = o[:, None, :] - center[None, :, :]
    a = vec.dot(d, d)[:, None]
    half_b = vec.dot(oc, d[:, None, :])
    c = vec.dot(oc, oc) - (radius * radius)[None, :]
    disc = half_b * half_b - a * c
    sqrtd = torch.sqrt(torch.clamp_min(disc, 0.0))
    root1 = (-half_b - sqrtd) / a
    root2 = (-half_b + sqrtd) / a
    live = (disc >= 0.0) & (radius > 0.0)[None, :]   # radius 0 marks padding rows
    ok1 = live & (root1 >= t_min) & (root1 <= t_max)
    ok2 = live & (root2 >= t_min) & (root2 <= t_max)
    return torch.where(ok1, root1, torch.where(ok2, root2, _INF))


# ---------------------------------------------------------------------------
# The twins
# ---------------------------------------------------------------------------

def _tri_chunks(tri, rows, o, d, t_min, t_max):
    """``(first row, (chunk, N) hit distances)`` over ``tri[:rows]``."""
    for c in range(0, rows, TWIN_CHUNK):
        yield c, _tri_ts(tri[c:min(c + TWIN_CHUNK, rows)], o, d, t_min, t_max)


def triangle_closest_reference(tables: Tables, o, d, t_min, t_max):
    """Twin of ``triangle_closest``, ``bvh_closest`` and ``resident_closest``
    (and what the binned driver must equal): brute force over
    every triangle row, the first (lowest) row on equal ``t``. Returns ``(t,
    row, outward normal, material)``; a miss is ``(inf, -1, 0, 0)``."""
    best_t = torch.full_like(t_min, _INF)
    best_i = torch.full(t_min.shape, -1, dtype=torch.int64, device=t_min.device)
    for c, ts in _tri_chunks(tables.tri, tables.tri_rows, o, d, t_min, t_max):
        t_c, arg = torch.min(ts, dim=0)      # first minimum, like argmin
        better = t_c < best_t
        best_i = torch.where(better, arg + c, best_i)
        best_t = torch.where(better, t_c, best_t)
    return _tri_record(tables, best_t, best_i)


def _tri_record(tables: Tables, best_t, best_i):
    """``(t, row, outward normal, material)`` of the triangle rows ``best_i``
    at ``best_t`` (a miss where ``best_i`` is -1)."""
    hit = best_i >= 0
    row = tables.tri[best_i.clamp_min(0)]
    normal = torch.where(hit[:, None], row[:, 9:12], 0.0)
    mat = torch.where(hit, row[:, 12].to(torch.int32), 0)
    return best_t, best_i.to(torch.int32), normal, mat


bvh_closest_reference = triangle_closest_reference


def _successor(entries, last_e, last_c):
    """Per row of ``entries`` ``(n, B)`` (inf: not entered), the entered box
    after ``(last_e, last_c)`` in ascending (entry, id) order: ``(entry,
    id)``, entry inf when there is none."""
    ids = torch.arange(entries.shape[1], device=entries.device)
    after = (entries > last_e[:, None]) | ((entries == last_e[:, None])
                                           & (ids[None, :] > last_c[:, None]))
    return torch.min(torch.where(after, entries, _INF), dim=1)   # first of equal: least id


def bvh_traversal_reference(tables: Tables, o, d, t_min, t_max, anyhit: bool = False,
                            chunk: int = 8192):
    """The walk of ``csrc/bvh.cu`` step for step, vectorised over rays in
    chunks of ``chunk``: each ray's entered groups, then each group's
    entered leaves, in ascending (entry, id) order while the entry is ``<=
    min(best_t, t_max)`` (``t_max`` for the any hit); a swept leaf gives its
    least ``(t, row)`` with ``t <= `` that bound, which replaces the best on
    a smaller ``t`` or an equal ``t`` in a lower row; the any hit stops at
    the first leaf with a hit and walks nothing on an empty or NaN range.

    Returns ``(t, row, outward normal, material, groups visited, leaves
    swept)`` (the any hit: ``(occluded, groups visited, leaves swept)``),
    the counts int32 ``(N,)``; the hits equal the brute-force twins'."""
    rows = tables.tri.view(-1, LEAF, _TRI_COLS)
    groups = tables.group[:tables.n_groups]
    parts = [_walk_chunk(tables, rows, groups, o[a:a + chunk], d[a:a + chunk],
                         t_min[a:a + chunk], t_max[a:a + chunk], anyhit)
             for a in range(0, max(t_min.shape[0], 1), chunk)]
    res = tuple(torch.cat(x) for x in zip(*parts))
    if anyhit:
        return res
    best_t, best_i, visited, swept = res
    return (*_tri_record(tables, best_t, best_i), visited, swept)


def _walk_chunk(tables, rows, groups, o, d, t_min, t_max, anyhit):
    """:func:`bvh_traversal_reference` on one chunk of rays. Each pass moves
    every ray one step: a ray between groups finds its next group (or
    stops), a ray inside a group its next leaf (or leaves the group), and
    the rays that found a leaf sweep it. Box entries are the kernels'
    (``binned.cluster_entries`` is ``geom.cuh :: box_entry`` in the same op
    order; on a NaN range it enters nothing, where the kernels' gate then
    visits nothing)."""
    from .binned import cluster_entries

    n, dev = t_min.shape[0], t_min.device
    ge = cluster_entries(o, d, t_min, t_max, groups)                      # (n, G)
    le = cluster_entries(o, d, t_min, t_max, tables.leaf).view(n, -1, GROUP)
    best_t = torch.full((n,), _INF, dtype=o.dtype, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    visited = torch.zeros(n, dtype=torch.int32, device=dev)
    swept = torch.zeros(n, dtype=torch.int32, device=dev)
    g_e = torch.full((n,), -_INF, dtype=o.dtype, device=dev)
    g_c = torch.full((n,), -1, dtype=torch.int64, device=dev)
    l_e, l_c = g_e.clone(), g_c.clone()
    in_group = torch.zeros(n, dtype=torch.bool, device=dev)
    # The any hit walks nothing on an empty or NaN range.
    done = ~(t_max >= t_min) if anyhit else torch.zeros(n, dtype=torch.bool, device=dev)
    while not bool(done.all()):
        bound = t_max if anyhit else torch.minimum(t_max, best_t)   # NaN t_max stays NaN
        need = (~done & ~in_group).nonzero().squeeze(1)
        if need.numel():
            e, c = _successor(ge[need], g_e[need], g_c[need])
            go = (e < _INF) & (e <= bound[need])
            done[need[~go]] = True
            g_e[need], g_c[need] = e, c
            enter = need[go]
            in_group[enter] = True
            l_e[enter], l_c[enter] = -_INF, -1
            visited[enter] += 1
        act = (~done & in_group).nonzero().squeeze(1)
        if not act.numel():
            continue
        e, c = _successor(le[act, g_c[act]], l_e[act], l_c[act])
        go = (e < _INF) & (e <= bound[act])
        in_group[act[~go]] = False
        l_e[act], l_c[act] = e, c
        ray = act[go]
        if not ray.numel():
            continue
        swept[ray] += 1
        leaf = g_c[ray] * GROUP + c[go]
        k = ray.numel()
        tri = rows[leaf].reshape(k * LEAF, _TRI_COLS)
        rep = [x[ray].repeat_interleave(LEAF, dim=0) for x in (o, d, t_min, bound)]
        ok, t = _tri_hits(tri, rep[0].T[:, :, None], rep[1].T[:, :, None], rep[3][:, None],
                          rep[2][:, None])
        ts = torch.where(ok, t, _INF).view(k, LEAF)
        if anyhit:
            hit = (ts < _INF).any(dim=1)
            occ[ray[hit]] = True
            done[ray[hit]] = True
            continue
        lt, arg = torch.min(ts, dim=1)                     # first minimum: the lower row
        lr = leaf * LEAF + arg
        bt, bi = best_t[ray], best_i[ray]
        better = (lt < bt) | ((lt == bt) & (lr < bi) & (lt < _INF))
        best_t[ray] = torch.where(better, lt, bt)
        best_i[ray] = torch.where(better, lr, bi)
    return (occ, visited, swept) if anyhit else (best_t, best_i, visited, swept)


def bvh_span_sums(counts, n: int):
    """Per-ray counts summed over each 256-lane span of the wave padded to
    whole 1024-lane tiles: int32 ``(N_pad / 256,)``, the shape of the JAX
    ``triangle_closest_bvh(counters=True)`` diagnostics."""
    n_pad = -(-n // _COUNTER_TILE) * _COUNTER_TILE
    padded = torch.cat([counts, counts.new_zeros(n_pad - n)])
    return padded.view(-1, _COUNTER_SPAN).sum(dim=1, dtype=torch.int32)


def bvh_anyhit_reference(tables: Tables, o, d, t_min, t_max):
    """Twin of ``bvh_anyhit`` and of ``resident_anyhit``: is any triangle hit
    in ``[t_min, t_max]`` (brute force over every row)."""
    occ = torch.zeros(t_min.shape, dtype=torch.bool, device=t_min.device)
    for _, ts in _tri_chunks(tables.tri, tables.tri_rows, o, d, t_min, t_max):
        occ |= (ts < _INF).any(dim=0)
    return occ


def sphere_cluster_entries(o, d, t_min, t_max, box):
    """Entry of each ray's ``[t_min, t_max]`` into each sphere cluster box
    (``Tables.sph_box`` rows) widened by the ray's root-error pad, in the op
    order of ``csrc/intersect.cu :: sphere_entry``: ``(N, C)``, inf where the
    segment misses the widened box (on a NaN range every box, where the
    kernel's gate then visits nothing)."""
    oo = o[:, 0] * o[:, 0] + o[:, 1] * o[:, 1] + o[:, 2] * o[:, 2]
    dd = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    gain = torch.sqrt(_ROOT_ERR[o.dtype] + 8.0 * torch.abs(dd - 1.0))
    pad = gain[:, None] * (torch.sqrt(oo)[:, None] + box[None, :, 6])
    pad = torch.fmin(pad, pad * pad / (2.0 * box[None, :, 7]))[:, :, None]
    wide = torch.cat([box[None, :, 0:3] - pad, box[None, :, 3:6] + pad], dim=2)
    from .binned import cluster_entries

    return cluster_entries(o, d, t_min, t_max, wide)


def cluster_walk_reference(sph, o, d, t_min, t_max, box, tri=None, tri_box=None,
                           anyhit: bool = False, chunk: int = 8192):
    """The walk of ``csrc/intersect.cu`` step for step, vectorised over rays
    in chunks of ``chunk``: each ray's entered 256-row clusters (``box``:
    ``Tables.sph_box``; ``tri_box``: the flat route's triangle boxes; None
    or no rows: the whole table as one cluster entered at ``t_min``) in
    ascending (entry, id) order while the entry is ``<= min(best_t,
    t_max)`` (``t_max`` for the any hit). Sphere entries are
    :func:`sphere_cluster_entries`, triangle entries the plain slab
    entries. A swept cluster gives its least ``(t, row)`` with ``t <=`` that
    bound, which replaces the best on a smaller ``t`` or an equal ``t`` in a
    lower row. The any hit walks the sphere clusters, then those of ``tri``,
    stops at the first cluster with a hit and walks nothing on an empty or
    NaN range.

    Returns ``(t, row, outward normal, material, clusters visited, rows
    tested)`` (the any hit: ``(occluded, clusters visited, rows tested)``),
    the counts int32 ``(N,)``; rows tested are the rows of the clusters swept
    (the any-hit kernel's vote may stop inside the last one). The hits equal
    the brute-force twins'."""
    phases = [(sph, box, SPH_CLUSTER_SIZE)]
    if anyhit and tri is not None:
        phases.append((tri, tri_box, SPH_CLUSTER_SIZE))
    res = _walk_chunks(phases, o, d, t_min, t_max, anyhit, False, chunk)
    if anyhit:
        return res
    best_t, best_i, visited, tested = res
    return (*_sphere_record(sph, o, d, best_t, best_i), visited, tested)


def resident_walk_reference(tables: Tables, o, d, t_min, t_max, anyhit: bool = False,
                            chunk: int = 8192):
    """The walks of ``csrc/resident.cu`` step for step, vectorised over rays
    in chunks of ``chunk``, on the resident route's 128-row clusters (the
    plain slab entries into ``[t_min, t_max]``). The closest hit visits
    each ray's entered clusters in ascending (entry, id) order while the
    entry is ``<= min(best_t, t_max)``; a swept cluster gives its least
    ``(t, row)`` with ``t <=`` that bound, which replaces the best on a
    smaller ``t`` or an equal ``t`` in a lower row. The any hit sweeps the
    entered clusters in ascending id, stops at the first with a hit and
    walks nothing on an empty or NaN range.

    Returns ``(t, row, outward normal, material, clusters visited, rows
    tested)`` (the any hit: ``(occluded, clusters visited, rows tested)``),
    the counts int32 ``(N,)``; rows tested are the rows of the clusters swept
    (the any-hit kernel's vote may stop inside the last one). The hits equal
    the brute-force twins'."""
    res = _walk_chunks([(tables.tri, tables.leaf, LEAF)], o, d, t_min, t_max, anyhit, anyhit,
                       chunk)
    if anyhit:
        return res
    best_t, best_i, visited, tested = res
    return (*_tri_record(tables, best_t, best_i), visited, tested)


def _walk_chunks(phases, o, d, t_min, t_max, anyhit, id_order, chunk):
    """:func:`_cluster_chunk` over the rays in chunks of ``chunk``, joined."""
    parts = [_cluster_chunk(phases, o[a:a + chunk], d[a:a + chunk], t_min[a:a + chunk],
                            t_max[a:a + chunk], anyhit, id_order)
             for a in range(0, max(t_min.shape[0], 1), chunk)]
    return tuple(torch.cat(x) for x in zip(*parts))


def _cluster_chunk(phases, o, d, t_min, t_max, anyhit, id_order):
    """The cluster walks on one chunk of rays, over ``phases``, ``(rows,
    boxes, cluster size)`` tables walked one after the other (sphere rows
    have 8 columns, triangle rows 16; boxes None or no rows: the whole table
    as one cluster entered at ``t_min``). Each pass moves every ray one
    cluster: it finds its next cluster (or stops), and the rays that found
    one sweep it. ``id_order``: the entered clusters in ascending id, with
    no gate (an entered box's entry lies in ``[t_min, t_max]``)."""
    from .binned import cluster_entries

    n, dev = t_min.shape[0], t_min.device
    best_t = torch.full((n,), _INF, dtype=o.dtype, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    visited = torch.zeros(n, dtype=torch.int32, device=dev)
    tested = torch.zeros(n, dtype=torch.int32, device=dev)
    # The any hit walks nothing on an empty or NaN range.
    done = ~(t_max >= t_min) if anyhit else torch.zeros(n, dtype=torch.bool, device=dev)
    for rows, boxes, size in phases:
        m, cols = rows.shape
        is_sph = cols == _SPH_COLS
        if m == 0:
            continue
        if boxes is not None and boxes.shape[0]:
            entries = (sphere_cluster_entries if is_sph else cluster_entries)(
                o, d, t_min, t_max, boxes)
        else:                                   # one tile, entered at t_min
            size, entries = m, t_min[:, None]
        if id_order:
            ids = torch.arange(entries.shape[1], device=dev, dtype=entries.dtype)
            entries = torch.where(entries < _INF, ids, _INF)
        n_cl = -(-m // size)
        fill = rows.new_full((n_cl * size - m, cols), math.nan if is_sph else 0.0)
        table = torch.cat([rows, fill]).view(n_cl, size, cols)
        last_e = torch.full((n,), -_INF, dtype=o.dtype, device=dev)
        last_c = torch.full((n,), -1, dtype=torch.int64, device=dev)
        live = ~done
        while bool(live.any()):
            act = live.nonzero().squeeze(1)
            bound = t_max if anyhit else torch.minimum(t_max, best_t)   # NaN t_max stays NaN
            e, c = _successor(entries[act], last_e[act], last_c[act])
            go = (e < _INF) & ((e <= bound[act]) | id_order)
            live[act[~go]] = False
            last_e[act], last_c[act] = e, c
            ray, cl = act[go], c[go]
            if not ray.numel():
                continue
            visited[ray] += 1
            tested[ray] += torch.clamp(m - cl * size, max=size).to(torch.int32)
            k = ray.numel()
            blk = table[cl].reshape(k * size, cols)
            ro, rd, lo, hi = (x[ray].repeat_interleave(size, dim=0) for x in (o, d, t_min, bound))
            o3, d3, lo, hi = ro.T[:, :, None], rd.T[:, :, None], lo[:, None], hi[:, None]
            if is_sph:
                t = _sphere_ts(blk, o3, d3, lo)
                ok = (t >= lo) & (t <= hi)
            else:
                ok, t = _tri_hits(blk, o3, d3, hi, lo)
            ts = torch.where(ok, t, _INF).view(k, size)
            if anyhit:
                hit = ray[(ts < _INF).any(dim=1)]
                occ[hit] = True
                done[hit] = True
                live[hit] = False
                continue
            lt, arg = torch.min(ts, dim=1)                     # first minimum: the lower row
            lr = cl * size + arg
            bt, bi = best_t[ray], best_i[ray]
            better = (lt < bt) | ((lt == bt) & (lr < bi) & (lt < _INF))
            best_t[ray] = torch.where(better, lt, bt)
            best_i[ray] = torch.where(better, lr, bi)
    return (occ, visited, tested) if anyhit else (best_t, best_i, visited, tested)


def sphere_closest_reference(sph, o, d, t_min, t_max):
    """Twin of ``sphere_closest``: ``(t, row, outward normal, material)``,
    the first row on equal ``t``; a miss is ``(inf, -1, 0, 0)``. The outward
    normal is ``(o + t d - c) / r`` with the table's ``1/r``."""
    best_t, arg = torch.min(_sph_ts(sph, o, d, t_min, t_max), dim=0)
    return _sphere_record(sph, o, d, best_t, arg)


def _sphere_record(sph, o, d, best_t, arg):
    """``(t, row, outward normal, material)`` of the rows ``arg`` at
    ``best_t`` (a miss where ``best_t`` is inf)."""
    hit = best_t < _INF
    row = sph[arg.clamp_min(0)]
    tt = torch.where(hit, best_t, 0.0)[:, None]
    normal = torch.where(hit[:, None], (o + tt * d - row[:, 0:3]) * row[:, 4:5], 0.0)
    idx = torch.where(hit, arg, -1).to(torch.int32)
    mat = torch.where(hit, row[:, 5].to(torch.int32), 0)
    return best_t, idx, normal, mat


def any_hit_reference(sph, tri, o, d, t_min, t_max):
    """Twin of ``any_hit``: any sphere or triangle hit in ``[t_min, t_max]``;
    ``tri`` may have no rows."""
    occ = (_sph_ts(sph, o, d, t_min, t_max) < _INF).any(dim=0)
    for _, ts in _tri_chunks(tri, tri.shape[0], o, d, t_min, t_max):
        occ |= (ts < _INF).any(dim=0)
    return occ


def combined_closest_small_reference(tables: Tables, o, d, t_min, t_max):
    """Twin of ``combined_closest_small``: the closest triangle in ``[t_min,
    t_max]``, then the closest sphere in ``[t_min, min(t_max, tri_t)]``; the
    sphere wins only when strictly nearer. Returns ``(t, global prim id,
    outward normal, material)``; a miss is ``(inf, -1, 0, 0)``."""
    tri_t, tri_p, tri_n, tri_m = triangle_closest_reference(tables, o, d, t_min, t_max)
    sph_t, sph_p, sph_n, sph_m = sphere_closest_reference(
        tables.sph, o, d, t_min, torch.minimum(t_max, tri_t))
    return _merge(tables, (sph_t, sph_p, sph_n, sph_m), (tri_t, tri_p, tri_n, tri_m))


def _merge(tables: Tables, sph, tri):
    """The closer of a sphere and a triangle hit, the triangle on equal ``t``;
    sphere rows become global prim ids."""
    sph_t, sph_p, sph_n, sph_m = sph
    tri_t, tri_p, tri_n, tri_m = tri
    sph_better = sph_t < tri_t
    return (torch.where(sph_better, sph_t, tri_t),
            torch.where(sph_better, sph_p + tables.tri_rows, tri_p),
            torch.where(sph_better[:, None], sph_n, tri_n),
            torch.where(sph_better, sph_m, tri_m))


# ---------------------------------------------------------------------------
# Dispatching wrappers
# ---------------------------------------------------------------------------

def _check_rays(o, d, t_min, t_max):
    """``(N, device kind)`` of a wave of float32 or float64 rays."""
    n = t_min.shape[0]
    dtype = torch.float64 if o.dtype == torch.float64 else torch.float32
    _check("o", o, dtype, (n, 3))
    _check("d", d, dtype, (n, 3))
    _check("t_min", t_min, dtype, (n,))
    _check("t_max", t_max, dtype, (n,))
    for x in (o, d, t_max):
        if x.device != t_min.device:
            raise ValueError(f"ray inputs on {x.device} and {t_min.device}")
    return n, _device_kind(t_min)


def _check_table(name, tab, cols, device, dtype=torch.float32):
    _check(name, tab, dtype, (tab.shape[0], cols))
    if tab.device != device:
        raise ValueError(f"{name} on {tab.device}, rays on {device}")


def _check_sph_box(sph, box, device):
    """Sphere cluster boxes must cover every row of ``sph`` (or be absent)."""
    _check_table("sph_box", box, _BOX_COLS, device, sph.dtype)
    if box.shape[0] and box.shape[0] * SPH_CLUSTER_SIZE < sph.shape[0]:
        raise ValueError(f"{box.shape[0]} sphere cluster boxes for {sph.shape[0]} sphere rows "
                         "(use build_tables)")


def _check_route(tables: Tables, route: str, device, dtype=torch.float32):
    if tables.route != route:
        raise ValueError(f"tables of the {tables.route} route passed to a {route} kernel")
    _check_table("tables.tri", tables.tri, _TRI_COLS, device, dtype)
    _check_table("tables.sph", tables.sph, _SPH_COLS, device, dtype)
    _check_sph_box(tables.sph, tables.sph_box, device)
    _check_table("tables.leaf", tables.leaf, _BOX_COLS, device, dtype)
    _check_table("tables.group", tables.group, _BOX_COLS, device, dtype)
    if route == "small":   # the kernel stages both tables in shared memory
        ok = (tables.tri.shape[0] == tables.tri_rows <= SMALL_MAX_TRIS
              and tables.sph.shape[0] <= SMALL_MAX_SPHERES)
    elif route in ("flat", "binned"):
        ok = tables.tri.shape[0] == tables.leaf.shape[0] * CLUSTER_SIZE
    elif route == "resident":
        ok = (tables.tri.shape[0] == tables.leaf.shape[0] * LEAF
              and tables.leaf.shape[0] % 8 == 0)
    else:
        ok = (tables.leaf.shape[0] == tables.n_groups * GROUP
              and tables.tri.shape[0] == tables.leaf.shape[0] * LEAF
              and tables.group.shape[0] >= tables.n_groups)
    if not ok:
        raise ValueError(f"{route} tables of inconsistent sizes (use build_tables)")


def _empty(shape, dtype, like):
    return torch.empty(shape, dtype=dtype, device=like.device)


def _closest_out(o):
    """Uninitialised ``(t, row, normal, material)`` outputs of a closest-hit
    launch on the rays ``o`` ``(N, 3)``, floats in their dtype."""
    n = o.shape[0]
    return (_empty((n,), o.dtype, o), _empty((n,), torch.int32, o),
            _empty((n, 3), o.dtype, o), _empty((n,), torch.int32, o))


def bvh_closest(tables: Tables, o, d, t_min, t_max, counters: bool = False):
    """Closest triangle hit through the BVH: ``(t (N,), row (N,) int32,
    outward normal (N, 3), material (N,) int32)``; a miss is
    ``(inf, -1, 0, 0)``. Float32 or float64 rays and tables (the kernel's
    instance for the dtype). Counterpart of ``triangle_closest_bvh``.

    ``counters=True`` appends two int32 ``(N_pad / 256,)`` diagnostics, the
    shape of the JAX ``counters=True`` tuple: the groups visited and the
    leaves swept, per ray, summed over each 256-lane span of the wave padded
    to 1024 lanes (:func:`bvh_span_sums`). The JAX counts are its subtiles'
    rounds and half-gated sweeps; these are the port's per-ray work. The
    hits are those of ``counters=False``. The kernel with counters is
    counted under ``bvh_closest_counters`` (``bvh_closest_counters_f64``)."""
    n, kind = _check_rays(o, d, t_min, t_max)
    _check_route(tables, "bvh", t_min.device, o.dtype)
    if kind == "cpu":
        if not counters:
            return bvh_closest_reference(tables, o, d, t_min, t_max)
        *out, visited, swept = bvh_traversal_reference(tables, o, d, t_min, t_max)
        return (*out, bvh_span_sums(visited, n), bvh_span_sums(swept, n))
    from ..kernels import binding

    out = _closest_out(o)
    if not counters:
        binding.launch_bvh_closest(tables, o, d, t_min, t_max, *out)
        LAUNCHES["bvh_closest" + _SUFFIX[o.dtype]] += 1
        return out
    counts = (_empty((n,), torch.int32, o), _empty((n,), torch.int32, o))
    binding.launch_bvh_closest(tables, o, d, t_min, t_max, *out, counts=counts)
    LAUNCHES["bvh_closest_counters" + _SUFFIX[o.dtype]] += 1
    return (*out, *(bvh_span_sums(c, n) for c in counts))


def bvh_anyhit(tables: Tables, o, d, t_min, t_max):
    """Occlusion by any triangle in ``[t_min, t_max]`` through the BVH:
    bool ``(N,)``. Counterpart of ``triangle_anyhit_bvh``."""
    n, kind = _check_rays(o, d, t_min, t_max)
    _check_route(tables, "bvh", t_min.device, o.dtype)
    if kind == "cpu":
        return bvh_anyhit_reference(tables, o, d, t_min, t_max)
    from ..kernels import binding

    occ = _empty((n,), torch.bool, o)
    binding.launch_bvh_anyhit(tables, o, d, t_min, t_max, occ)
    LAUNCHES["bvh_anyhit" + _SUFFIX[o.dtype]] += 1
    return occ


def sphere_closest(sph, o, d, t_min, t_max, box=None):
    """Closest sphere hit over the rows of ``sph`` (``Tables.sph``): ``(t,
    row, outward normal, material)``. With ``box`` (``Tables.sph_box``, rows
    past 512 spheres) the kernel skips the 256-row clusters a ray's segment
    misses; the answer is the same. Float32 or float64 rays, rows and boxes,
    which launch the kernel's instance for the dtype. Counterpart of
    ``pallas_intersect.sphere_closest``."""
    _, kind = _check_rays(o, d, t_min, t_max)
    _check_table("sph", sph, _SPH_COLS, t_min.device, o.dtype)
    box = sph.new_zeros((0, _BOX_COLS)) if box is None else box
    _check_sph_box(sph, box, t_min.device)
    if kind == "cpu":
        return sphere_closest_reference(sph, o, d, t_min, t_max)
    from ..kernels import binding

    out = _closest_out(o)
    binding.launch_sphere_closest(sph, o, d, t_min, t_max, *out, box=box)
    name = "sphere_closest_clustered" if box.shape[0] else "sphere_closest"
    LAUNCHES[name + _SUFFIX[o.dtype]] += 1
    return out


def combined_closest_small(tables: Tables, o, d, t_min, t_max):
    """Closest hit over the spheres and triangles of a small-route scene in
    one pass: ``(t, global prim id, outward normal, material)``; a miss is
    ``(inf, -1, 0, 0)``. Float32 or float64 rays and tables, which launch the
    kernel's instance for the dtype. Counterpart of
    ``pallas_intersect.combined_closest_small``."""
    _, kind = _check_rays(o, d, t_min, t_max)
    _check_route(tables, "small", t_min.device, o.dtype)
    if kind == "cpu":
        return combined_closest_small_reference(tables, o, d, t_min, t_max)
    from ..kernels import binding

    out = _closest_out(o)
    binding.launch_combined_closest_small(tables, o, d, t_min, t_max, *out)
    LAUNCHES["combined_closest_small" + _SUFFIX[o.dtype]] += 1
    return out


def triangle_closest(tables: Tables, o, d, t_min, t_max):
    """Closest triangle hit over the flat route's 256-row clusters: ``(t,
    row, outward normal, material)``; a miss is ``(inf, -1, 0, 0)``. Float32
    or float64 rays and tables (the kernel's instance for the dtype).
    Counterpart of ``pallas_intersect.triangle_closest``."""
    _, kind = _check_rays(o, d, t_min, t_max)
    _check_route(tables, "flat", t_min.device, o.dtype)
    if kind == "cpu":
        return triangle_closest_reference(tables, o, d, t_min, t_max)
    from ..kernels import binding

    out = _closest_out(o)
    binding.launch_triangle_closest(tables, o, d, t_min, t_max, *out)
    LAUNCHES["triangle_closest" + _SUFFIX[o.dtype]] += 1
    return out


def resident_closest(tables: Tables, o, d, t_min, t_max):
    """Closest triangle hit by per-ray nearest-first traversal of the
    resident route's 128-row clusters: ``(t, row, outward normal,
    material)``; a miss is ``(inf, -1, 0, 0)``. Float32 or float64 rays and
    tables (the kernel's instance for the dtype). Counterpart of
    ``resident_intersect.triangle_closest_resident``."""
    _, kind = _check_rays(o, d, t_min, t_max)
    _check_route(tables, "resident", t_min.device, o.dtype)
    if kind == "cpu":
        return triangle_closest_reference(tables, o, d, t_min, t_max)
    from ..kernels import binding

    out = _closest_out(o)
    binding.launch_resident_closest(tables, o, d, t_min, t_max, *out)
    LAUNCHES["resident_closest" + _SUFFIX[o.dtype]] += 1
    return out


def resident_anyhit(tables: Tables, o, d, t_min, t_max):
    """Occlusion by any triangle in ``[t_min, t_max]`` over the same
    clusters, swept in id order up to the first hit: bool ``(N,)``.
    Counterpart of ``resident_intersect.triangle_anyhit_resident``."""
    n, kind = _check_rays(o, d, t_min, t_max)
    _check_route(tables, "resident", t_min.device, o.dtype)
    if kind == "cpu":
        return bvh_anyhit_reference(tables, o, d, t_min, t_max)
    from ..kernels import binding

    occ = _empty((n,), torch.bool, o)
    binding.launch_resident_anyhit(tables, o, d, t_min, t_max, occ)
    LAUNCHES["resident_anyhit" + _SUFFIX[o.dtype]] += 1
    return occ


def any_hit(sph, tri, o, d, t_min, t_max, sph_box=None, tri_box=None):
    """Occlusion over the spheres of ``sph`` and the triangles of ``tri``
    (``Tables`` row layouts; ``tri`` may have no rows): bool ``(N,)``. With
    ``sph_box`` (``Tables.sph_box``) or ``tri_box`` (the flat route's
    ``Tables.leaf``, 256 rows a box) the kernel skips the clusters a ray's
    segment misses; the answer is the same. Float32 or float64 rays, tables
    and boxes, which launch the kernel's instance for the dtype. Counterpart
    of ``pallas_intersect.any_hit``."""
    n, kind = _check_rays(o, d, t_min, t_max)
    dtype = o.dtype
    _check_table("sph", sph, _SPH_COLS, t_min.device, dtype)
    _check_table("tri", tri, _TRI_COLS, t_min.device, dtype)
    sph_box = sph.new_zeros((0, _BOX_COLS)) if sph_box is None else sph_box
    tri_box = tri.new_zeros((0, _BOX_COLS)) if tri_box is None else tri_box
    _check_sph_box(sph, sph_box, t_min.device)
    _check_table("tri_box", tri_box, _BOX_COLS, t_min.device, dtype)
    if tri_box.shape[0] and tri_box.shape[0] * CLUSTER_SIZE < tri.shape[0]:
        raise ValueError(f"{tri_box.shape[0]} triangle cluster boxes for {tri.shape[0]} rows")
    if kind == "cpu":
        return any_hit_reference(sph, tri, o, d, t_min, t_max)
    from ..kernels import binding

    occ = _empty((n,), torch.bool, o)
    binding.launch_any_hit(sph, tri, o, d, t_min, t_max, occ, sph_box=sph_box, tri_box=tri_box)
    name = "any_hit_clustered" if sph_box.shape[0] or tri_box.shape[0] else "any_hit"
    LAUNCHES[name + _SUFFIX[dtype]] += 1
    return occ


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------

def _ranges(o, t_min, t_max):
    n = o.shape[0]

    def row(t):     # a number comes from the host: a copy, which syncs on the card
        t = (torch.as_tensor(t, dtype=o.dtype, device=o.device) if torch.is_tensor(t)
             else profiler.from_host(o, t))
        return t.expand(n).contiguous()

    return row(t_min), row(t_max)


def intersect(tables: Tables, o, d, t_min, t_max, *, twin: bool = False) -> Hit:
    """Closest hit for a wave of rays ``o``/``d`` ``(N, 3)`` on the route of
    ``tables``; ``t_min``/``t_max`` scalars or ``(N,)``. ``twin=True`` runs
    the plain twins on any device (for checking the kernels; never on the
    render path)."""
    t_lo, t_hi = _ranges(o, t_min, t_max)
    if tables.route == "small":
        fn = combined_closest_small_reference if twin else combined_closest_small
        t, prim, outward, mat = fn(tables, o, d, t_lo, t_hi)
    else:
        from . import binned

        tri_fn = triangle_closest_reference if twin else {
            "flat": triangle_closest, "bvh": bvh_closest,
            "binned": binned.triangle_closest_binned,
            "resident": resident_closest}[tables.route]
        sph = (sphere_closest_reference(tables.sph, o, d, t_lo, t_hi) if twin else
               sphere_closest(tables.sph, o, d, t_lo, t_hi, box=tables.sph_box))
        tri = tri_fn(tables, o, d, t_lo, torch.minimum(t_hi, sph[0]))
        t, prim, outward, mat = _merge(tables, sph, tri)
    valid = prim >= 0
    mat = torch.where(valid, mat, 0)
    point = o + d * torch.where(valid, t, 0.0)[:, None]
    front_face = vec.dot(d, outward) < 0.0
    normal = torch.where(front_face[:, None], outward, -outward)
    return Hit(t=torch.where(valid, t, _INF), prim=prim, point=point, normal=normal,
               front_face=front_face, mat=mat)


def occluded(tables: Tables, o, d, t_min, t_max):
    """Is anything hit in ``[t_min, t_max]`` (shadow rays): bool ``(N,)``.
    ``any_hit`` takes the spheres and every triangle row (on the flat route
    with the triangle cluster boxes); on the bvh, binned and resident routes
    it takes the spheres alone, beside the route's triangle any-hit. The
    sphere cluster boxes go with the spheres wherever the tables have them."""
    t_lo, t_hi = _ranges(o, t_min, t_max)
    if tables.route in ("small", "flat"):
        return any_hit(tables.sph, tables.tri[:tables.tri_rows], o, d, t_lo, t_hi,
                       sph_box=tables.sph_box,
                       tri_box=tables.leaf if tables.route == "flat" else None)
    from . import binned

    tri_fn = {"bvh": bvh_anyhit, "binned": binned.triangle_anyhit_binned,
              "resident": resident_anyhit}[tables.route]
    return (tri_fn(tables, o, d, t_lo, t_hi)
            | any_hit(tables.sph, tables.tri[:0], o, d, t_lo, t_hi, sph_box=tables.sph_box))
