"""Batched ray-scene intersection for the composed path (the BVH route).

Counterpart of ``pathtrace_tpu/ops/intersect.py`` on the route that
``resolve_auto`` picks for scenes with at least 4096 triangles. Four
hand-written CUDA kernels, each with a plain-torch twin here:

* :func:`sphere_closest` (``csrc/intersect.cu``) replaces
  ``pallas_intersect.sphere_closest`` in its one-tile mode: closest sphere
  hit with the winner's outward normal and material;
* :func:`any_hit` (``csrc/intersect.cu``) replaces ``pallas_intersect.any_hit``:
  occlusion over spheres and triangles (the mesh path passes no triangles);
* :func:`bvh_closest` / :func:`bvh_anyhit` (``csrc/bvh.cu``) replace
  ``bvh_intersect.triangle_closest_bvh`` / ``triangle_anyhit_bvh``: the
  two-level hierarchy the JAX package derives from row order (128-row
  leaves under 16-leaf groups), traversed one thread per ray.

The twins are brute force over every row (triangles in chunks of
``TWIN_CHUNK``); a kernel must give the same answer, which is what
``chip_smoke.py`` checks on the card. The wrappers dispatch on the device of
their inputs: CPU tensors run the twin, CUDA tensors launch the kernel (or
raise); there is no fallback. Each launch adds one to ``shade.LAUNCHES``.

:func:`intersect` and :func:`occluded` compose them as the JAX package
does: spheres first, then triangles with ``t_max = min(t_max, sph_t)``;
sphere ids offset by the padded triangle row count; a sphere wins only when
strictly nearer. Epsilons are the reference's: 1e-8 parallel reject,
inclusive barycentric bounds, closed ``[t_min, t_max]``.

Left behind from the JAX route: the ray sort before each trace
(``_ray_sort_key``/``_sort_rays_by_key``/``_unsort``), which changes no
result and keeps TPU subtiles union-coherent (whether it pays on the GPU is
still to measure), and the ``_lift_tree`` varying-axes plumbing. Rays are
``(N, 3)`` float32; ``t_min``/``t_max`` are ``(N,)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.scene import Scene
from ..utils import vec
from .shade import LAUNCHES, _check, _device_kind, _sphere_ts, _tri_hits

_INF = float("inf")

LEAF = 128         # triangles per BVH leaf
GROUP = 16         # leaves per supergroup
TWIN_CHUNK = 2048  # triangle rows per step of the brute-force twins
_TRI_COLS = 16     # v0, e1, e2, normal, material, 3 zeros
_SPH_COLS = 8      # center, |c|^2 - r^2 (NaN on padding), 1/r, material, 2 zeros
_BOX_COLS = 8      # min, max, 2 zeros


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
    """Scene tables packed for the four kernels (built once per render)."""

    tri: torch.Tensor    # (n_groups * GROUP * LEAF, 16); zero rows pad the last group
    leaf: torch.Tensor   # (n_groups * GROUP, 8) leaf AABBs, inverted on padding
    group: torch.Tensor  # (max(8, ceil8(n_groups)), 8) group AABBs, inverted on padding
    sph: torch.Tensor    # (Ps, 8)
    tri_rows: int        # the scene's triangle rows: the sphere prim-id base
    n_groups: int


def bvh_aabbs(v0, e1, e2):
    """Leaf and group AABB tables, ``[min | max | 0 0]`` rows, of the
    two-level hierarchy over the triangle rows: the JAX package's
    ``_derived_aabbs`` + ``_group_aabbs`` (bvh_intersect.py). Rows past the
    last triangle (padding) contribute inverted boxes, so a padding leaf or
    group has ``min > max`` and is never entered."""
    n_leaves = -(-v0.shape[0] // LEAF)
    n_groups = -(-n_leaves // GROUP)
    rows = n_groups * GROUP * LEAF
    p1 = v0 + e1
    p2 = v0 + e2
    lo = torch.minimum(torch.minimum(v0, p1), p2)
    hi = torch.maximum(torch.maximum(v0, p1), p2)
    pad = rows - v0.shape[0]
    lo = torch.cat([lo, lo.new_full((pad, 3), _INF)])
    hi = torch.cat([hi, hi.new_full((pad, 3), -_INF)])
    lmin = lo.reshape(-1, LEAF, 3).amin(dim=1)
    lmax = hi.reshape(-1, LEAF, 3).amax(dim=1)
    zeros = lo.new_zeros((lmin.shape[0], 2))
    leaf = torch.cat([lmin, lmax, zeros], dim=1)
    gmin = lmin.reshape(n_groups, GROUP, 3).amin(dim=1)
    gmax = lmax.reshape(n_groups, GROUP, 3).amax(dim=1)
    g_pad = max(8, -(-n_groups // 8) * 8)
    gmin = torch.cat([gmin, gmin.new_full((g_pad - n_groups, 3), _INF)])
    gmax = torch.cat([gmax, gmax.new_full((g_pad - n_groups, 3), -_INF)])
    group = torch.cat([gmin, gmax, lo.new_zeros((g_pad, 2))], dim=1)
    return leaf.contiguous(), group.contiguous()


def build_tables(scene: Scene) -> Tables:
    leaf, group = bvh_aabbs(scene.tri_v0, scene.tri_e1, scene.tri_e2)
    rows = leaf.shape[0] * LEAF
    t = scene.tri_v0.shape[0]
    tri = torch.cat([scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_normal,
                     scene.tri_mat.to(torch.float32)[:, None],
                     scene.tri_v0.new_zeros((t, 3))], dim=1)
    tri = torch.cat([tri, tri.new_zeros((rows - t, _TRI_COLS))])

    centers, radius = scene.sph_center, scene.sph_radius
    c2 = centers * centers
    pos = radius > 0.0
    k = torch.where(pos, c2[:, 0] + c2[:, 1] + c2[:, 2] - radius * radius, math.nan)
    inv_r = torch.where(pos, 1.0 / torch.where(pos, radius, 1.0), 0.0)
    sph = torch.cat([centers, k[:, None], inv_r[:, None],
                     scene.sph_mat.to(torch.float32)[:, None],
                     centers.new_zeros((centers.shape[0], 2))], dim=1)
    return Tables(tri=tri.contiguous(), leaf=leaf, group=group, sph=sph.contiguous(),
                  tri_rows=t, n_groups=leaf.shape[0] // GROUP)


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


def bvh_closest_reference(tables: Tables, o, d, t_min, t_max):
    """Twin of ``bvh_closest``: brute force over every triangle row, the
    first (lowest) row on equal ``t``. Returns ``(t, row, outward normal,
    material)``; a miss is ``(inf, -1, 0, 0)``."""
    best_t = torch.full_like(t_min, _INF)
    best_i = torch.full(t_min.shape, -1, dtype=torch.int64, device=t_min.device)
    for c, ts in _tri_chunks(tables.tri, tables.tri_rows, o, d, t_min, t_max):
        t_c, arg = torch.min(ts, dim=0)      # first minimum, like argmin
        better = t_c < best_t
        best_i = torch.where(better, arg + c, best_i)
        best_t = torch.where(better, t_c, best_t)
    hit = best_i >= 0
    row = tables.tri[best_i.clamp_min(0)]
    normal = torch.where(hit[:, None], row[:, 9:12], 0.0)
    mat = torch.where(hit, row[:, 12].to(torch.int32), 0)
    return best_t, best_i.to(torch.int32), normal, mat


def bvh_anyhit_reference(tables: Tables, o, d, t_min, t_max):
    """Twin of ``bvh_anyhit``: is any triangle hit in ``[t_min, t_max]``."""
    occ = torch.zeros(t_min.shape, dtype=torch.bool, device=t_min.device)
    for _, ts in _tri_chunks(tables.tri, tables.tri_rows, o, d, t_min, t_max):
        occ |= (ts < _INF).any(dim=0)
    return occ


def sphere_closest_reference(sph, o, d, t_min, t_max):
    """Twin of ``sphere_closest``: ``(t, row, outward normal, material)``,
    the first row on equal ``t``; a miss is ``(inf, -1, 0, 0)``. The outward
    normal is ``(o + t d - c) / r`` with the table's ``1/r``."""
    best_t, arg = torch.min(_sph_ts(sph, o, d, t_min, t_max), dim=0)
    hit = best_t < _INF
    row = sph[arg]
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


# ---------------------------------------------------------------------------
# Dispatching wrappers
# ---------------------------------------------------------------------------

def _check_rays(o, d, t_min, t_max):
    n = t_min.shape[0]
    _check("o", o, torch.float32, (n, 3))
    _check("d", d, torch.float32, (n, 3))
    _check("t_min", t_min, torch.float32, (n,))
    _check("t_max", t_max, torch.float32, (n,))
    for x in (o, d, t_max):
        if x.device != t_min.device:
            raise ValueError(f"ray inputs on {x.device} and {t_min.device}")
    return n, _device_kind(t_min)


def _check_table(name, tab, cols, device):
    _check(name, tab, torch.float32, (tab.shape[0], cols))
    if tab.device != device:
        raise ValueError(f"{name} on {tab.device}, rays on {device}")


def _check_bvh(tables: Tables, device):
    _check_table("tables.tri", tables.tri, _TRI_COLS, device)
    _check_table("tables.leaf", tables.leaf, _BOX_COLS, device)
    _check_table("tables.group", tables.group, _BOX_COLS, device)
    if (tables.leaf.shape[0] != tables.n_groups * GROUP
            or tables.tri.shape[0] != tables.leaf.shape[0] * LEAF
            or tables.group.shape[0] < tables.n_groups):
        raise ValueError("BVH tables of inconsistent sizes (use build_tables)")


def _empty(shape, dtype, like):
    return torch.empty(shape, dtype=dtype, device=like.device)


def bvh_closest(tables: Tables, o, d, t_min, t_max):
    """Closest triangle hit through the BVH: ``(t (N,), row (N,) int32,
    outward normal (N, 3), material (N,) int32)``; a miss is
    ``(inf, -1, 0, 0)``. Counterpart of ``triangle_closest_bvh``."""
    n, kind = _check_rays(o, d, t_min, t_max)
    _check_bvh(tables, t_min.device)
    if kind == "cpu":
        return bvh_closest_reference(tables, o, d, t_min, t_max)
    from ..kernels import binding

    out = (_empty((n,), torch.float32, o), _empty((n,), torch.int32, o),
           _empty((n, 3), torch.float32, o), _empty((n,), torch.int32, o))
    binding.launch_bvh_closest(tables, o, d, t_min, t_max, *out)
    LAUNCHES["bvh_closest"] += 1
    return out


def bvh_anyhit(tables: Tables, o, d, t_min, t_max):
    """Occlusion by any triangle in ``[t_min, t_max]`` through the BVH:
    bool ``(N,)``. Counterpart of ``triangle_anyhit_bvh``."""
    n, kind = _check_rays(o, d, t_min, t_max)
    _check_bvh(tables, t_min.device)
    if kind == "cpu":
        return bvh_anyhit_reference(tables, o, d, t_min, t_max)
    from ..kernels import binding

    occ = _empty((n,), torch.bool, o)
    binding.launch_bvh_anyhit(tables, o, d, t_min, t_max, occ)
    LAUNCHES["bvh_anyhit"] += 1
    return occ


def sphere_closest(sph, o, d, t_min, t_max):
    """Closest sphere hit over every row of ``sph`` (``Tables.sph``):
    ``(t, row, outward normal, material)``. Counterpart of
    ``pallas_intersect.sphere_closest``."""
    n, kind = _check_rays(o, d, t_min, t_max)
    _check_table("sph", sph, _SPH_COLS, t_min.device)
    if kind == "cpu":
        return sphere_closest_reference(sph, o, d, t_min, t_max)
    from ..kernels import binding

    out = (_empty((n,), torch.float32, o), _empty((n,), torch.int32, o),
           _empty((n, 3), torch.float32, o), _empty((n,), torch.int32, o))
    binding.launch_sphere_closest(sph, o, d, t_min, t_max, *out)
    LAUNCHES["sphere_closest"] += 1
    return out


def any_hit(sph, tri, o, d, t_min, t_max):
    """Occlusion over the spheres of ``sph`` and the triangles of ``tri``
    (``Tables`` row layouts; ``tri`` may have no rows): bool ``(N,)``.
    Counterpart of ``pallas_intersect.any_hit``."""
    n, kind = _check_rays(o, d, t_min, t_max)
    _check_table("sph", sph, _SPH_COLS, t_min.device)
    _check_table("tri", tri, _TRI_COLS, t_min.device)
    if kind == "cpu":
        return any_hit_reference(sph, tri, o, d, t_min, t_max)
    from ..kernels import binding

    occ = _empty((n,), torch.bool, o)
    binding.launch_any_hit(sph, tri, o, d, t_min, t_max, occ)
    LAUNCHES["any_hit"] += 1
    return occ


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------

def _ranges(o, t_min, t_max):
    n = o.shape[0]
    return (torch.as_tensor(t_min, dtype=o.dtype, device=o.device).expand(n).contiguous(),
            torch.as_tensor(t_max, dtype=o.dtype, device=o.device).expand(n).contiguous())


def intersect(tables: Tables, o, d, t_min, t_max, *, twin: bool = False) -> Hit:
    """Closest hit for a wave of rays ``o``/``d`` ``(N, 3)``; ``t_min``/
    ``t_max`` scalars or ``(N,)``. ``twin=True`` runs the plain twins on any
    device (for checking the kernels; never on the render path)."""
    t_lo, t_hi = _ranges(o, t_min, t_max)
    sph_fn = sphere_closest_reference if twin else sphere_closest
    tri_fn = bvh_closest_reference if twin else bvh_closest
    sph_t, sph_p, sph_n, sph_m = sph_fn(tables.sph, o, d, t_lo, t_hi)
    tri_t, tri_p, tri_n, tri_m = tri_fn(tables, o, d, t_lo, torch.minimum(t_hi, sph_t))
    sph_p = torch.where(sph_p >= 0, sph_p + tables.tri_rows, -1)

    sph_better = sph_t < tri_t
    t = torch.where(sph_better, sph_t, tri_t)
    prim = torch.where(sph_better, sph_p, tri_p)
    outward = torch.where(sph_better[:, None], sph_n, tri_n)
    mat = torch.where(sph_better, sph_m, tri_m)
    valid = prim >= 0
    mat = torch.where(valid, mat, 0)
    point = o + d * torch.where(valid, t, 0.0)[:, None]
    front_face = vec.dot(d, outward) < 0.0
    normal = torch.where(front_face[:, None], outward, -outward)
    return Hit(t=torch.where(valid, t, _INF), prim=prim, point=point, normal=normal,
               front_face=front_face, mat=mat)


def occluded(tables: Tables, o, d, t_min, t_max):
    """Is anything hit in ``[t_min, t_max]`` (shadow rays): bool ``(N,)``.
    The spheres go through ``any_hit`` with no triangle rows."""
    t_lo, t_hi = _ranges(o, t_min, t_max)
    return (bvh_anyhit(tables, o, d, t_lo, t_hi)
            | any_hit(tables.sph, tables.tri[:0], o, d, t_lo, t_hi))
