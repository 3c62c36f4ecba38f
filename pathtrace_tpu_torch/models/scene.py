"""Structure-of-arrays scene: a triangle soup, a sphere list, a material table
and the light list, as tensors on one device.

Counterpart of ``pathtrace_tpu/models/scene.py``. The builder runs the same
float64 numpy construction and casts to float32 at the end, so every field
equals the JAX package's bit for bit. Conventions kept from it:

* spheres are morton-ordered; triangles too up to 512 of them, and above
  that they take the SAH split order, whose 128-row runs are the leaves of
  the BVH kernels (``ops/intersect.py``);
* an empty class gets one padding row (a zero-edge triangle, or a sphere at
  1e9 with radius 0) so no table is empty;
* global primitive ids are triangles ``0..T-1`` then spheres ``T..``, where
  ``T`` is the PADDED triangle row count;
* ``light_geom`` packs each light's geometry and emission in one row.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from . import materials as mat

CLUSTER_SIZE = 256       # triangles per cluster AABB
SPH_CLUSTER_SIZE = 256   # spheres per cluster AABB

# Triangle soups above this size take the SAH split order instead of morton.
MAX_MORTON_TRIS = 512
# Split positions land on multiples of this, so every 128-row BVH leaf is one
# subtree of the split.
SPLIT_LEAF = 128


def _morton3(p: np.ndarray) -> np.ndarray:
    """30-bit morton code of points normalized to [0,1)^3."""
    def expand(v):
        v = np.clip((v * 1023.0), 0, 1023).astype(np.uint32)
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (expand(p[:, 0]) << 2) | (expand(p[:, 1]) << 1) | expand(p[:, 2])


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    if centroids.shape[0] <= 1:
        return np.arange(centroids.shape[0])
    lo = centroids.min(axis=0)
    span = np.maximum(centroids.max(axis=0) - lo, 1e-12)
    return np.argsort(_morton3((centroids - lo) / span), kind="stable")


def _split_order(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Top-down SAH split order for triangles (the JAX package's
    ``_split_order`` with ``sah=True``): each node sorts its triangles along
    its longest centroid axis and splits at the SPLIT_LEAF-aligned position of
    least surface-area cost."""
    n = len(p0)
    if n <= 1:
        return np.arange(n)
    cent = (p0 + p1 + p2) / 3.0
    tmn = np.minimum(np.minimum(p0, p1), p2)
    tmx = np.maximum(np.maximum(p0, p1), p2)
    out = []

    def area(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

    def rec(idx):
        if len(idx) <= SPLIT_LEAF:
            out.append(idx)
            return
        c = cent[idx]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        sidx = idx[np.argsort(c[:, ax], kind="stable")]
        mn, mx = tmn[sidx], tmx[sidx]
        pre_mn = np.minimum.accumulate(mn)
        pre_mx = np.maximum.accumulate(mx)
        suf_mn = np.minimum.accumulate(mn[::-1])[::-1]
        suf_mx = np.maximum.accumulate(mx[::-1])[::-1]
        ks = np.arange(SPLIT_LEAF, len(idx), SPLIT_LEAF)
        cost = area(pre_mn[ks - 1], pre_mx[ks - 1]) * ks + \
            area(suf_mn[ks], suf_mx[ks]) * (len(idx) - ks)
        k = int(ks[np.argmin(cost)])
        rec(sidx[:k])
        rec(sidx[k:])

    rec(np.arange(n))
    return np.concatenate(out)


def _cluster_aabbs(pmin: np.ndarray, pmax: np.ndarray, rows: int, cluster: int):
    """Per-cluster AABBs for ``rows`` padded rows; empty clusters inverted."""
    n_clusters = max(rows // cluster, 1)
    cmin = np.full((n_clusters, 3), np.inf)
    cmax = np.full((n_clusters, 3), -np.inf)
    for c in range(n_clusters):
        a, b = c * cluster, min((c + 1) * cluster, pmin.shape[0])
        if a < pmin.shape[0]:
            cmin[c] = pmin[a:b].min(axis=0)
            cmax[c] = pmax[a:b].max(axis=0)
    return cmin, cmax


@dataclasses.dataclass(frozen=True)
class Scene:
    tri_v0: torch.Tensor      # (T, 3) float32
    tri_e1: torch.Tensor      # (T, 3)
    tri_e2: torch.Tensor      # (T, 3)
    tri_normal: torch.Tensor  # (T, 3) unit geometric normal
    tri_area: torch.Tensor    # (T,)
    tri_mat: torch.Tensor     # (T,) int32

    sph_center: torch.Tensor  # (S, 3)
    sph_radius: torch.Tensor  # (S,)
    sph_mat: torch.Tensor     # (S,) int32

    mat_kind: torch.Tensor       # (M,) int32 (materials.KIND_*)
    mat_color: torch.Tensor      # (M, 3)
    mat_emission: torch.Tensor   # (M, 3)
    mat_roughness: torch.Tensor  # (M,)
    mat_metallic: torch.Tensor   # (M,)
    mat_ior: torch.Tensor        # (M,)

    tri_cluster_min: torch.Tensor  # (Ct, 3)
    tri_cluster_max: torch.Tensor  # (Ct, 3)
    sph_cluster_min: torch.Tensor  # (Cs, 3)
    sph_cluster_max: torch.Tensor  # (Cs, 3)

    light_prims: torch.Tensor  # (L,) int32 global prim ids
    # Columns: 0 is_tri | 1:4 v0/center | 4 radius (sphere) | 4:7 e1 (tri)
    #          7:10 e2 | 10:13 normal | 13 area | 14:17 emission
    light_geom: torch.Tensor   # (L, 17)

    num_tris: int
    num_spheres: int
    num_lights: int
    has_pbr: bool = False
    has_oren_nayar: bool = True
    has_mirror: bool = True
    has_tri_lights: bool = True
    has_sph_lights: bool = True

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device


class SceneBuilder:
    """Scene-construction API producing the SoA :class:`Scene` on ``device``
    (the GPU unless ``"cpu"`` is asked for; :meth:`build` raises where
    there is no GPU)."""

    def __init__(self, device="cuda"):
        self.device = device
        self._tris: List[Tuple[np.ndarray, np.ndarray, np.ndarray, int]] = []
        self._sphs: List[Tuple[np.ndarray, float, int]] = []
        self._mats: List[mat.Material] = []

    def _mat_id(self, m: mat.Material) -> int:
        try:
            return self._mats.index(m)
        except ValueError:
            self._mats.append(m)
            return len(self._mats) - 1

    def add_triangle(self, v0, v1, v2, material: mat.Material) -> "SceneBuilder":
        mid = self._mat_id(material)
        self._tris.append(
            (np.asarray(v0, np.float64), np.asarray(v1, np.float64),
             np.asarray(v2, np.float64), mid)
        )
        return self

    def add_quad(self, v0, v1, v2, v3, material: mat.Material) -> "SceneBuilder":
        """Two triangles (v0,v1,v2) and (v0,v2,v3)."""
        self.add_triangle(v0, v1, v2, material)
        self.add_triangle(v0, v2, v3, material)
        return self

    def add_sphere(self, center, radius: float, material: mat.Material) -> "SceneBuilder":
        mid = self._mat_id(material)
        self._sphs.append((np.asarray(center, np.float64), float(radius), mid))
        return self

    def add_mesh(self, vertices, faces, material: mat.Material) -> "SceneBuilder":
        """Triangle mesh: ``vertices (V,3)`` float, ``faces (F,3)`` int."""
        vertices = np.asarray(vertices, np.float64)
        faces = np.asarray(faces, np.int64)
        mid = self._mat_id(material)
        for f in faces:
            self._tris.append((vertices[f[0]], vertices[f[1]], vertices[f[2]], mid))
        return self

    def build(self) -> Scene:
        num_tris = len(self._tris)
        num_sphs = len(self._sphs)
        tris = list(self._tris)
        sphs = list(self._sphs)
        mats = list(self._mats) or [mat.Lambertian((0.0, 0.0, 0.0))]

        if num_tris > MAX_MORTON_TRIS:
            p0, p1, p2 = (np.stack([t[k] for t in tris]) for k in range(3))
            tris = [tris[i] for i in _split_order(p0, p1, p2)]
        elif num_tris > 1:
            cent = np.stack([(t[0] + t[1] + t[2]) / 3.0 for t in tris])
            tris = [tris[i] for i in _morton_order(cent)]
        if num_sphs > 1:
            cent = np.stack([s[0] for s in sphs])
            sphs = [sphs[i] for i in _morton_order(cent)]

        t_pad = max(num_tris, 1)
        s_pad = max(num_sphs, 1)

        tri_v0 = np.zeros((t_pad, 3)); tri_e1 = np.zeros((t_pad, 3)); tri_e2 = np.zeros((t_pad, 3))
        tri_mat_arr = np.zeros((t_pad,), np.int32)
        for i, (v0, v1, v2, mid) in enumerate(tris):
            tri_v0[i] = v0; tri_e1[i] = v1 - v0; tri_e2[i] = v2 - v0
            tri_mat_arr[i] = mid
        tri_cross = np.cross(tri_e1, tri_e2)
        tri_norm = np.linalg.norm(tri_cross, axis=-1, keepdims=True)
        tri_normal = np.where(tri_norm > 0, tri_cross / np.where(tri_norm > 0, tri_norm, 1.0), 0.0)
        tri_area = tri_norm[:, 0] * 0.5

        sph_center = np.full((s_pad, 3), 1e9); sph_radius = np.zeros((s_pad,))
        sph_mat_arr = np.zeros((s_pad,), np.int32)
        for i, (c, r, mid) in enumerate(sphs):
            sph_center[i] = c; sph_radius[i] = r
            sph_mat_arr[i] = mid

        tri_pts = np.stack([tri_v0, tri_v0 + tri_e1, tri_v0 + tri_e2])
        tri_cmin, tri_cmax = _cluster_aabbs(
            tri_pts.min(axis=0)[:num_tris],
            tri_pts.max(axis=0)[:num_tris],
            -(-t_pad // CLUSTER_SIZE) * CLUSTER_SIZE,
            CLUSTER_SIZE,
        )
        sph_cmin, sph_cmax = _cluster_aabbs(
            (sph_center - sph_radius[:, None])[:num_sphs],
            (sph_center + sph_radius[:, None])[:num_sphs],
            -(-s_pad // SPH_CLUSTER_SIZE) * SPH_CLUSTER_SIZE,
            SPH_CLUSTER_SIZE,
        )

        rows = [mat.material_row(m) for m in mats]
        mat_kind = np.asarray([r[0] for r in rows], np.int32)
        mat_color = np.asarray([r[1] for r in rows])
        mat_emission = np.asarray([r[2] for r in rows])
        mat_roughness = np.asarray([r[3] for r in rows])
        mat_metallic = np.asarray([r[4] for r in rows])
        mat_ior = np.asarray([r[5] for r in rows])

        # Lights: emissive primitives, with sphere ids offset by the PADDED
        # triangle row count (the prim-id namespace of every hit).
        light_ids: List[int] = []
        for i, (_, _, _, mid) in enumerate(tris):
            if mat.is_emissive(mats[mid]):
                light_ids.append(i)
        for i, (_, _, mid) in enumerate(sphs):
            if mat.is_emissive(mats[mid]):
                light_ids.append(t_pad + i)
        num_lights = len(light_ids)
        light_prims = np.asarray(light_ids or [0], np.int32)

        light_geom = np.zeros((max(num_lights, 1), 17))
        for li, pid in enumerate(light_ids):
            if pid < t_pad:
                mid = int(tri_mat_arr[pid])
                light_geom[li, 0] = 1.0
                light_geom[li, 1:4] = tri_v0[pid]
                light_geom[li, 4:7] = tri_e1[pid]
                light_geom[li, 7:10] = tri_e2[pid]
                light_geom[li, 10:13] = tri_normal[pid]
                light_geom[li, 13] = tri_area[pid]
            else:
                si = pid - t_pad
                mid = int(sph_mat_arr[si])
                light_geom[li, 1:4] = sph_center[si]
                light_geom[li, 4] = sph_radius[si]
            light_geom[li, 14:17] = mat_emission[mid]

        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=self.device)

        def i32(a):
            return torch.tensor(np.asarray(a, np.int32), device=self.device)

        return Scene(
            tri_v0=f32(tri_v0), tri_e1=f32(tri_e1), tri_e2=f32(tri_e2),
            tri_normal=f32(tri_normal), tri_area=f32(tri_area),
            tri_mat=i32(tri_mat_arr),
            sph_center=f32(sph_center), sph_radius=f32(sph_radius),
            sph_mat=i32(sph_mat_arr),
            mat_kind=i32(mat_kind), mat_color=f32(mat_color),
            mat_emission=f32(mat_emission), mat_roughness=f32(mat_roughness),
            mat_metallic=f32(mat_metallic), mat_ior=f32(mat_ior),
            tri_cluster_min=f32(tri_cmin), tri_cluster_max=f32(tri_cmax),
            sph_cluster_min=f32(sph_cmin), sph_cluster_max=f32(sph_cmax),
            light_prims=i32(light_prims), light_geom=f32(light_geom),
            num_tris=num_tris, num_spheres=num_sphs, num_lights=num_lights,
            has_pbr=any(isinstance(m, mat.PBRMaterial) for m in mats),
            has_oren_nayar=any(
                isinstance(m, (mat.OrenNayar, mat.PBRMaterial)) for m in mats
            ),
            has_mirror=any(isinstance(m, mat.Mirror) for m in mats),
            has_tri_lights=any(pid < t_pad for pid in light_ids),
            has_sph_lights=any(pid >= t_pad for pid in light_ids),
        )
