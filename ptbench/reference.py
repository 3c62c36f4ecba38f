"""The plain reference: the renderer's estimator written out in plain
PyTorch, for chosen pixels and sample indices.

It reads the scene from the :class:`~ptbench.scene.SceneDescription` and the
camera from the configuration, never from the program: it imports nothing
of ``pathtrace_tpu_torch`` (nor JAX), and builds its own tables. What it
follows is the renderer's published contract (``docs/ARCHITECTURE.md``,
"Determinism contract"):

* every random decision of sample ``s`` of pixel ``p`` at path vertex ``b``
  comes from threefry2x32 (JAX's key derivation and uniform mapping):
  ``key = fold_in(fold_in(key(seed), p), s)``, then the nine uniforms
  ``uniform(fold_in(key, b), (9,))`` in the slots light pick, light u, light
  v, BSDF u, BSDF v, Fresnel coin, Russian roulette, jitter x, jitter y;
* the camera is a pinhole (vertical field of view), jittered by slots 7-8
  of vertex 0, ``u = (x + jx) / (W - 1)`` and the row flipped;
* at each vertex: the closest hit over every triangle (Moller-Trumbore,
  1e-8 parallel reject, closed barycentric bounds) and every sphere, in
  ``[1e-3, inf]``, a sphere winning only when strictly nearer; a light hit
  adds its emission raw at vertex 0 and MIS-weighted after (the
  balance heuristic, the BSDF-side light pdf NOT divided by the light
  count); a path may reach ``max_bounces`` only to collect a light; next
  event estimation toward one uniformly picked light (a triangle by its
  area, a sphere by its cone), evaluated with the eta the ray carries; a
  BSDF sample with the eta of the face; Russian roulette from vertex 4 on
  (survival = throughput luminance capped at 1, decayed from vertex 50); the
  shadow ray over ``[1e-3, dist - 1e-3]`` counts only on survival.

Spheres are tested in the expanded form ``|o|^2 - 2 c.o + (|c|^2 - r^2)``
with a unit direction, the near root unless it lies below ``t_min``.
Primitive tables are the description's float64 values (edges, normals,
areas) rounded to the working dtype once.

Everything runs in ``dtype``: float32 for the check, bfloat16 for its
control (the nearest precision below the configuration's). Radiance sums
over samples are kept in float64.
"""

from __future__ import annotations

import importlib
import math
from typing import NamedTuple

import numpy as np
import torch

from ptbench import refmath as rm
from ptbench.scene import SceneDescription

EPS = 1e-3
RR_MIN_DEPTH = 4
RR_MAX_DEPTH = 50
TRI_CHUNK = 4096      # triangles tested at once
RAY_CHUNK = 16384     # rays intersected at once
PATH_CHUNK = 1 << 18  # paths traced together
_INF = float("inf")

# ---------------------------------------------------------------------------
# threefry2x32 (Salmon et al. 2011), 20 rounds, on int64 tensors of uint32
# ---------------------------------------------------------------------------

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) & _MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def fold_in(k0, k1, data):
    return threefry2x32(k0, k1, torch.zeros_like(data), data & _MASK)


def sample_keys(seed: int, pixels, samples):
    """The key of each (pixel, sample): ``fold_in(fold_in(key(seed), p), s)``,
    ``key(seed)`` being the words ``(0, seed)``."""
    z = torch.zeros_like(pixels)
    return fold_in(*fold_in(z, z + seed, pixels), samples)


def uniforms(k0, k1, vertex: int):
    """The nine float32 uniforms ``(N, 9)`` of path vertex ``vertex``: the
    top 23 bits of the XOR of threefry's two words as a mantissa in [1, 2),
    minus 1."""
    b0, b1 = fold_in(k0, k1, torch.full_like(k0, vertex))
    slot = torch.arange(9, dtype=torch.int64, device=k0.device)[None, :]
    w0, w1 = threefry2x32(b0[:, None], b1[:, None], torch.zeros_like(slot), slot)
    mant = (((w0 ^ w1) >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


# ---------------------------------------------------------------------------
# Scene and camera
# ---------------------------------------------------------------------------

class Lights(NamedTuple):
    is_tri: torch.Tensor    # (L,) bool
    p: torch.Tensor         # (L, 3) vertex 0 or centre
    e1: torch.Tensor        # (L, 3)
    e2: torch.Tensor        # (L, 3)
    n: torch.Tensor         # (L, 3)
    area: torch.Tensor      # (L,)
    radius: torch.Tensor    # (L,)
    emission: torch.Tensor  # (L, 3)


def _morton_order(points: np.ndarray) -> np.ndarray:
    """Stable order of points by their 30-bit morton code in their bounding
    box: the order in which the renderer's scene tables hold spheres, and
    triangles up to 512 (so a light's index among the lights is the same)."""
    if len(points) <= 1:
        return np.arange(len(points))
    lo = points.min(axis=0)
    span = np.maximum(points.max(axis=0) - lo, 1e-12)
    v = np.clip((points - lo) / span * 1023.0, 0, 1023).astype(np.uint32)
    for shift, mask in ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3), (2, 0x09249249)):
        v = (v | (v << shift)) & mask
    return np.argsort((v[:, 0] << 2) | (v[:, 1] << 1) | v[:, 2], kind="stable")


class RefScene:
    """The reference's tables of a scene description, in ``dtype``."""

    def __init__(self, desc: SceneDescription, dtype=torch.float32, device="cpu"):
        a = desc.arrays()
        self.dtype, self.device = dtype, device

        def t(x):
            return torch.tensor(np.asarray(x, np.float64), device=device).to(dtype)

        tri = a["tri"]
        e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
        cr = np.cross(e1, e2)
        norm = np.linalg.norm(cr, axis=1, keepdims=True)
        normal = np.where(norm > 0, cr / np.where(norm > 0, norm, 1.0), 0.0)
        self.tri_v0, self.tri_e1, self.tri_e2 = t(tri[:, 0]), t(e1), t(e2)
        self.tri_n = t(normal)
        self.tri_mat = torch.tensor(a["tri_mat"], device=device)
        self.sph_c, self.sph_r = t(a["sph_center"]), t(a["sph_radius"])
        self.sph_mat = torch.tensor(a["sph_mat"], device=device)
        self.sph_k = rm.dot(self.sph_c, self.sph_c) - self.sph_r * self.sph_r
        self.sph_inv_r = 1.0 / self.sph_r
        self.n_tri = len(tri)

        kinds = sorted({k for k, _ in desc.materials})
        self.kinds = kinds
        self.lanes = {k: importlib.import_module(f"ptbench.materials.{k.lower()}")
                      for k in kinds}
        self.mat_kind = torch.tensor([kinds.index(k) for k, _ in desc.materials],
                                     device=device)
        names = sorted({p for _, ps in desc.materials for p in ps})
        self.mat_param = {}
        for name in names:
            # A kind without the parameter: 0, or for the IOR that of air.
            fill = 1.0 if name == "ior" else 0.0
            rows = [ps.get(name, fill) for _, ps in desc.materials]
            width = max(len(r) if isinstance(r, tuple) else 1 for r in rows)
            full = [list(r) if isinstance(r, tuple) else [r] * width for r in rows]
            col = t(full)
            self.mat_param[name] = col if width > 1 else col[:, 0]
        emissive = self.kinds.index("Emissive") if "Emissive" in kinds else -1
        emi = self.mat_param.get("emission")
        self.is_light_mat = (self.mat_kind == emissive)
        if emi is not None:
            self.is_light_mat &= rm.dot(emi, emi) > 0.0

        # Lights: emissive triangles, then emissive spheres, each class in
        # the order of the renderer's tables; prim ids: triangles, then spheres.
        light_mat = self.is_light_mat.cpu().numpy()
        tri_ids = ([i for i in _tri_order(tri) if light_mat[a["tri_mat"][i]]]
                   if light_mat[a["tri_mat"]].any() else [])
        sph_ids = [i for i in _morton_order(a["sph_center"]) if light_mat[a["sph_mat"][i]]]
        self.light_of_prim = torch.full((self.n_tri + len(a["sph_radius"]),), -1,
                                        dtype=torch.int64, device=device)
        rows = []
        for i in tri_ids:
            self.light_of_prim[i] = len(rows)
            rows.append((True, tri[i, 0], e1[i], e2[i], normal[i], norm[i, 0] * 0.5, 0.0,
                         desc.materials[a["tri_mat"][i]][1]["emission"]))
        for i in sph_ids:
            self.light_of_prim[self.n_tri + i] = len(rows)
            rows.append((False, a["sph_center"][i], np.zeros(3), np.zeros(3), np.zeros(3),
                         0.0, a["sph_radius"][i], desc.materials[a["sph_mat"][i]][1]["emission"]))
        self.num_lights = len(rows)
        if rows:
            cols = list(zip(*rows))
            self.lights = Lights(
                torch.tensor(cols[0], device=device), t(cols[1]), t(cols[2]), t(cols[3]),
                t(cols[4]), t(cols[5]), t(cols[6]), t(cols[7]))

    def materials(self, mat):
        """Per-path kind index and parameters of the material ids ``mat``."""
        return self.mat_kind[mat], {k: v[mat] for k, v in self.mat_param.items()}


def _tri_order(tri: np.ndarray) -> np.ndarray:
    """Triangle order of the renderer's tables, for ordering triangle lights."""
    if len(tri) > 512:
        raise NotImplementedError("triangle lights in a scene of more than 512 triangles: "
                                  "the tables' SAH order is not modelled")
    return _morton_order(tri.mean(axis=1))


class RefCamera:
    """The pinhole ``look_at`` camera in the working dtype."""

    def __init__(self, cam: dict, width: int, height: int, dtype, device):
        def t(x):
            return torch.tensor(x, dtype=torch.float32, device=device).to(dtype)[None, :]

        origin, target, up = t(cam["origin"]), t(cam["target"]), t(cam["up"])
        w = rm.normalize(origin - target)
        u = rm.normalize(rm.cross(up, w))
        v = rm.cross(w, u)
        vh = 2.0 * math.tan(math.radians(cam["fov"]) / 2.0)
        vw = vh * (width / height)
        self.origin, self.hor, self.ver = origin, u * vw, v * vh
        self.llc = origin - self.hor / 2.0 - self.ver / 2.0 - w
        self.width, self.height = width, height

    def rays(self, pixels, jitter):
        dtype = self.origin.dtype
        wm1 = torch.tensor(self.width - 1, dtype=dtype, device=pixels.device)
        hm1 = torch.tensor(self.height - 1, dtype=dtype, device=pixels.device)
        px = (pixels % self.width).to(dtype)
        py = (self.height - 1 - pixels // self.width).to(dtype)
        u = ((px + jitter[:, 0]) / wm1)[:, None]
        v = ((py + jitter[:, 1]) / hm1)[:, None]
        d = rm.normalize(self.llc + self.hor * u + self.ver * v - self.origin)
        return self.origin.expand_as(d), d


# ---------------------------------------------------------------------------
# Intersection: brute force over every primitive
# ---------------------------------------------------------------------------

def _tri_t(sc: RefScene, a: int, b: int, o, d, t_min, t_max):
    """``(rows, N)`` hit distances of triangles ``a:b``, inf on a miss."""
    v0, e1, e2 = (x[a:b, :, None] for x in (sc.tri_v0, sc.tri_e1, sc.tri_e2))
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    hx = dy * e2[:, 2] - dz * e2[:, 1]
    hy = dz * e2[:, 0] - dx * e2[:, 2]
    hz = dx * e2[:, 1] - dy * e2[:, 0]
    det = e1[:, 0] * hx + e1[:, 1] * hy + e1[:, 2] * hz
    f = 1.0 / det
    sx, sy, sz = ox - v0[:, 0], oy - v0[:, 1], oz - v0[:, 2]
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1[:, 2] - sz * e1[:, 1]
    qy = sz * e1[:, 0] - sx * e1[:, 2]
    qz = sx * e1[:, 1] - sy * e1[:, 0]
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz)
    ok = ((torch.abs(det) >= 1e-8) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= t_min) & (t <= t_max))
    return torch.where(ok, t, _INF)


def _sph_t(sc: RefScene, o, d, t_min, t_max):
    """``(spheres, N)`` hit distances, inf on a miss."""
    c = sc.sph_c[:, :, None]
    od, oo = rm.dot(o, d), rm.dot(o, o)
    cd = c[:, 0] * d[:, 0] + c[:, 1] * d[:, 1] + c[:, 2] * d[:, 2]
    co = c[:, 0] * o[:, 0] + c[:, 1] * o[:, 1] + c[:, 2] * o[:, 2]
    half_b = od - cd
    disc = half_b * half_b - (oo - 2.0 * co + sc.sph_k[:, None])
    sq = torch.sqrt(disc)
    near = -half_b - sq
    t = torch.where(near >= t_min, near, -half_b + sq)
    return torch.where((t >= t_min) & (t <= t_max), t, _INF)


class Hit(NamedTuple):
    t: torch.Tensor
    prim: torch.Tensor    # -1 on a miss; spheres after the triangles
    point: torch.Tensor
    normal: torch.Tensor  # facing the ray
    front: torch.Tensor
    mat: torch.Tensor


def closest(sc: RefScene, o, d, t_min: float):
    n = o.shape[0]
    best_t = torch.full((n,), _INF, dtype=o.dtype, device=o.device)
    best = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    for a in range(0, sc.n_tri, TRI_CHUNK):
        t, arg = torch.min(_tri_t(sc, a, min(a + TRI_CHUNK, sc.n_tri), o, d, t_min, _INF), 0)
        better = t < best_t
        best = torch.where(better, arg + a, best)
        best_t = torch.where(better, t, best_t)
    if sc.sph_r.shape[0]:
        t, arg = torch.min(_sph_t(sc, o, d, t_min, _INF), 0)
        better = t < best_t
        best = torch.where(better, arg + sc.n_tri, best)
        best_t = torch.where(better, t, best_t)
    valid = best >= 0
    is_sph = best >= sc.n_tri
    ti = best.clamp(0, max(sc.n_tri - 1, 0))
    si = (best - sc.n_tri).clamp_min(0)
    tt = torch.where(valid, best_t, 0.0)
    point = o + d * tt[:, None]
    outward, mat = torch.zeros_like(o), torch.zeros_like(best)
    if sc.n_tri:
        outward, mat = sc.tri_n[ti], sc.tri_mat[ti]
    if sc.sph_r.shape[0]:
        sph_n = (point - sc.sph_c[si]) * sc.sph_inv_r[si][:, None]
        outward = torch.where(is_sph[:, None], sph_n, outward)
        mat = torch.where(is_sph, sc.sph_mat[si], mat)
    outward = torch.where(valid[:, None], outward, 0.0)
    front = rm.dot(d, outward) < 0.0
    return Hit(best_t, torch.where(valid, best, -1), point,
               torch.where(front[:, None], outward, -outward), front, torch.where(valid, mat, 0))


def occluded(sc: RefScene, o, d, t_min: float, t_max):
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for a in range(0, sc.n_tri, TRI_CHUNK):
        occ |= (_tri_t(sc, a, min(a + TRI_CHUNK, sc.n_tri), o, d, t_min, t_max) < _INF).any(0)
    if sc.sph_r.shape[0]:
        occ |= (_sph_t(sc, o, d, t_min, t_max) < _INF).any(0)
    return occ


def _chunked(fn, n: int, *tensors):
    """``fn`` over slices of RAY_CHUNK rays, concatenated."""
    if n <= RAY_CHUNK:
        return fn(*tensors)
    parts = [fn(*(x[a:a + RAY_CHUNK] if torch.is_tensor(x) and x.dim() else x for x in tensors))
             for a in range(0, n, RAY_CHUNK)]
    if isinstance(parts[0], tuple):
        return type(parts[0])(*(torch.cat(p) for p in zip(*parts)))
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# Lights
# ---------------------------------------------------------------------------

def _cone_pdf(center, radius, frm):
    """1 / the solid angle of a sphere seen from ``frm``, and cos_max."""
    to_c = center - frm
    dist_sq = rm.dot(to_c, to_c)
    sin2 = radius * radius / torch.where(dist_sq > 0, dist_sq, 1.0)
    cos_max = torch.sqrt(torch.clamp_min(1.0 - sin2, 0.0))
    return 1.0 / torch.clamp_min(2.0 * math.pi * (1.0 - cos_max), 1e-12), cos_max, to_c


def _area_pdf(normal, area, frm, point):
    to_l = point - frm
    dist = rm.length(to_l)
    ldir = to_l / torch.where(dist > 0, dist, 1.0)[:, None]
    cos_l = torch.abs(rm.dot(normal, -ldir))
    pdf = torch.where(cos_l > 1e-8,
                      (1.0 / torch.clamp_min(area, 1e-20)) * (dist * dist)
                      / torch.clamp_min(cos_l, 1e-8), 1e-8)
    return pdf, ldir, dist


def light_pdf_toward(sc: RefScene, prim, frm, point):
    """The shape sampler's solid-angle pdf toward a light ``prim`` hit at
    ``point`` from ``frm`` (not divided by the light count)."""
    li = sc.light_of_prim[prim.clamp_min(0)].clamp_min(0)
    L = sc.lights
    tri_pdf, _, _ = _area_pdf(L.n[li], L.area[li], frm, point)
    sph_pdf, _, _ = _cone_pdf(L.p[li], L.radius[li], frm)
    return torch.where(L.is_tri[li], tri_pdf, sph_pdf)


def sample_light(sc: RefScene, frm, u_sel, r1, r2):
    """One uniformly picked light, sampled: ``(dir, dist, pdf / num_lights,
    emission)``."""
    nl = sc.num_lights
    li = torch.clamp_max((u_sel * nl).to(torch.int64), nl - 1)
    L = sc.lights
    p, e1, e2, n, area, radius = L.p[li], L.e1[li], L.e2[li], L.n[li], L.area[li], L.radius[li]
    # Triangle: area sample.
    sr1 = torch.sqrt(r1)
    tri_pt = p + e1 * (1.0 - sr1)[:, None] + e2 * (r2 * sr1)[:, None]
    tri_pdf, tri_dir, tri_dist = _area_pdf(n, area, frm, tri_pt)
    # Sphere: a direction uniform in the cone, re-intersected with the sphere.
    sph_pdf, cos_max, to_c = _cone_pdf(p, radius, frm)
    cos_t = 1.0 - r1 + r1 * cos_max
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * math.pi * r2
    w = rm.normalize(to_c)
    up = torch.where((torch.abs(w[:, 1]) > 0.999)[:, None], rm.axis(w, 0), rm.axis(w, 1))
    uu = rm.normalize(rm.cross(up, w))
    vv = rm.cross(w, uu)
    cone = rm.normalize(uu * (sin_t * torch.cos(phi))[:, None]
                        + vv * (sin_t * torch.sin(phi))[:, None] + w * cos_t[:, None])
    oc = -to_c
    a = rm.dot(cone, cone)
    hb = rm.dot(oc, cone)
    disc = hb * hb - a * (rm.dot(oc, oc) - radius * radius)
    sph_pt = frm + cone * ((-hb - torch.sqrt(torch.clamp_min(disc, 0.0))) / a)[:, None]
    to_l = sph_pt - frm
    sph_dist = rm.length(to_l)
    sph_dir = to_l / torch.where(sph_dist > 0, sph_dist, 1.0)[:, None]

    is_tri = L.is_tri[li]
    pdf = torch.where(is_tri, tri_pdf, sph_pdf) / nl
    return (torch.where(is_tri[:, None], tri_dir, sph_dir),
            torch.where(is_tri, tri_dist, sph_dist), pdf, L.emission[li])


# ---------------------------------------------------------------------------
# Materials
# ---------------------------------------------------------------------------

def _by_kind(sc: RefScene, kind, fn_name: str, n_out: int, args, like):
    """Each material lane on its own paths, the results put back in place."""
    outs = None
    for k, name in enumerate(sc.kinds):
        idx = (kind == k).nonzero()[:, 0]
        if idx.numel() == 0:
            continue
        part = getattr(sc.lanes[name], fn_name)(*(
            {p: v[idx] for p, v in a.items()} if isinstance(a, dict) else a[idx] for a in args))
        if outs is None:
            outs = [torch.zeros((like.shape[0],) + x.shape[1:], dtype=x.dtype, device=x.device)
                    for x in part]
        for o, x in zip(outs, part):
            o[idx] = x
    return outs


# ---------------------------------------------------------------------------
# The estimator
# ---------------------------------------------------------------------------

def trace(sc: RefScene, k0, k1, o, d, *, integrator: str, max_bounces: int):
    """Radiance ``(N, 3)`` of the paths whose keys are ``k0, k1`` and whose
    primary rays are ``o, d``."""
    n = o.shape[0]
    dt, dev = o.dtype, o.device
    use_mis = integrator == "mis"
    use_nee = integrator in ("mis", "nee") and sc.num_lights > 0
    radiance = torch.zeros((n, 3), dtype=dt, device=dev)
    ids = torch.arange(n, device=dev)
    eta = torch.ones(n, dtype=dt, device=dev)
    pdf_prev = torch.ones(n, dtype=dt, device=dev)
    prefix = torch.ones((n, 3), dtype=dt, device=dev)
    rad = torch.zeros((n, 3), dtype=dt, device=dev)
    vertex = 0
    while ids.numel():
        u = uniforms(k0[ids], k1[ids], vertex).to(dt)
        hit = _chunked(lambda a, b: closest(sc, a, b, EPS), o.shape[0], o, d)
        valid = hit.prim >= 0
        kind, m = sc.materials(hit.mat)
        emis = valid & sc.is_light_mat[hit.mat]
        emission = m["emission"] if "emission" in m else torch.zeros_like(o)
        emission = torch.where(emis[:, None], emission, 0.0)
        if integrator == "brdf_only" or vertex == 0:
            gain = emission
        elif use_mis and sc.num_lights:
            w = pdf_prev / (pdf_prev + light_pdf_toward(sc, hit.prim, o, hit.point))
            gain = w[:, None] * emission
        else:
            gain = torch.zeros_like(emission)
        rad = rad + torch.where(emis[:, None], rm.finite(prefix * gain), 0.0)

        # A path may reach max_bounces only to collect a light.
        shade = valid & ~emis & (vertex < max_bounces)
        radiance.index_add_(0, ids[~shade], rad[~shade])
        sh = shade.nonzero()[:, 0]
        if sh.numel() == 0:
            break
        ids, u, o, d, eta, pdf_prev, prefix, rad = (
            x[sh] for x in (ids, u, o, d, eta, pdf_prev, prefix, rad))
        point, normal, front, kind = hit.point[sh], hit.normal[sh], hit.front[sh], kind[sh]
        m = {k: v[sh] for k, v in m.items()}
        i = -d

        if use_nee:
            ldir, ldist, lpdf, lemi = sample_light(sc, point, u[:, 0], u[:, 1], u[:, 2])
            bsdf_l, pdf_l = _by_kind(sc, kind, "eval", 2, (m, i, ldir, normal, eta), i)
            w_nee = lpdf / (lpdf + pdf_l) if use_mis else torch.ones_like(lpdf)
            cos_l = torch.abs(rm.dot(normal, ldir))
            direct = rm.finite(w_nee[:, None] * bsdf_l * lemi * (cos_l / lpdf)[:, None])
            nee = rm.finite(prefix * direct)

        eta_s = torch.where(front, 1.0 / m["ior"], m["ior"]) if "ior" in m else \
            torch.ones_like(eta)
        o_dir, bsdf_s, pdf_s, cos_s = _by_kind(
            sc, kind, "sample", 4, (m, i, normal, eta_s, u[:, 3], u[:, 4], u[:, 5]), i)
        factor = bsdf_s * (cos_s / pdf_s)[:, None]
        lum = torch.clamp_max(rm.luminance(rm.finite(prefix * factor)), 1.0)
        if vertex < RR_MIN_DEPTH:
            rr = torch.ones_like(lum)
        elif vertex >= RR_MAX_DEPTH:
            rr = lum * 2.0 ** -(vertex - RR_MIN_DEPTH)
        else:
            rr = lum
        live = u[:, 6] < rr
        if use_nee:
            lv = live.nonzero()[:, 0]
            blocked = _chunked(lambda a, b, c: occluded(sc, a, b, EPS, c), lv.numel(),
                               point[lv], ldir[lv], ldist[lv] - EPS)
            add = torch.zeros_like(live)
            add[lv] = ~blocked
            rad = rad + torch.where(add[:, None], nee, 0.0)
        radiance.index_add_(0, ids[~live], rad[~live])
        keep = live.nonzero()[:, 0]
        ids, o, d = ids[keep], point[keep], o_dir[keep]
        eta, pdf_prev = eta_s[keep], pdf_s[keep]
        prefix = rm.finite(prefix[keep] * factor[keep] / rr[keep][:, None])
        rad = rad[keep]
        vertex += 1
    return radiance


def render_pixels(desc: SceneDescription, camera: dict, pixels, sample_lo: int,
                  sample_hi: int, *, width: int, height: int, seed: int, integrator: str,
                  max_bounces: int, dtype=torch.float32, device="cpu"):
    """Radiance sums ``(P, 3)`` in float64 of the samples ``[sample_lo,
    sample_hi)`` of each pixel id in ``pixels`` (ids ``y * W + x``, row 0 at
    the top)."""
    sc = RefScene(desc, dtype, device)
    cam = RefCamera(camera, width, height, dtype, device)
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=device)
    ns = sample_hi - sample_lo
    out = torch.zeros((pixels.shape[0], 3), dtype=torch.float64, device=device)
    total = pixels.shape[0] * ns
    for a in range(0, total, PATH_CHUNK):
        job = torch.arange(a, min(a + PATH_CHUNK, total), device=device)
        slot, s = job // ns, job % ns + sample_lo
        k0, k1 = sample_keys(seed, pixels[slot], s)
        jitter = uniforms(k0, k1, 0)[:, 7:9].to(dtype)
        o, d = cam.rays(pixels[slot], jitter)
        rad = trace(sc, k0, k1, o, d, integrator=integrator, max_bounces=max_bounces)
        out.index_add_(0, slot, rad.to(torch.float64))
    return out
