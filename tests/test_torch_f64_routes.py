"""The flat and bvh routes in float64 against the JAX package in float64.

The scenes: ``mesh_scene(4200)`` (the bvh route: 4,182 triangles and 3
spheres), ``mesh_scene(300)`` (the flat route: 282 triangles in 2 clusters)
and ``many_spheres(n_per_side=12)`` (580 spheres: the clustered sphere
kernels beside 2 triangles on the flat route). Every scene is the float32
one widened by ``cast_floats``, as both packages do.

x64 is a process-global switch in JAX, so every JAX float64 reference comes
from ONE subprocess (the module fixture ``jax64``, as in
``tests/test_torch_f64.py``) that writes an ``.npz``; the comparisons run
here, on the port's CPU twins (the wrappers on CPU tensors). The JAX
references:

* ``intersect``/``occluded`` with ``method="bruteforce"``, the JAX CPU
  route, on every scene: they hold the composition of the five twins
  (``sphere_closest`` one tile and clustered, the clustered ``any_hit``,
  ``triangle_closest``, ``bvh_closest``, ``bvh_anyhit``);
* the JAX Pallas kernels in interpret mode where they run under x64:
  ``pallas_intersect.triangle_closest`` (flat) and the clustered
  ``sphere_closest``/``any_hit`` (``method="pallas_interpret"`` on the
  field). The JAX BVH kernels (``triangle_closest_bvh``,
  ``triangle_anyhit_bvh``) stop in interpret mode under x64 on a
  broadcasting error, so the bvh scene is held to the brute force alone;
* ``render_pool(dtype=float64)`` (its CPU default, the composed branch on
  the brute force) on each scene, and the wave engine on ``mesh_scene(300)``.

Tolerances, and why:

* prim ids, materials of hits and occlusion exact;
* a triangle's t within 32 ulps: the twins' Moller-Trumbore has the JAX
  op order, but XLA contracts multiply-adds on the CPU (18 ulps measured on
  the bvh scene, 0 on the flat one) and the JAX flat kernel forms t its own
  way (31 ulps measured); normals of triangle hits are the table's, exact;
* a sphere's t within 1e-12 relative: the port's ``|c|^2 - r^2`` form
  cancels in ``o.o - 2 c.o + k`` near the sphere where the brute force's
  ``o - c`` form does not, and XLA's FMAs move a root by up to ~10^3 ulps
  (``tests/test_torch_f64.py``; 4.1e-13 measured against the brute force,
  5.9e-13 against the JAX clustered kernel); its normal, ``(o + t d - c) /
  r``, within ``2 |dt| / r + 1e-14``;
* whole renders: equal rays and iterations and ``max_rel <= 1e-9``, as
  ``tests/test_torch_f64.py`` holds the small route.

The walk models (``bvh_traversal_reference``, ``cluster_walk_reference``)
are held bitwise against the brute-force twins in float64, and the team
models of ``tests/teamutil.py`` (successor scan, split sweep, vote) against
the models' ``_successor``/first minimum at every team size on float64
entries and hit distances: every team size takes the same steps, so gives
the same counts. The float64 root-error pad of ``csrc/intersect.cu`` is
checked on grazing rays as ``tests/test_torch_clustered.py`` checks the
float32 one.

About 50 s on one worker (the JAX subprocess ~40 s of it).
"""

import importlib
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pathtrace_tpu_torch import cli, pool  # noqa: E402
from pathtrace_tpu_torch.kernels import binding  # noqa: E402
from pathtrace_tpu_torch.models import scenes  # noqa: E402
from pathtrace_tpu_torch.ops import intersect, shade  # noqa: E402
from pathtrace_tpu_torch.ops.binned import cluster_entries  # noqa: E402

from .teamutil import INF, NONE, team_successor, team_sweep, team_vote  # noqa: E402

render = importlib.import_module("pathtrace_tpu_torch.render")   # the module, not the function
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
N = 256
W = H = 8
TEAMS = (1, 2, 4, 8, 16, 32)
POOL = dict(width=W, height=H, spp=1, num_slots=64, seed=3, max_bounces=6)

# name: (the port's builder, camera, eye of the camera rays)
SCENES = {
    "bvh": (lambda: scenes.mesh_scene(4200, device="cpu"), scenes.mesh_scene_camera,
            (0.0, 1.6, 5.5)),
    "flat": (lambda: scenes.mesh_scene(300, device="cpu"), scenes.mesh_scene_camera,
             (0.0, 1.6, 5.5)),
    "field": (lambda: scenes.many_spheres(n_per_side=12, device="cpu"),
              scenes.many_spheres_camera, (13.0, 2.0, 3.0)),
}
ROUTES = {"bvh": "bvh", "flat": "flat", "field": "flat"}

JAX_SCRIPT = r"""
import importlib
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp
from pathtrace_tpu import pool
from pathtrace_tpu.models import scenes
from pathtrace_tpu.ops import intersect, pallas_intersect
render = importlib.import_module("pathtrace_tpu.render")

f64 = jnp.float64
z = dict(np.load(sys.argv[1]))
out = {}
build = {"bvh": lambda: scenes.mesh_scene(4200), "flat": lambda: scenes.mesh_scene(300),
         "field": lambda: scenes.many_spheres(n_per_side=12)}
cams = {"bvh": scenes.mesh_scene_camera, "flat": scenes.mesh_scene_camera,
        "field": scenes.many_spheres_camera}
W = H = 8
for name in build:
    sc = render.cast_floats(build[name](), f64)
    o, d, lo, hi, st = (jnp.asarray(z[f"{name}_{k}"]) for k in ("o", "d", "lo", "hi", "st"))
    h = intersect.intersect(sc, o, d, lo, hi, method="bruteforce")
    for k in ("t", "prim", "normal", "mat"):
        out[f"{name}_{k}"] = getattr(h, k)
    out[f"{name}_occ"] = intersect.occluded(sc, o, d, lo, st, method="bruteforce")
    if name == "flat":
        r = pallas_intersect.triangle_closest(
            o, d, lo, hi, sc.tri_v0, sc.tri_e1, sc.tri_e2, sc.tri_normal, sc.tri_mat,
            sc.tri_cluster_min, sc.tri_cluster_max, interpret=True, ray_tile=256)
        out["flat_kernel_t"], out["flat_kernel_prim"] = r[0], r[1]
    if name == "field":
        h = intersect.intersect(sc, o, d, lo, hi, method="pallas_interpret")
        out["field_kernel_t"], out["field_kernel_prim"] = h.t, h.prim
        out["field_kernel_occ"] = intersect.occluded(sc, o, d, lo, st, method="pallas_interpret")
    img, c, it = pool.render_pool(build[name](), cams[name](W, H), width=W, height=H, spp=1,
                                  num_slots=64, seed=3, max_bounces=6, dtype=f64)
    out.update({f"pool_{name}": img, f"pool_{name}_rays": pool.ray_count(np.asarray(c)),
                f"pool_{name}_iters": int(it)})
wave = render.render(scenes.mesh_scene(300), scenes.mesh_scene_camera(W, H),
                     render.RenderConfig(width=W, height=H, spp=1, max_bounces=6, seed=3,
                                         dtype=f64))
out["wave_flat"] = wave.image_sum
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _rays(sc, eye, n, seed):
    """float64 rays: a third from the camera's eye, a third from points in
    the scene's bounds in random directions, a third from up to ~170 away;
    the aimed ones at points of triangles (meshes) or inside spheres (the
    field). t_min 1e-3; t_max inf, every fifth random; shadow t_max random."""
    g = np.random.default_rng(seed)
    k = n // 3
    if sc.tri_v0.shape[0] > 2:
        v0, e1, e2 = (x.double().numpy() for x in (sc.tri_v0, sc.tri_e1, sc.tri_e2))
        pick = g.integers(0, v0.shape[0], n)
        target = (v0[pick] + g.random((n, 1)) * 0.5 * e1[pick]
                  + g.random((n, 1)) * 0.5 * e2[pick])
        lo, hi = v0.min(0), v0.max(0)
    else:
        c, r = sc.sph_center.double().numpy(), sc.sph_radius.double().numpy()
        pick = g.choice(np.nonzero(r > 0)[0], n)
        target = c[pick] + g.uniform(-0.5, 0.5, (n, 3)) * r[pick, None]
        lo, hi = np.array([-12.0, -0.9, -12.0]), np.array([12.0, 3.0, 12.0])
    o = np.concatenate([np.tile([eye], (k, 1)), g.uniform(lo, hi, (k, 3)),
                        g.uniform(-100.0, 100.0, (n - 2 * k, 3))])
    d = target - o
    d[k:2 * k] = g.normal(size=(k, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, np.inf)
    t_max[::5] = g.uniform(0.1, 5.0, n)[::5]
    return {"o": o, "d": d, "lo": np.full(n, shade.EPS), "hi": t_max,
            "st": g.uniform(0.05, 12.0, n)}


@pytest.fixture(scope="module")
def ports():
    """Each scene widened to float64 and its tables."""
    out = {}
    for name, (build, _, _) in SCENES.items():
        sc = render.cast_floats(build(), F64)
        tables = intersect.build_tables(sc)
        assert tables.route == ROUTES[name] and tables.tri.dtype == F64
        assert all(t.dtype == F64 for t in (tables.sph, tables.leaf, tables.group,
                                           tables.sph_box))
        out[name] = (sc, tables)
    assert out["field"][1].sph_box.shape[0] == 3 and out["bvh"][1].n_groups == 3
    return out


@pytest.fixture(scope="module")
def jax64(tmp_path_factory, ports):
    """The JAX float64 references, from one subprocess (x64 is global)."""
    tmp = tmp_path_factory.mktemp("f64routes")
    z = {}
    for seed, (name, (_, _, eye)) in enumerate(SCENES.items()):
        z.update({f"{name}_{k}": v for k, v in _rays(ports[name][0], eye, N, seed).items()})
    np.savez(tmp / "in.npz", **z)
    subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.npz"), str(tmp / "out.npz")],
                   cwd=REPO, check=True, capture_output=True, text=True, timeout=300,
                   env={**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"})
    return z, dict(np.load(tmp / "out.npz"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ulps(a, b):
    return np.abs(a.view(np.int64) - b.view(np.int64))


def _lanes(z, name):
    return tuple(_t(z[f"{name}_{k}"]) for k in ("o", "d", "lo", "hi", "st"))


def _check_hits(tables, o, t, prim, normal, mat, want_t, want_prim, want_n=None,
                want_mat=None):
    """The tolerances of the module docstring on one set of hit records."""
    np.testing.assert_array_equal(prim, want_prim)
    hit = prim >= 0
    assert hit.mean() > 0.3, hit.mean()
    assert np.isinf(t[~hit]).all() and np.isinf(want_t[~hit]).all()
    tri = hit & (prim < tables.tri_rows)
    sph = hit & (prim >= tables.tri_rows)
    assert tri.any() and sph.any()
    assert _ulps(t[tri], want_t[tri]).max() <= 32
    dt = np.abs(t[sph] - want_t[sph])
    assert (dt <= 1e-12 * want_t[sph]).all(), (dt / want_t[sph]).max()
    if want_mat is not None:
        np.testing.assert_array_equal(mat[hit], want_mat[hit])
    if want_n is not None:
        np.testing.assert_array_equal(normal[tri], want_n[tri])
        r = 1.0 / tables.sph[prim[sph] - tables.tri_rows, 4].numpy()
        dn = np.abs(normal[sph] - want_n[sph]).max(1)
        assert (dn <= 2 * dt / r + 1e-14).all(), (dn * r / np.maximum(dt, 1e-300)).max()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_f64_twins_match_jax_bruteforce(jax64, ports, name):
    """``intersect``/``occluded`` on the route's twins (the five kernels'
    wrappers on CPU tensors) against the JAX brute force in float64."""
    z, want = jax64
    _, tables = ports[name]
    o, d, lo, hi, st = _lanes(z, name)
    shade.LAUNCHES.clear()
    h = intersect.intersect(tables, o, d, lo, hi)
    assert h.t.dtype == h.normal.dtype == h.point.dtype == F64
    _check_hits(tables, o, h.t.numpy(), h.prim.numpy(), h.normal.numpy(), h.mat.numpy(),
                want[f"{name}_t"], want[f"{name}_prim"], want[f"{name}_normal"],
                want[f"{name}_mat"])
    occ = intersect.occluded(tables, o, d, lo, st).numpy()
    np.testing.assert_array_equal(occ, want[f"{name}_occ"])
    assert 0.05 < occ.mean() < 0.95
    assert not shade.LAUNCHES                        # CPU tensors: twins, no launch


@pytest.mark.parametrize("name", ["flat", "field"])
def test_f64_twins_match_jax_kernels(jax64, ports, name):
    """Against the JAX Pallas kernels in interpret mode under x64: the flat
    ``triangle_closest`` (its own rows), the clustered ``sphere_closest``
    and ``any_hit`` of the field (through ``pallas_interpret``)."""
    z, want = jax64
    _, tables = ports[name]
    o, d, lo, hi, st = _lanes(z, name)
    wt, wprim = want[f"{name}_kernel_t"], want[f"{name}_kernel_prim"]
    if name == "flat":
        t, row, _, _ = intersect.triangle_closest(tables, o, d, lo, hi)
        np.testing.assert_array_equal(row.numpy(), wprim)
        hit = wprim >= 0
        assert hit.mean() > 0.3 and t.dtype == F64
        assert _ulps(t.numpy()[hit], wt[hit]).max() <= 32
        return
    h = intersect.intersect(tables, o, d, lo, hi)
    _check_hits(tables, o, h.t.numpy(), h.prim.numpy(), h.normal.numpy(), h.mat.numpy(), wt,
                wprim)
    occ = intersect.any_hit(tables.sph, tables.tri[:tables.tri_rows], o, d, lo, st,
                            sph_box=tables.sph_box, tri_box=tables.leaf)
    np.testing.assert_array_equal(occ.numpy(), want["field_kernel_occ"])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_f64_walk_models_are_the_twins(jax64, ports, name):
    """The walk models in float64 give the brute-force twins' hits, bit for
    bit: ``bvh_traversal_reference`` on the bvh scene (with
    ``bvh_closest(counters=True)``'s span sums), ``cluster_walk_reference``
    on the field's sphere clusters and on the flat any hit's triangle
    boxes."""
    z, _ = jax64
    _, tables = ports[name]
    o, d, lo, hi, st = _lanes(z, name)
    if name == "bvh":
        ref = intersect.bvh_closest_reference(tables, o, d, lo, hi)
        model = intersect.bvh_traversal_reference(tables, o, d, lo, hi)
        for a, b in zip(ref, model[:4]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert int(model[5].sum()) > N
        occ = intersect.bvh_anyhit_reference(tables, o, d, lo, st)
        a_model = intersect.bvh_traversal_reference(tables, o, d, lo, st, anyhit=True)
        assert torch.equal(occ, a_model[0])
        got = intersect.bvh_closest(tables, o, d, lo, hi, counters=True)
        for a, b in zip(got, (*ref, *(intersect.bvh_span_sums(c, N) for c in model[4:]))):
            assert torch.equal(a, b)
        return
    tri = tables.tri[:tables.tri_rows]
    box = tables.sph_box if name == "field" else None
    ref = intersect.sphere_closest_reference(tables.sph, o, d, lo, hi)
    model = intersect.cluster_walk_reference(tables.sph, o, d, lo, hi, box)
    for a, b in zip(ref, model[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    occ = intersect.any_hit_reference(tables.sph, tri, o, d, lo, st)
    a_model = intersect.cluster_walk_reference(tables.sph, o, d, lo, st, box, tri, tables.leaf,
                                               anyhit=True)
    assert torch.equal(occ, a_model[0]) and occ.any()
    if name == "field":
        assert int((ref[1] >= 0).sum()) > N // 4 and int(model[4].max()) >= 2


def _check_successor(entries, k):
    """The team successor scan at k against ``_successor``, step by step
    over every entered box of each of 32 / k rays."""
    last = [(-INF, -1)] * (32 // k)
    steps = 0
    while True:
        got = team_successor([e.tolist() for e in entries], last, k)
        e_ref, c_ref = intersect._successor(entries, torch.tensor([x[0] for x in last], dtype=F64),
                                            torch.tensor([x[1] for x in last]))
        for lane, (e, c) in enumerate(got):
            m = lane // k
            assert (e, c) == ((float(e_ref[m]), int(c_ref[m])) if e_ref[m] < INF
                              else (INF, NONE)), (k, steps, lane)
        if all(x[1] == NONE for x in got):
            return steps
        last = [got[m * k] if got[m * k][1] != NONE else (INF, entries.shape[1])
                for m in range(32 // k)]
        steps += 1


def _check_sweep(ts, base, k, m):
    """The team's split sweep and vote at k over float64 hit distances
    ``ts`` ``(rows, N)`` (inf: no hit) of ``m`` rays, three quarters (at
    least one) with a hit among the rows, the rest with none, against the
    first minimum and any."""
    hit = (ts < INF).any(0)
    rays = torch.cat([torch.nonzero(hit).squeeze(1)[:m - m // 4],
                      torch.nonzero(~hit).squeeze(1)[:m // 4]])
    assert rays.numel() == m
    ts = ts[:, rays]
    ref_t, ref_arg = torch.min(ts, dim=0)
    got = team_sweep([ts[:, m].tolist() for m in range(ts.shape[1])], base, k)
    for lane, (t, row) in enumerate(got):
        m = lane // k
        want = (float(ref_t[m]), base + int(ref_arg[m])) if ref_t[m] < INF else (INF, NONE)
        assert (t, row) == want, (k, lane)
    votes = team_vote([(ts[:, m] < INF).tolist() for m in range(ts.shape[1])], k)
    assert [v[0] for v in votes] == (ts < INF).any(0).tolist()


@pytest.mark.parametrize("k", TEAMS)
def test_f64_team_walks_are_the_models(jax64, ports, k):
    """Every team size takes the models' steps on float64 data, so gives
    their hits and counts: the successor scan over the bvh scene's group
    and first group's leaf entries and the field's sphere cluster entries,
    and the split sweep and vote over a BVH leaf's and a sphere cluster's
    float64 hit distances (rays that hit them, a quarter that do not)."""
    z, _ = jax64
    m = 32 // k
    _, bt = ports["bvh"]
    o, d, lo, hi, _ = _lanes(z, "bvh")
    groups = cluster_entries(o, d, lo, hi, bt.group[:bt.n_groups])
    leaves = cluster_entries(o, d, lo, hi, bt.leaf[:intersect.GROUP])
    assert groups.dtype == F64
    for entries in (groups, leaves):
        rays = torch.nonzero((entries < INF).sum(1) >= 2).squeeze(1)[:m]
        assert rays.numel() == m
        assert _check_successor(entries[rays], k) >= 2
    ts = _busiest(intersect._tri_ts(bt.tri, o, d, shade.EPS, INF), intersect.LEAF)
    _check_sweep(*ts, k, m)

    _, ft = ports["field"]
    o, d, lo, hi, _ = _lanes(z, "field")
    entries = intersect.sphere_cluster_entries(o, d, lo, hi, ft.sph_box)
    rays = torch.nonzero((entries < INF).sum(1) >= 2).squeeze(1)[:m]
    assert rays.numel() == m and _check_successor(entries[rays], k) >= 2
    whole = 2 * intersect.SPH_CLUSTER_SIZE                  # the two full clusters
    ts = _busiest(intersect._sph_ts(ft.sph[:whole], o, d, lo, INF), intersect.SPH_CLUSTER_SIZE)
    assert ts[0].dtype == F64
    _check_sweep(*ts, k, m)


def _busiest(ts, size):
    """The block of ``size`` rows of ``ts`` ``(rows, N)`` that the most rays
    hit: its rows' hit distances and first row."""
    per_block = (ts < INF).view(-1, size, ts.shape[1]).any(1).sum(1)
    b = int(per_block.argmax())
    return ts[b * size:(b + 1) * size], b * size


def test_f64_pad_covers_the_root_error():
    """The float64 cull margin of ``csrc/intersect.cu``: for grazing rays,
    with origins up to ~170 from the origin, radii 0.02 to 30 and directions
    up to 1e-3 off unit length, the point of every root the sphere test
    accepts lies within the pad ``min(s, s^2 / (2 r))``, ``s = sqrt(2^-46 + 8
    |d.d - 1|) (|o| + |c| + r)``, of its sphere. The test runs in float64
    with the kernel's op order (numpy rounds each operation, contracts
    nothing and takes a correctly rounded sqrt, as the card does); the
    distance off the sphere in long double. Then the same rays through the
    clustered walk model (256-row clusters of these spheres, boxes widened
    by the float64 pad and ``_BOX_MARGIN``) against the brute-force twin."""
    g = np.random.default_rng(0)
    n = 400_000
    c = g.uniform(-60, 60, (n, 3))
    r = np.exp(g.uniform(np.log(0.02), np.log(30.0), n))
    o = g.uniform(-100, 100, (n, 3))
    v = g.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    aim = c + v * (r * (1 + g.uniform(-1e-3, 1e-3, n)))[:, None]     # at the silhouette
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d * np.where(g.random(n) < 0.3, 1 + g.uniform(-1e-3, 1e-3, n), 1.0)[:, None]

    def dot(a, b):
        return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]

    k = dot(c, c) - r * r                                   # build_tables' row
    half_b = dot(o, d) - dot(c, d)
    cq = dot(o, o) - 2.0 * dot(c, o) + k
    with np.errstate(invalid="ignore"):
        sq = np.sqrt(half_b * half_b - cq)
    root1 = -half_b - sq
    t = np.where(root1 >= 1e-3, root1, -half_b + sq)
    ok = t >= 1e-3
    assert ok.mean() > 0.3
    ld = np.longdouble
    q = o.astype(ld) + t.astype(ld)[:, None] * d.astype(ld)
    off = np.sqrt(((q - c.astype(ld)) ** 2).sum(1)) - r.astype(ld)
    s = (np.sqrt(ld(2.0**-46) + 8 * np.abs(dot(d.astype(ld), d.astype(ld)) - 1))
         * (np.linalg.norm(o, axis=1) + np.linalg.norm(c, axis=1) + r))
    pad = np.minimum(s, s * s / (2 * r))
    assert (np.abs(off[ok]) <= pad[ok]).all(), (np.abs(off[ok]) / pad[ok]).max()
    assert intersect._ROOT_ERR[F64] == 2.0**-46

    m = 4096                                    # 16 clusters of 256 of these spheres
    center, radius = _t(c[:m]), _t(r[:m])
    lo_b = (center - radius[:, None]).view(-1, 256, 3).amin(dim=1)
    hi_b = (center + radius[:, None]).view(-1, 256, 3).amax(dim=1)
    box = intersect.sphere_cluster_boxes(types.SimpleNamespace(
        sph_cluster_min=lo_b, sph_cluster_max=hi_b, sph_center=center, sph_radius=radius))
    sph = torch.cat([center, _t(k[:m])[:, None], (1.0 / radius)[:, None],
                     torch.zeros((m, 3), dtype=F64)], dim=1).contiguous()
    assert box.dtype == sph.dtype == F64
    ro, rd = _t(o[:m]), _t(d[:m])
    lo, hi = torch.full((m,), 1e-3, dtype=F64), torch.full((m,), INF, dtype=F64)
    want = intersect.sphere_closest_reference(sph, ro, rd, lo, hi)
    got = intersect.cluster_walk_reference(sph, ro, rd, lo, hi, box)
    for a, b in zip(want, got[:4]):
        assert torch.equal(a, b)
    assert (want[1] >= 0).double().mean() > 0.3


def test_f64_host_teams(ports):
    """The teams the host takes for the float64 instances: the float32
    ones, but for ``triangle_closest`` on a full 256-row cluster, 4 threads
    a ray against 8 (``binding.ROWS_PER_THREAD_F64``), and for
    ``bvh_closest``, 8 against 16 (``binding.BVH_TEAM_F64``): their float64
    times at every team on the H100 (``PERF.md`` rows 6f, 7f)."""
    _, bvh = ports["bvh"]
    bvh32 = intersect.build_tables(SCENES["bvh"][0]())
    assert [binding._bvh_team(t, None, k) for t in (bvh, bvh32)
            for k in ("bvh_closest", "bvh_anyhit")] == [8, 32, 16, 32]
    _, flat = ports["flat"]
    _, field = ports["field"]
    flat32 = intersect.build_tables(SCENES["flat"][0]())
    field32 = intersect.build_tables(SCENES["field"][0]())
    assert binding.flat_team(flat) == 4 and binding.flat_team(flat32) == 8
    assert binding.flat_team(field) == binding.flat_team(field32) == 1
    for t64, t32 in ((field, field32), (flat, flat32)):
        for k, tabs in (("sphere_closest", lambda t: [(t.sph, t.sph_box)]),
                        ("any_hit", lambda t: [(t.sph, t.sph_box), (t.tri[:t.tri_rows], t.leaf)])):
            assert binding.cluster_team(k, *tabs(t64)) == binding.cluster_team(k, *tabs(t32))
    assert binding.cluster_team("sphere_closest", (field.sph, field.sph_box)) == 8
    assert binding.cluster_team("any_hit", (field.sph, field.sph_box),
                                (field.tri[:field.tri_rows], field.leaf)) == 32


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_pool_f64_matches_jax(jax64, name):
    """``render_pool(dtype=float64)`` (the composed branch on the route's
    twins) against the JAX float64 pool: equal rays and iterations,
    ``max_rel <= 1e-9``."""
    _, want = jax64
    build, camera, _ = SCENES[name]
    sc = build()
    assert pool.route(sc, "mis") == "composed"
    img, counters, iters = pool.render_pool(sc, camera(W, H, device="cpu"), dtype=F64, **POOL)
    assert img.dtype == F64
    assert pool.ray_count(counters) == int(want[f"pool_{name}_rays"])
    assert iters == int(want[f"pool_{name}_iters"])
    a = want[f"pool_{name}"]
    assert np.max(np.abs(a - img.numpy()) / np.maximum(np.abs(a), 1.0)) <= 1e-9


def test_wave_f64_matches_jax_flat(jax64):
    """The wave engine in float64 on ``mesh_scene(300)`` (the flat route)
    against the JAX wave engine in float64 (which keeps no ray count):
    ``max_rel <= 1e-9``."""
    _, want = jax64
    st = render.render(scenes.mesh_scene(300, device="cpu"),
                       scenes.mesh_scene_camera(W, H, device="cpu"),
                       render.RenderConfig(width=W, height=H, spp=1, max_bounces=6, seed=3,
                                           dtype=F64))
    assert st.image_sum.dtype == F64 and st.ray_queries > W * H
    a = want["wave_flat"]
    assert np.max(np.abs(a - st.image_sum.numpy()) / np.maximum(np.abs(a), 1.0)) <= 1e-9


def test_cli_renders_mesh_f64(tmp_path):
    """``render --scene mesh --dtype f64`` (config 4's 69,938-triangle mesh,
    the bvh route) renders on the CPU twins and writes a float64 image."""
    npy = str(tmp_path / "i.npy")
    assert cli.main(["render", "--scene", "mesh", "--dtype", "f64", "--device", "cpu",
                     "--width", "4", "--height", "4", "--spp", "1", "--max-bounces", "2",
                     "--out", str(tmp_path / "o.png"), "--npy", npy]) == 0
    img = np.load(npy)
    assert img.dtype == np.float64 and img.shape == (4, 4, 3) and np.isfinite(img).all()
    assert img.sum() > 0
