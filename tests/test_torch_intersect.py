"""The port's intersection module (the BVH route of the mesh path) against
the JAX package's on the CPU.

The JAX side runs its CPU default, ``method="bruteforce"`` (with a Pallas
override ``resolve_auto`` would pick the flat route, not the BVH one). The
port's wrappers run their kernels' plain twins on CPU tensors. Rays are made
with numpy from a seed: camera rays of the mesh scene, rays from points in
the scene in every direction, and shadow segments toward random points.

Tolerances, and why: the twins test spheres in the kernels' ``|c|^2 - r^2``
form for unit directions, the JAX CPU route in the ``o - c`` form divided by
``d.d``, and XLA contracts multiply-adds, so a hit at a silhouette or a
triangle edge may go either way. Prim ids (and so materials) agree on
>= 99.9% of rays (measured: all 2048), occlusion on >= 99.9% (measured: all);
where the prim agrees, ``t`` and the point agree to rtol 1e-4 / atol 2e-5
and the normal to atol 1e-4 (measured worst: 2.1e-5 relative in ``t`` on
triangles; 5.1e-6 absolute on a sphere hit at t = 0.037, where the
``|o|^2 - 2 o.c + k`` sum cancels; 2.7e-5 in the normal). The BVH tables
are bitwise equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.models import scenes as jax_scenes  # noqa: E402
from pathtrace_tpu.ops import bvh_intersect as jax_bvh  # noqa: E402
from pathtrace_tpu.ops import intersect as jax_isect  # noqa: E402
from pathtrace_tpu.ops.resident_intersect import _derived_aabbs  # noqa: E402
from pathtrace_tpu_torch.convert import scene_from_arrays, split_fields  # noqa: E402
from pathtrace_tpu_torch.ops import intersect, shade  # noqa: E402

N = 2048
AGREE = 0.999
INF = float("inf")


@pytest.fixture(scope="module")
def mesh():
    jsc = jax_scenes.mesh_scene(4200)
    tsc = scene_from_arrays(*split_fields(jsc), device="cpu")
    return jsc, tsc, intersect.build_tables(tsc)


def _rays(seed):
    """Half camera rays through the knot's box, half from random points in
    random directions; unit directions."""
    g = np.random.default_rng(seed)
    o = np.concatenate([np.tile([[0.0, 1.6, 5.5]], (N // 2, 1)),
                        g.uniform(-3.0, 3.0, (N // 2, 3))]).astype(np.float32)
    target = g.uniform([-2.0, -1.2, -2.0], [2.0, 1.5, 2.0], (N, 3))
    d = target - o
    d[N // 2:] = g.normal(size=(N // 2, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = g.uniform(0.2, 8.0, N).astype(np.float32)
    return o, d, t_max


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_bvh_tables_equal_jax(mesh):
    jsc, _, tables = mesh
    v0 = jsc.tri_v0
    leaves = -(-v0.shape[0] // 128)
    t_rows = -(-leaves // 16) * 16 * 128          # whole groups of 16 leaves
    leaf, _ = _derived_aabbs(v0, jsc.tri_e1, jsc.tri_e2, t_rows, 128, jnp.float32)
    leaf, group, n_groups, _ = jax_bvh._group_aabbs(leaf, t_rows // 128, 16, jnp.float32)
    np.testing.assert_array_equal(tables.leaf.numpy(), np.asarray(leaf))
    np.testing.assert_array_equal(tables.group.numpy(), np.asarray(group))
    assert tables.n_groups == n_groups and tables.tri.shape == (t_rows, 16)
    assert not tables.tri[tables.tri_rows:].any()          # zero padding rows
    np.testing.assert_array_equal(tables.tri[:tables.tri_rows, 0:3].numpy(), np.asarray(v0))


def test_plain_hit_tests_match_jax(mesh):
    jsc, tsc, _ = mesh
    o, d, t_max = _rays(0)
    o, d, t_max = o[:256], d[:256], t_max[:256, None]
    tri = slice(0, 512)
    want = jax_isect.triangle_hit_ts(jsc.tri_v0[tri], jsc.tri_e1[tri], jsc.tri_e2[tri],
                                     jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(t_max))
    got = intersect.triangle_hit_ts(tsc.tri_v0[tri], tsc.tri_e1[tri], tsc.tri_e2[tri],
                                    _t(o), _t(d), 1e-3, _t(t_max))
    np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(np.asarray(want)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    want = jax_isect.sphere_hit_ts(jsc.sph_center, jsc.sph_radius, jnp.asarray(o),
                                   jnp.asarray(d), 1e-3, jnp.asarray(t_max))
    got = intersect.sphere_hit_ts(tsc.sph_center, tsc.sph_radius, _t(o), _t(d), 1e-3,
                                  _t(t_max))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_intersect_matches_jax(mesh, seed):
    jsc, tsc, tables = mesh
    o, d, _ = _rays(seed)
    want = jax_isect.intersect(jsc, jnp.asarray(o), jnp.asarray(d), shade.EPS, jnp.inf,
                               method="bruteforce")
    before = dict(shade.LAUNCHES)
    got = intersect.intersect(tables, _t(o), _t(d), shade.EPS, INF)
    assert dict(shade.LAUNCHES) == before        # CPU tensors: twins, no launch
    prim, wprim = got.prim.numpy(), np.asarray(want.prim)
    same = prim == wprim
    assert same.mean() >= AGREE, same.mean()
    hit = same & (prim >= 0)
    assert hit.mean() > 0.6 and (prim >= tables.tri_rows).any()   # knot, ground, spheres
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got.point.numpy()[hit], np.asarray(want.point)[hit],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.normal.numpy()[hit], np.asarray(want.normal)[hit],
                               atol=1e-4)
    np.testing.assert_array_equal(got.mat.numpy()[hit], np.asarray(want.mat)[hit])
    np.testing.assert_array_equal(got.front_face.numpy()[hit],
                                  np.asarray(want.front_face)[hit])
    assert np.isinf(got.t.numpy()[prim < 0]).all()


def test_twins_match_jax_per_class(mesh):
    """Each twin alone: sphere_closest against the JAX spheres-only sweep,
    bvh_closest against its triangles-only sweep."""
    jsc, tsc, tables = mesh
    o, d, _ = _rays(2)
    lo, hi = torch.full((N,), shade.EPS), torch.full((N,), INF)
    ts = np.asarray(jax_isect.sphere_hit_ts(jsc.sph_center, jsc.sph_radius, jnp.asarray(o),
                                            jnp.asarray(d), shade.EPS, jnp.inf))
    t, idx, nrm, mat = intersect.sphere_closest_reference(tables.sph, _t(o), _t(d), lo, hi)
    want_idx = np.where(np.isfinite(ts.min(1)), ts.argmin(1), -1)
    assert (idx.numpy() == want_idx).mean() >= AGREE
    ok = (idx.numpy() == want_idx) & (want_idx >= 0)
    np.testing.assert_allclose(t.numpy()[ok], ts.min(1)[ok], rtol=1e-4, atol=2e-5)
    np.testing.assert_array_equal(mat.numpy()[ok], np.asarray(jsc.sph_mat)[want_idx[ok]])

    tt = np.asarray(jax_isect.triangle_hit_ts(jsc.tri_v0, jsc.tri_e1, jsc.tri_e2,
                                              jnp.asarray(o), jnp.asarray(d), shade.EPS,
                                              jnp.inf))
    t, idx, nrm, mat = intersect.bvh_closest_reference(tables, _t(o), _t(d), lo, hi)
    want_idx = np.where(np.isfinite(tt.min(1)), tt.argmin(1), -1)
    assert (idx.numpy() == want_idx).mean() >= AGREE
    ok = (idx.numpy() == want_idx) & (want_idx >= 0)
    assert ok.mean() > 0.5
    np.testing.assert_allclose(t.numpy()[ok], tt.min(1)[ok], rtol=1e-4)
    np.testing.assert_array_equal(nrm.numpy()[ok], np.asarray(jsc.tri_normal)[want_idx[ok]])
    np.testing.assert_array_equal(mat.numpy()[ok], np.asarray(jsc.tri_mat)[want_idx[ok]])
    assert (nrm.numpy()[idx.numpy() < 0] == 0).all() and (mat.numpy()[idx.numpy() < 0] == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_occluded_matches_jax(mesh, seed):
    jsc, _, tables = mesh
    o, d, t_max = _rays(seed)
    want = np.asarray(jax_isect.occluded(jsc, jnp.asarray(o), jnp.asarray(d), shade.EPS,
                                         jnp.asarray(t_max), method="bruteforce"))
    got = intersect.occluded(tables, _t(o), _t(d), shade.EPS, _t(t_max)).numpy()
    assert (got == want).mean() >= AGREE
    assert 0.05 < want.mean() < 0.95
    # The two twins of the occlusion query, and any_hit over triangles too.
    lo = torch.full((N,), shade.EPS)
    tri = intersect.bvh_anyhit_reference(tables, _t(o), _t(d), lo, _t(t_max))
    sph = intersect.any_hit_reference(tables.sph, tables.tri[:0], _t(o), _t(d), lo, _t(t_max))
    both = intersect.any_hit_reference(tables.sph, tables.tri[:tables.tri_rows], _t(o), _t(d),
                                       lo, _t(t_max))
    np.testing.assert_array_equal((tri | sph).numpy(), got)
    np.testing.assert_array_equal(both.numpy(), got)


def test_empty_ranges_never_hit(mesh):
    _, _, tables = mesh
    o, d, _ = _rays(3)
    lo = torch.full((N,), 1.0)
    hi = torch.full((N,), 0.5)          # t_max < t_min: no query
    assert not intersect.occluded(tables, _t(o), _t(d), lo, hi).any()
    assert not intersect.intersect(tables, _t(o), _t(d), lo, hi).valid.any()


def test_wrappers_check_inputs(mesh):
    _, _, tables = mesh
    o, d, t_max = _rays(0)
    lo = torch.full((N,), shade.EPS)
    with pytest.raises(ValueError, match="contiguous"):
        intersect.bvh_closest(tables, _t(o).T.contiguous().T, _t(d), lo, _t(t_max))
    with pytest.raises(ValueError, match="float32"):
        intersect.any_hit(tables.sph, tables.tri[:0], _t(o).double(), _t(d), lo, _t(t_max))
    with pytest.raises(ValueError, match="inconsistent"):   # the kernel would read past the table
        intersect.bvh_anyhit(tables._replace(n_groups=tables.n_groups + 1), _t(o), _t(d), lo,
                             _t(t_max))
    meta = [torch.empty_like(x, device="meta") for x in (_t(o), _t(d), lo, _t(t_max))]
    with pytest.raises(ValueError, match="unsupported device"):
        intersect.sphere_closest(tables.sph.to("meta"), *meta)


# ---- The small and flat routes against the JAX kernels in interpret mode ----
#
# The JAX side runs ``intersect``/``occluded`` with
# ``method="pallas_interpret"`` (as tests/test_pallas_intersect.py does):
# ``combined_closest_small`` for <= 64 triangles, ``sphere_closest`` +
# ``triangle_closest`` for the flat route. The port runs its twins.
# Tolerances: prim ids, materials and triangle normals equal; triangle ``t``
# within 32 ulps (measured: 0 on the small route; <= 15 on the flat route,
# on a few grazing rays, over eight ray sets: XLA contracts multiply-adds in
# the interpreted kernel); sphere ``t`` to rtol 1e-4 / atol 2e-5 (the
# ``|o|^2 - 2 o.c + k`` sum cancels: measured 1.8e-5 absolute at t = 0.03
# beside the dome of many_spheres, 2.3e-4 at t = 8.5 on a grazing hit of a
# 0.15-radius sphere, 2.7e-5 relative), and sphere normals, ``(p - c) / r``,
# to that bound on ``t`` divided by the radius (measured 1.3e-3 there).
# Equal-``t`` ties across clusters may pick another row on the flat route
# (the JAX kernel visits clusters nearest-first): budget 2 rays in 2048,
# measured 0.


def _lights65():
    """A small scene past the fused kernels' 64-light cap: 65 emissive
    spheres and a diffuse sphere over a ground quad (the small route in the
    pool's composed branch)."""
    from pathtrace_tpu.models import materials as jm
    from pathtrace_tpu.models.scene import SceneBuilder as JaxBuilder

    b = JaxBuilder()
    b.add_quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8), jm.Lambertian((0.5, 0.5, 0.5)))
    b.add_sphere((0.0, 1.0, 0.0), 1.0, jm.Lambertian((0.7, 0.3, 0.3)))
    for i in range(65):
        a = 2 * np.pi * i / 65
        b.add_sphere((4 * np.cos(a), 3.0 + 0.02 * i, 4 * np.sin(a)), 0.15,
                     jm.Emissive((2.0 + i % 3, 2.0, 2.0)))
    return b.build()


ROUTE_SCENES = {
    "cornell": (jax_scenes.cornell_box, "small"),
    "many_spheres_3": (lambda: jax_scenes.many_spheres(n_per_side=3), "small"),
    "lights65": (_lights65, "small"),
    "mesh_200": (lambda: jax_scenes.mesh_scene(200), "flat"),
    "mesh_1000": (lambda: jax_scenes.mesh_scene(1000), "flat"),
}


@pytest.fixture(scope="module", params=sorted(ROUTE_SCENES))
def route_scene(request):
    fn, route = ROUTE_SCENES[request.param]
    jsc = fn()
    tables = intersect.build_tables(scene_from_arrays(*split_fields(jsc), device="cpu"))
    assert tables.route == route
    return request.param, jsc, tables


def _scene_rays(jsc, seed):
    """Half rays from points inside the scene's bounds, half from outside
    toward points inside; unit directions, random shadow ranges."""
    g = np.random.default_rng(seed)
    lo = np.maximum(np.asarray(jsc.tri_cluster_min).min(0), -6.0)
    hi = np.minimum(np.asarray(jsc.tri_cluster_max).max(0), 6.0)
    hi = np.maximum(hi, lo + 1.0)
    inside = g.uniform(lo, hi, (N, 3))
    o = np.concatenate([inside[: N // 2], g.uniform(lo - 3.0, hi + 3.0, (N // 2, 3))])
    d = np.concatenate([g.normal(size=(N // 2, 3)), inside[N // 2:] - o[N // 2:]])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o.astype(np.float32), d, g.uniform(0.05, 6.0, N).astype(np.float32)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_route_twins_match_jax_interpret(route_scene, seed):
    name, jsc, tables = route_scene
    o, d, _ = _scene_rays(jsc, seed)
    want = jax_isect.intersect(jsc, jnp.asarray(o), jnp.asarray(d), shade.EPS, jnp.inf,
                               method="pallas_interpret")
    got = intersect.intersect(tables, _t(o), _t(d), shade.EPS, INF)
    prim, wprim = got.prim.numpy(), np.asarray(want.prim)
    same = prim == wprim
    assert (~same).sum() <= (2 if tables.route == "flat" else 0), np.nonzero(~same)
    hit = same & (prim >= 0)
    assert hit.mean() > 0.3, hit.mean()
    np.testing.assert_array_equal(got.mat.numpy()[same], np.asarray(want.mat)[same])
    tri = hit & (prim < tables.tri_rows)
    sph = hit & (prim >= tables.tri_rows)
    assert tri.any() and (sph.any() or name.startswith("mesh_2"))
    assert _ulps(got.t.numpy()[tri], np.asarray(want.t)[tri]).max() <= 32
    np.testing.assert_array_equal(got.normal.numpy()[tri], np.asarray(want.normal)[tri])
    np.testing.assert_allclose(got.t.numpy()[sph], np.asarray(want.t)[sph], rtol=1e-4,
                               atol=2e-5)
    radius = tables.sph[prim[sph] - tables.tri_rows, 4].numpy() ** -1
    bound = (2e-5 + 1e-4 * np.asarray(want.t)[sph]) / radius
    assert (np.abs(got.normal.numpy()[sph] - np.asarray(want.normal)[sph]).max(1) <= bound).all()
    assert np.isinf(got.t.numpy()[prim < 0]).all()


def test_route_occlusion_matches_jax_interpret(route_scene):
    _, jsc, tables = route_scene
    o, d, t_max = _scene_rays(jsc, 2)
    want = np.asarray(jax_isect.occluded(jsc, jnp.asarray(o), jnp.asarray(d), shade.EPS,
                                         jnp.asarray(t_max), method="pallas_interpret"))
    got = intersect.occluded(tables, _t(o), _t(d), shade.EPS, _t(t_max)).numpy()
    assert (got != want).sum() <= 2
    assert 0.02 < want.mean() < 0.98


@pytest.mark.parametrize("name", ["cornell", "many_spheres_3", "lights65"])
def test_combined_twin_is_the_sphere_then_triangle_merge(name):
    """On the small route the one-pass twin equals the two-kernel
    composition of the other routes (triangles win equal ``t``)."""
    jsc = ROUTE_SCENES[name][0]()
    tables = intersect.build_tables(scene_from_arrays(*split_fields(jsc), device="cpu"))
    o, d, _ = _scene_rays(jsc, 3)
    lo, hi = torch.full((N,), shade.EPS), torch.full((N,), INF)
    t, prim, nrm, mat = intersect.combined_closest_small_reference(tables, _t(o), _t(d), lo, hi)
    st, sp, sn, sm = intersect.sphere_closest_reference(tables.sph, _t(o), _t(d), lo, hi)
    tt, tp, tn, tm = intersect.triangle_closest_reference(tables, _t(o), _t(d), lo,
                                                          torch.minimum(hi, st))
    sph = st < tt
    np.testing.assert_array_equal(t.numpy(), torch.where(sph, st, tt).numpy())
    np.testing.assert_array_equal(prim.numpy(),
                                  torch.where(sph, sp + tables.tri_rows, tp).numpy())
    np.testing.assert_array_equal(mat.numpy(), torch.where(sph, sm, tm).numpy())
    miss = prim.numpy() < 0
    assert (nrm.numpy()[miss] == 0).all() and (mat.numpy()[miss] == 0).all()


def test_flat_cluster_boxes_cover_their_rows():
    tsc = scene_from_arrays(*split_fields(jax_scenes.mesh_scene(1000)), device="cpu")
    tables = intersect.build_tables(tsc)
    c = tables.leaf.shape[0]
    assert tables.tri.shape == (c * 256, 16) and not tables.tri[tables.tri_rows:].any()
    v0, e1, e2 = tables.tri[:, 0:3], tables.tri[:, 3:6], tables.tri[:, 6:9]
    pts = torch.stack([v0, v0 + e1, v0 + e2]).reshape(3, c, 256, 3)
    real = torch.arange(c * 256).reshape(c, 256) < tables.tri_rows
    for k in range(c):
        p = pts[:, k][:, real[k]].reshape(-1, 3)
        assert (p >= tables.leaf[k, 0:3]).all() and (p <= tables.leaf[k, 3:6]).all()
        assert (tables.leaf[k, 0:3] < tsc.tri_cluster_min[k]).all()   # widened outward


def test_resolve_route():
    r = intersect.resolve_route
    assert r(12, 1) == r(64, 512) == "small"
    assert r(65, 3) == r(4095, 512) == "flat"
    assert r(4096, 3) == r(70000, 600) == "bvh"
    assert r(12, 1, "bvh") == "small" and r(992, 3, "bvh") == "bvh"
    assert r(5000, 3, "pallas") == "flat"
    for m in ("binned", "resident"):     # the per-ray traversals past 64 triangles
        assert r(65, 3, m) == r(992, 3, m) == r(70000, 600, m) == m
        assert r(64, 3, m) == r(12, 1, m) == "small"
    # More than 512 spheres beside <= 64 triangles: the composed form, served
    # by the flat route's tables under every method (the JAX tri_small gate).
    assert r(2, 600) == r(12, 600, "binned") == r(64, 513, "resident") == "flat"
    # Brute force takes the route of "pallas": every route gives its hits.
    for n_tris, n_sph in ((12, 1), (64, 513), (992, 3), (70000, 600)):
        assert r(n_tris, n_sph, "bruteforce") == r(n_tris, n_sph, "pallas")
    with pytest.raises(NotImplementedError, match="bruteforce"):
        r(992, 3, "mxu")


def test_route_wrappers_check_tables(route_scene):
    _, _, tables = route_scene
    o, d = _t(np.zeros((4, 3), np.float32)), _t(np.ones((4, 3), np.float32))
    lo, hi = torch.full((4,), shade.EPS), torch.full((4,), INF)
    wrong = intersect.triangle_closest if tables.route == "small" else \
        intersect.combined_closest_small
    with pytest.raises(ValueError, match="route"):
        wrong(tables, o, d, lo, hi)
    right = intersect.combined_closest_small if tables.route == "small" else \
        intersect.triangle_closest
    with pytest.raises(ValueError, match="inconsistent"):
        right(tables._replace(tri=tables.tri[:-1].contiguous()), o, d, lo, hi)
