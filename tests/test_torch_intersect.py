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
    tsc = scene_from_arrays(*split_fields(jsc))
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
