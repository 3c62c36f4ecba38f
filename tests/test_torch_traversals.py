"""The port's opt-in per-ray mesh traversals (``method="binned"`` and
``method="resident"``) against the JAX package's on the CPU.

The JAX side runs its Pallas kernels in interpret mode
(``method="binned_interpret"``/``"resident_interpret"``, as
``tests/test_intersect.py`` does) or, for whole renders, its CPU default
route (``bruteforce``); the port runs its kernels' plain twins on CPU tensors
(the binned driver around its round twin, the resident route's brute-force
twin). Inputs are made with numpy from seeds.

Tolerances, and why: the port's answer equals the brute-force twin
**exactly** (the binned driver keeps a ray live while its entry is <= its
bound and merges equal ``t`` to the lower row); the JAX traversals may
resolve an equal-``t`` tie to another row, the JAX interpreted kernels
contract multiply-adds, and the spheres are tested in another algebraic
form. So against JAX: prim ids agree on >= 99.9% of rays (measured: all),
occlusion on >= 99.9% (measured: all); where the prim agrees, ``t`` and the
point agree to rtol 1e-4 / atol 2e-5 and the normal to atol 1e-4, the bounds
of ``tests/test_torch_intersect.py``. Tables are bitwise equal. Renders give
exactly the JAX engines' ray and iteration counts.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu import integrators as jax_integrators  # noqa: E402
from pathtrace_tpu import pool as jax_pool  # noqa: E402
from pathtrace_tpu.models import scenes as jax_scenes  # noqa: E402
from pathtrace_tpu.ops import intersect as jax_isect  # noqa: E402
from pathtrace_tpu.ops.resident_intersect import _derived_aabbs  # noqa: E402
from pathtrace_tpu.utils import rng as jax_rng  # noqa: E402
from pathtrace_tpu_torch import integrators, meshes, pool  # noqa: E402
from pathtrace_tpu_torch.convert import (  # noqa: E402
    camera_from_arrays,
    scene_from_arrays,
    split_fields,
)
from pathtrace_tpu_torch.models import scenes  # noqa: E402
from pathtrace_tpu_torch.models.materials import Lambertian  # noqa: E402
from pathtrace_tpu_torch.models.scene import SceneBuilder  # noqa: E402
from pathtrace_tpu_torch.ops import binned, intersect, shade  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402

from .imgutil import assert_images_match  # noqa: E402

AGREE = 0.999
INF = float("inf")
METHODS = ("binned", "resident")


@pytest.fixture(scope="module")
def mesh2500():
    jsc = jax_scenes.mesh_scene(n_tris=2500)
    return jsc, scene_from_arrays(*split_fields(jsc), device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rays(jsc, n, seed):
    """Rays from points in the triangles' bounds in random unit directions,
    as ``tests/test_intersect.py`` makes them (with numpy)."""
    g = np.random.default_rng(seed)
    lo = np.asarray(jsc.tri_cluster_min).min(0)
    hi = np.asarray(jsc.tri_cluster_max).max(0)
    o = (g.random((n, 3)) * (hi - lo) + lo).astype(np.float32)
    d = g.normal(size=(n, 3))
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def test_resident_boxes_equal_jax_and_cover_their_rows(mesh2500):
    jsc, tsc = mesh2500
    t = jsc.tri_v0.shape[0]
    rows = -(-t // 128) * 128
    want, c_pad = _derived_aabbs(jsc.tri_v0, jsc.tri_e1, jsc.tri_e2, rows, 128, jnp.float32)
    got = intersect.resident_boxes(tsc.tri_v0, tsc.tri_e1, tsc.tri_e2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tables = intersect.build_tables(tsc, "resident")
    c = tables.leaf.shape[0]
    assert c == c_pad and tables.tri.shape == (c * 128, 16) and tables.route == "resident"
    assert not tables.tri[tables.tri_rows:].any()          # zero padding rows
    v0, e1, e2 = tables.tri[:, 0:3], tables.tri[:, 3:6], tables.tri[:, 6:9]
    pts = torch.stack([v0, v0 + e1, v0 + e2]).reshape(3, c, 128, 3)
    real = torch.arange(c * 128).reshape(c, 128) < tables.tri_rows
    for k in range(c):
        if not real[k].any():                              # padding: inverted, never entered
            assert (tables.leaf[k, 0:3] > tables.leaf[k, 3:6]).all()
            continue
        p = pts[:, k][:, real[k]].reshape(-1, 3)
        assert (p >= tables.leaf[k, 0:3]).all() and (p <= tables.leaf[k, 3:6]).all()
        assert (tables.leaf[k, 0:3] < got[k, 0:3]).all()   # widened outward
        assert (tables.leaf[k, 3:6] > got[k, 3:6]).all()


def test_binned_tables_equal_the_flat_ones(mesh2500):
    _, tsc = mesh2500
    flat, bins = intersect.build_tables(tsc, "pallas"), intersect.build_tables(tsc, "binned")
    assert (flat.route, bins.route) == ("flat", "binned")
    for f in ("tri", "leaf", "group", "sph"):
        assert torch.equal(getattr(flat, f), getattr(bins, f)), f
    assert (flat.tri_rows, flat.n_groups) == (bins.tri_rows, bins.n_groups)


@pytest.mark.parametrize("method,n", [("binned", 4096), ("resident", 2048)])
def test_traversal_matches_jax_interpret(mesh2500, method, n):
    """``mesh_scene(2500)``: binned at N = 4096 (one cascade compaction),
    resident at N = 2048, against the JAX kernels in interpret mode."""
    jsc, tsc = mesh2500
    tables = intersect.build_tables(tsc, method)
    o, d = _rays(jsc, n, 9)
    want = jax_isect.intersect(jsc, jnp.asarray(o), jnp.asarray(d), shade.EPS, jnp.inf,
                               method=f"{method}_interpret")
    got = intersect.intersect(tables, _t(o), _t(d), shade.EPS, INF)
    prim, wprim = got.prim.numpy(), np.asarray(want.prim)
    same = prim == wprim
    assert same.mean() >= AGREE, np.nonzero(~same)
    hit = same & (prim >= 0)
    assert hit.mean() > 0.5 and (prim >= tables.tri_rows).any()
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(got.point.numpy()[hit], np.asarray(want.point)[hit], rtol=1e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got.normal.numpy()[hit], np.asarray(want.normal)[hit], atol=1e-4)
    np.testing.assert_array_equal(got.mat.numpy()[hit], np.asarray(want.mat)[hit])

    t_max = np.random.default_rng(3).uniform(0.1, 4.0, n).astype(np.float32)
    want_occ = np.asarray(jax_isect.occluded(jsc, jnp.asarray(o), jnp.asarray(d), shade.EPS,
                                             jnp.asarray(t_max), method=f"{method}_interpret"))
    got_occ = intersect.occluded(tables, _t(o), _t(d), shade.EPS, _t(t_max)).numpy()
    assert (got_occ == want_occ).mean() >= AGREE
    assert 0.05 < want_occ.mean() < 0.95


def _tie_scene():
    """A 40 x 40 grid of unit quads in the plane y = 0 (3,200 triangles, SAH
    order, 13 binned clusters): every interior vertex and edge is shared by
    triangles that often sit in different clusters."""
    n = 41
    u, v = np.meshgrid(np.arange(n, dtype=np.float64), np.arange(n, dtype=np.float64),
                       indexing="ij")
    verts = np.stack([u.ravel() - 20.0, np.zeros(n * n), v.ravel() - 20.0], axis=1)
    b = SceneBuilder(device="cpu")
    b.add_mesh(verts, meshes.grid_mesh(n, n, wrap_u=False, wrap_v=False),
               Lambertian((0.5, 0.5, 0.5)))
    return b.build()


def _tie_rays(n, seed):
    """Rays from above aimed exactly at grid vertices and edge midpoints
    (exact equal-``t`` ties between neighbouring triangles), half of them at
    random points."""
    g = np.random.default_rng(seed)
    target = np.stack([g.integers(-19, 20, n), np.zeros(n), g.integers(-19, 20, n)], 1)
    target = target.astype(np.float32)
    target[n // 4:n // 2, 0] += 0.5                                   # edge midpoints
    target[n // 2:] = g.uniform([-19.0, 0.0, -19.0], [19.0, 0.0, 19.0], (n - n // 2, 3))
    o = np.stack([g.uniform(-25, 25, n), g.uniform(1, 10, n), g.uniform(-25, 25, n)], 1)
    o = o.astype(np.float32)
    o[: n // 8, 0] = target[: n // 8, 0]                             # straight down
    o[: n // 8, 2] = target[: n // 8, 2]
    d = target - o
    return _t(o), _t((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))


def test_binned_driver_equals_bruteforce_exactly_on_ties():
    """The binned drivers with their round twins equal the brute-force twin
    exactly on rays aimed at shared vertices and edges, with the cascade
    (N = 4096) and without it (N = 4000)."""
    sc = _tie_scene()
    tables = intersect.build_tables(sc, "binned")
    assert tables.leaf.shape[0] == 13
    o, d = _tie_rays(4096, 0)
    n = o.shape[0]
    lo, hi = torch.full((n,), shade.EPS), torch.full((n,), INF)
    ref = intersect.triangle_closest_reference(tables, o, d, lo, hi)
    assert (ref[1] >= 0).float().mean() > 0.9
    stats = {}
    got = binned.triangle_closest_binned(tables, o, d, lo, hi, stats=stats)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    assert stats["rounds"] >= 2 and stats["ray_rounds"] >= n
    k = 4000                                               # under CASCADE_MIN: no compaction
    got = binned.triangle_closest_binned(tables, o[:k], d[:k], lo[:k], hi[:k])
    for a, b in zip(ref, got):
        assert torch.equal(a[:k], b)
    t_max = ref[0] + torch.where(torch.arange(n) % 2 == 0, 1e-3, -1e-3)   # hit or just short
    want = intersect.bvh_anyhit_reference(tables, o, d, lo, t_max)
    assert 0.3 < want.float().mean() < 0.7
    assert torch.equal(binned.triangle_anyhit_binned(tables, o, d, lo, t_max), want)
    assert torch.equal(binned.triangle_anyhit_binned(tables, o[:k], d[:k], lo[:k], t_max[:k]),
                       want[:k])


def test_round_twin_masks_the_sentinel(mesh2500):
    """A round on a sorted wave: rays with the sentinel key (or a negative
    one) get ``(inf, -1, 0, 0)`` / false; the others their cluster's hit."""
    jsc, tsc = mesh2500
    tables = intersect.build_tables(tsc, "binned")
    o, d = _rays(jsc, 256, 4)
    o, d = _t(o), _t(d)
    c = tables.leaf.shape[0]
    key = torch.arange(256, dtype=torch.int32) % (c + 2) - 1            # -1 .. c
    lo, hi = torch.full((256,), shade.EPS), torch.full((256,), INF)
    t, row, nrm, mat = binned.round_closest(tables, o, d, lo, hi, key)
    occ = binned.round_anyhit(tables, o, d, lo, hi, key)
    dead = (key < 0) | (key >= c)
    assert torch.isinf(t[dead]).all() and (row[dead] == -1).all() and not occ[dead].any()
    assert not nrm[dead].any() and not mat[dead].any()
    live = ~dead
    assert ((row[live] == -1) | (row[live] // 256 == key[live])).all()
    assert torch.equal(occ[live], row[live] >= 0)
    assert (row >= 0).any()


def test_pool_route_takes_the_method():
    """The JAX gate: the fused branch only under the default method."""
    sc = scenes.cornell_box(device="cpu")
    for m in (None, "auto", "pallas"):
        assert pool.route(sc, "mis", m) == "fused"
    for m in ("bvh", "binned", "resident"):
        assert pool.route(sc, "mis", m) == "composed"
        assert intersect.build_tables(sc, m).route == "small"


@pytest.mark.parametrize("method", METHODS)
def test_pool_with_method_matches_jax_composed(method):
    """``render_pool(method=...)`` on ``mesh_scene(4200)`` (8x8, 2 spp, MIS)
    against the JAX composed pool: 348 rays in 8 iterations, as the BVH
    route gives."""
    jsc, jcam = jax_scenes.mesh_scene(4200), jax_scenes.mesh_scene_camera(8, 8)
    kw = dict(width=8, height=8, spp=2, integrator="mis", max_bounces=4, num_slots=64, seed=5)
    img, counters, iters = jax_pool.render_pool(jsc, jcam, **kw)
    shade.LAUNCHES.clear()
    timg, tcounters, titers = pool.render_pool(
        scene_from_arrays(*split_fields(jsc), device="cpu"),
        camera_from_arrays(*split_fields(jcam), device="cpu"), method=method, **kw)
    assert not shade.LAUNCHES                      # CPU tensors: twins, no launch
    assert pool.ray_count(tcounters) == jax_pool.ray_count(counters) == 348
    assert titers == int(iters) == 8
    assert_images_match(timg.numpy(), np.asarray(img))


@pytest.mark.parametrize("method", METHODS)
def test_wave_with_method_matches_jax(method):
    """``trace_wave`` on ``mesh_scene(1000)`` at 8x8 on the method's tables
    gives the JAX wave engine's ray-query count."""
    jsc, jcam = jax_scenes.mesh_scene(1000), jax_scenes.mesh_scene_camera(8, 8)
    W, H = 8, 8
    pixel = np.arange(W * H)
    jk = jax_rng.pixel_sample_keys(jax_rng.base_key(3), jnp.asarray(pixel, jnp.int32),
                                   jnp.zeros(W * H, jnp.int32))
    tk = rng.pixel_sample_keys(rng.base_key(3), torch.from_numpy(pixel).long(),
                               torch.zeros(W * H, dtype=torch.int64))
    jo, jd = jcam.generate_rays(jnp.asarray(pixel % W), jnp.asarray(H - 1 - pixel // W),
                                jax_rng.primary_jitter(jk))
    want = jax_integrators.trace_wave(jsc, jo, jd, jk, return_stats=True, max_bounces=64)
    tsc = scene_from_arrays(*split_fields(jsc), device="cpu")
    cam = camera_from_arrays(*split_fields(jcam), device="cpu")
    tp = torch.from_numpy(pixel)
    o, d = cam.generate_rays(tp % W, H - 1 - tp // W, rng.primary_jitter(tk), transposed=False)
    tables = intersect.build_tables(tsc, method)
    assert tables.route == method
    got = integrators.trace_wave(tsc, o, d, tk, return_stats=True, max_bounces=64, tables=tables)
    assert got[1] == int(want[1])
    assert_images_match(got[0].numpy(), np.asarray(want[0]))


def test_default_device_is_the_gpu():
    """Builders and loaders default to CUDA: without a GPU they raise, and
    the CPU is used only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default builds there")
    from pathtrace_tpu_torch.models.camera import Camera

    with pytest.raises((AssertionError, RuntimeError)):
        scenes.cornell_box()
    with pytest.raises((AssertionError, RuntimeError)):
        scenes.cornell_camera(4, 4)
    with pytest.raises((AssertionError, RuntimeError)):
        Camera.look_at((0, 0, 1), (0, 0, 0), (0, 1, 0), 4, 4)
    with pytest.raises((AssertionError, RuntimeError)):
        SceneBuilder().add_sphere((0, 0, -3), 1.0, Lambertian((0.5, 0.5, 0.5))).build()
    with pytest.raises((AssertionError, RuntimeError)):
        scene_from_arrays(*split_fields(jax_scenes.cornell_box()))
    sc = scenes.cornell_box(device="cpu")
    assert sc.device.type == "cpu" and sc.num_tris == 12
