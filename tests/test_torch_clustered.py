"""The port's clustered sphere modes (scenes past 512 sphere rows) against the
JAX package's on the CPU.

Two scenes: ``many_spheres(n_per_side=12)`` (580 spheres in 3 clusters of
256 rows, 2 triangles: the flat route with one padded triangle cluster) and
a 990-triangle knot on a ground quad among 600 spheres plus a light (the
flat route with 4 triangle clusters and 3 sphere clusters), both built by the JAX builders and
carried over with ``scene_from_arrays``. The JAX side runs
``intersect``/``occluded(method="pallas_interpret")``, i.e. its clustered
``sphere_closest``/``any_hit`` kernels in interpret mode; for whole renders
the JAX engines run their CPU default route (``bruteforce``). The port runs
its kernels' plain twins on CPU tensors.

Whole renders are pinned to seed 1 against the JAX CPU route and to seed 7
against the JAX composed pool under ``method="pallas_interpret"``. At a
vertex on a sphere far from the origin the kernels' ``|c|^2 - r^2`` form can
find the same sphere again just past ``t_min`` (t = 0.0014 to 0.0039 on 5
peek rays of the seed-3 wave); the ``o - c`` form of the JAX CPU route does
not. Such a flip parts one path. Over seeds 0-7 of these 8x8 frames (pool
and wave, three integrators) seeds 0, 3 and 4 parted a path against the CPU
route; seeds 1, 2, 5, 6 and 7 give equal counts and images on all six
renders. The interpreted Pallas kernels share the form, and the pool's
counts equal theirs on seeds 0, 1, 2, 4, 6 and 7 for all three integrators;
seeds 3 and 5 part at knife edges of the form's float32 rounding, which the
jitted interpreted kernel rounds otherwise (XLA fuses and contracts the
interpreted ops; its sqrt is not correctly rounded). Seed 3: the port and
the JAX pool run without jit both re-hit a vertex's own sphere at t =
0.00142 (the origin 1.3e-5 inside it) and trace 410 rays, where the jitted
kernel finds the ground at t = 1.18 (414 rays). Seed 5: no hit differs on
the port's rays, but the interpreted kernel's t on the same sphere differs
from the port's by up to 1.6e-3; the shifted origins part a near-grazing ray
at the fifth bounce step, and the port's pool fed the interpreted kernel's
hit records traces the JAX pool's 416 rays exactly.

Tolerances, and why (the bounds of ``tests/test_torch_intersect.py``):
prim ids equal except on equal-``t`` ties across clusters, which the JAX
kernels break nearest-first (budget 2 rays in N, measured 0); materials
equal; triangle ``t`` within 32 ulps and triangle normals exact; sphere
``t`` to rtol 1e-4 / atol 2e-5 and sphere normals to that over the radius,
except on at most 3 rays in N, which stay within the root-error bound
``sqrt(2^-17) (|o| + |c| + r)`` of ``csrc/intersect.cu`` (XLA contracts
multiply-adds in the interpreted kernels and the ``|o|^2 - 2 o.c + k`` sum
cancels: measured 3 such rays, 0.0197 at t = 120.3 from an origin 117 away,
9.1e-5 at t = 0.36 beside a 0.2 sphere); occlusion equal but for 2 rays in
N (measured 0). Whole renders give exactly the JAX engines' ray and
iteration counts, images within the ``tests/imgutil.py`` budget.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu import integrators as jax_integrators  # noqa: E402
from pathtrace_tpu import meshes as jax_meshes  # noqa: E402
from pathtrace_tpu import pool as jax_pool  # noqa: E402
from pathtrace_tpu.models import materials as jax_mat  # noqa: E402
from pathtrace_tpu.models import scenes as jax_scenes  # noqa: E402
from pathtrace_tpu.models.scene import SceneBuilder as JaxBuilder  # noqa: E402
from pathtrace_tpu.ops import intersect as jax_isect  # noqa: E402
from pathtrace_tpu.utils import rng as jax_rng  # noqa: E402
from pathtrace_tpu_torch import cli, integrators, meshes, pool  # noqa: E402
from pathtrace_tpu_torch.convert import (  # noqa: E402
    camera_from_arrays,
    scene_from_arrays,
    split_fields,
)
from pathtrace_tpu_torch.models import materials as mat  # noqa: E402
from pathtrace_tpu_torch.models import scenes  # noqa: E402
from pathtrace_tpu_torch.models.scene import SceneBuilder  # noqa: E402
from pathtrace_tpu_torch.ops import intersect, shade  # noqa: E402
from pathtrace_tpu_torch.render import RenderConfig, render  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402

from .imgutil import assert_images_match  # noqa: E402

N = 384
WAVE_QUERIES = {"mis": 188, "nee": 188, "brdf_only": 126}   # measured for the JAX wave engine
INF = float("inf")
METHODS = ("auto", "pallas", "bvh", "binned", "resident")


def _knot_field(builder, m, knot):
    """A 990-triangle knot on a ground quad among 600 spheres in rings
    (diffuse, metal and glass) under a spherical light; ``builder``, ``m``
    and ``knot`` are one package's ``SceneBuilder``, materials module and
    ``knot_mesh``."""
    b = builder()
    b.add_quad((-12, -1.0, -12), (12, -1.0, -12), (12, -1.0, 12), (-12, -1.0, 12),
               m.Lambertian((0.45, 0.45, 0.45)))
    verts, faces = knot(n_tris=1000, scale=1.2, center=(0.0, 0.35, 0.0))
    b.add_mesh(verts, faces, m.Lambertian((0.65, 0.45, 0.25)))
    kinds = (m.Lambertian((0.7, 0.3, 0.3)), m.Mirror(roughness=0.3, metallic=1.0),
             m.Mirror(roughness=0.05, metallic=0.0, ior=1.5))
    for k in range(600):
        a = 2 * np.pi * k / 150
        r = 2.5 + 0.9 * (k // 150)
        b.add_sphere((r * np.cos(a), -0.8 + 0.05 * (k % 7), r * np.sin(a)), 0.15, kinds[k % 3])
    b.add_sphere((0.0, 8.0, 0.0), 2.0, m.Emissive((6.0, 6.0, 6.0)))
    return b.build()


SCENES = {
    "many_spheres_12": (lambda: jax_scenes.many_spheres(n_per_side=12), (13.0, 2.0, 3.0)),
    "knot_field": (lambda: _knot_field(JaxBuilder, jax_mat, jax_meshes.knot_mesh),
                   (0.0, 1.6, 7.5)),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def field(request):
    build, eye = SCENES[request.param]
    jsc = build()
    tsc = scene_from_arrays(*split_fields(jsc), device="cpu")
    return request.param, jsc, tsc, intersect.build_tables(tsc), eye


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rays(jsc, eye, n, seed):
    """A third camera rays from ``eye``, a third from points in the field in
    random directions, a third from far away (|o| up to ~170); the aimed
    rays go half to points of the field, half to points inside its spheres.
    Unit directions and random shadow ranges."""
    g = np.random.default_rng(seed)
    k = n // 3
    center, radius = np.asarray(jsc.sph_center), np.asarray(jsc.sph_radius)
    pick = g.choice(np.nonzero(radius > 0)[0], n)
    target = np.where(g.random((n, 1)) < 0.5, g.uniform([-12, -1, -12], [12, 2, 12], (n, 3)),
                      center[pick] + g.uniform(-0.5, 0.5, (n, 3)) * radius[pick, None])
    o = np.concatenate([np.tile([eye], (k, 1)), g.uniform([-12, -0.9, -12], [12, 3, 12], (k, 3)),
                        g.uniform(-100.0, 100.0, (n - 2 * k, 3))])
    d = target - o
    d[k:2 * k] = g.normal(size=(k, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o.astype(np.float32), d, g.uniform(0.05, 12.0, n).astype(np.float32)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_sphere_cluster_boxes(field):
    """One box row per 256 sphere rows: ``Scene.sph_cluster_min/max``
    widened outward, covering its spheres, with the cluster's reach (largest
    ``|c| + r``) and least radius."""
    _, _, tsc, tables, _ = field
    s = tsc.sph_center.shape[0]
    box = tables.sph_box
    assert s > intersect.SMALL_MAX_SPHERES and box.shape == (-(-s // 256), 8)
    assert (box[:, 0:3] < tsc.sph_cluster_min).all() and (box[:, 3:6] > tsc.sph_cluster_max).all()
    for c in range(box.shape[0]):
        cen, rad = tsc.sph_center[c * 256:(c + 1) * 256], tsc.sph_radius[c * 256:(c + 1) * 256]
        real = rad > 0
        cen, rad = cen[real], rad[real]
        assert (cen - rad[:, None] >= box[c, 0:3]).all() and (cen + rad[:, None] <= box[c, 3:6]).all()
        assert box[c, 6] == (torch.linalg.vector_norm(cen, dim=1) + rad).max()
        assert box[c, 7] == rad.min()
    small = intersect.build_tables(scene_from_arrays(
        *split_fields(jax_scenes.many_spheres(n_per_side=11)), device="cpu"))
    assert small.sph.shape[0] == 488 and small.sph_box.shape[0] == 0


def test_port_builder_gives_the_same_tables():
    """The knot field built by the port's own builder packs to the tables of
    the JAX-built one."""
    jsc = _knot_field(JaxBuilder, jax_mat, jax_meshes.knot_mesh)
    want = intersect.build_tables(scene_from_arrays(*split_fields(jsc), device="cpu"))
    got = intersect.build_tables(_knot_field(functools.partial(SceneBuilder, device="cpu"), mat,
                                             meshes.knot_mesh))
    for f in ("tri", "leaf", "sph", "sph_box"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert (got.route, got.tri_rows) == (want.route, want.tri_rows) == ("flat", 992)


def test_routes_past_512_spheres():
    """The JAX gates: <= 64 triangles beside > 512 spheres is the composed
    form (the port's flat route) under every method; more triangles keep
    their route; every route carries the sphere boxes; the pool runs the
    composed branch."""
    r = intersect.resolve_route
    assert r(2, 580) == r(64, 513) == r(2, 580, "pallas") == "flat"
    for m in intersect.PER_RAY_METHODS:
        assert r(2, 580, m) == r(64, 600, m) == "flat"
        assert r(1002, 601, m) == m
    assert r(1002, 601) == r(1002, 601, "pallas") == "flat" and r(5000, 601) == "bvh"
    assert r(64, 512) == "small"
    knot = scene_from_arrays(*split_fields(_knot_field(JaxBuilder, jax_mat, jax_meshes.knot_mesh)),
                             device="cpu")
    many = scenes.many_spheres(n_per_side=12, device="cpu")
    for sc, routes in ((many, ("flat",) * 5), (knot, ("flat", "flat", "bvh", "binned",
                                                      "resident"))):
        for m, want in zip(METHODS, routes):
            tables = intersect.build_tables(sc, m)
            assert tables.route == want and tables.sph_box.shape[0] == 3, (m, tables.route)
            assert pool.route(sc, "mis", m) == "composed"


@pytest.mark.parametrize("seed", [0, 1])
def test_clustered_twins_match_jax_interpret(field, seed):
    """``intersect`` against the JAX clustered kernels in interpret mode."""
    name, jsc, _, tables, eye = field
    o, d, _ = _rays(jsc, eye, N, seed)
    want = jax_isect.intersect(jsc, jnp.asarray(o), jnp.asarray(d), shade.EPS, jnp.inf,
                               method="pallas_interpret")
    got = intersect.intersect(tables, _t(o), _t(d), shade.EPS, INF)
    prim, wprim = got.prim.numpy(), np.asarray(want.prim)
    same = prim == wprim
    assert (~same).sum() <= 2, np.nonzero(~same)
    hit = same & (prim >= 0)
    assert hit.mean() > 0.3, hit.mean()
    np.testing.assert_array_equal(got.mat.numpy()[same], np.asarray(want.mat)[same])
    tri = hit & (prim < tables.tri_rows)
    sph = hit & (prim >= tables.tri_rows)
    assert tri.any() and sph.sum() > 20
    assert _ulps(got.t.numpy()[tri], np.asarray(want.t)[tri]).max() <= 32
    np.testing.assert_array_equal(got.normal.numpy()[tri], np.asarray(want.normal)[tri])
    row = tables.sph[prim[sph] - tables.tri_rows]
    radius = row[:, 4].numpy() ** -1
    wt = np.asarray(want.t)[sph]
    tight = 2e-5 + 1e-4 * wt
    pad = 2.0**-8.5 * (np.linalg.norm(o[sph], axis=1)
                       + np.linalg.norm(row[:, 0:3].numpy(), axis=1) + radius)
    dt = np.abs(got.t.numpy()[sph] - wt)
    assert (dt <= np.maximum(tight, pad)).all() and (dt > tight).sum() <= 3, dt / tight
    dn = np.abs(got.normal.numpy()[sph] - np.asarray(want.normal)[sph]).max(1)
    assert (dn <= np.where(dt > tight, pad, tight) / radius).all()
    assert np.isinf(got.t.numpy()[prim < 0]).all()


def test_clustered_occlusion_matches_jax_interpret(field):
    _, jsc, _, tables, eye = field
    o, d, t_max = _rays(jsc, eye, N, 2)
    want = np.asarray(jax_isect.occluded(jsc, jnp.asarray(o), jnp.asarray(d), shade.EPS,
                                         jnp.asarray(t_max), method="pallas_interpret"))
    got = intersect.occluded(tables, _t(o), _t(d), shade.EPS, _t(t_max)).numpy()
    assert (got != want).sum() <= 2
    assert 0.05 < want.mean() < 0.95


def test_every_method_gives_the_twins_answer(field):
    """``auto``, ``pallas``, ``bvh``, ``binned`` and ``resident`` all build the
    sphere boxes and give the same hits and occlusion, bit for bit (each
    route equals brute force)."""
    _, jsc, tsc, tables, eye = field
    o, d, t_max = (_t(a) for a in _rays(jsc, eye, 512, 4))
    ref = intersect.intersect(tables, o, d, shade.EPS, INF)
    ref_occ = intersect.occluded(tables, o, d, shade.EPS, t_max)
    for m in METHODS:
        tm = intersect.build_tables(tsc, m)
        assert torch.equal(tm.sph_box, tables.sph_box), m
        got = intersect.intersect(tm, o, d, shade.EPS, INF)
        for a, b in zip(ref, got):
            assert torch.equal(a, b), m
        assert torch.equal(intersect.occluded(tm, o, d, shade.EPS, t_max), ref_occ), m


def test_sphere_pad_covers_the_root_error():
    """The cull margin of ``csrc/intersect.cu``: for grazing rays, with
    origins up to ~170 from the origin, radii 0.02 to 30 and directions up
    to 1e-3 off unit length, the point of every root the sphere test accepts
    lies within the pad ``min(s, s^2 / (2 r))``, ``s = sqrt(2^-17 + 8 |d.d -
    1|) (|o| + |c| + r)``, of its sphere. The test runs in float32 with the
    kernel's op order (numpy rounds each operation, contracts nothing and
    takes a correctly rounded sqrt, as the card does)."""
    f = np.float32
    g = np.random.default_rng(0)
    n = 400_000
    c = g.uniform(-60, 60, (n, 3)).astype(f)
    r = np.exp(g.uniform(np.log(0.02), np.log(30.0), n)).astype(f)
    o = g.uniform(-100, 100, (n, 3)).astype(f)
    v = g.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    aim = c + v * (r * (1 + g.uniform(-1e-3, 1e-3, n)))[:, None]     # at the silhouette
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = (d * np.where(g.random(n) < 0.3, 1 + g.uniform(-1e-3, 1e-3, n), 1.0)[:, None]).astype(f)

    def dot(a, b):
        return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]

    k = dot(c, c) - r * r                                   # build_tables' row
    half_b = dot(o, d) - dot(c, d)
    cq = dot(o, o) - f(2.0) * dot(c, o) + k
    with np.errstate(invalid="ignore"):
        sq = np.sqrt(half_b * half_b - cq)
    root1 = -half_b - sq
    t = np.where(root1 >= f(1e-3), root1, -half_b + sq)
    ok = t >= f(1e-3)
    assert ok.mean() > 0.3
    q = o.astype(np.float64) + t.astype(np.float64)[:, None] * d
    off = np.linalg.norm(q - c, axis=1) - r
    s = (np.sqrt(2.0**-17 + 8 * np.abs(dot(d.astype(np.float64), d) - 1))
         * (np.linalg.norm(o, axis=1) + np.linalg.norm(c, axis=1) + r))
    pad = np.minimum(s, s * s / (2 * r))
    assert (off[ok] <= pad[ok]).all(), (off[ok] / pad[ok]).max()


def _render_both(jsc, jcam, jax_method=None, **kw):
    """The JAX pool (``jax_method``: its ``method``, None its CPU default)
    and the port's pool on the same frame."""
    img, counters, iters = jax_pool.render_pool(jsc, jcam, method=jax_method, **kw)
    shade.LAUNCHES.clear()
    got = pool.render_pool(scene_from_arrays(*split_fields(jsc), device="cpu"),
                           camera_from_arrays(*split_fields(jcam), device="cpu"), **kw)
    assert not shade.LAUNCHES                          # CPU tensors: twins, no launch
    return (np.asarray(img), counters, int(iters)), got


@pytest.mark.parametrize("integrator", ["mis", "nee", "brdf_only"])
def test_pool_matches_jax_many_spheres_580(integrator):
    """The composed pool on the 580-sphere field (8x8, 2 spp, depth 4, 64
    slots) against the JAX composed pool (its CPU default route)."""
    (img, counters, iters), (timg, tcounters, titers) = _render_both(
        jax_scenes.many_spheres(n_per_side=12), jax_scenes.many_spheres_camera(8, 8),
        width=8, height=8, spp=2, integrator=integrator, max_bounces=4, num_slots=64, seed=1)
    assert pool.ray_count(tcounters) == jax_pool.ray_count(counters)
    assert pool.busy_count(tcounters) == jax_pool.busy_count(counters)
    assert titers == iters
    assert_images_match(timg.numpy(), img)
    if integrator == "mis":   # the counts measured for the JAX pool
        assert (pool.ray_count(tcounters), titers) == (414, 16)


@pytest.mark.parametrize("integrator", ["mis", "nee", "brdf_only"])
def test_pool_matches_jax_pallas_interpret_580(integrator):
    """The same frame at seed 7 against the JAX composed pool under
    ``method="pallas_interpret"``: its clustered kernels in interpret mode,
    which share the kernels' ``|c|^2 - r^2`` sphere form. Equal rays, busy
    slots and iterations."""
    (img, counters, iters), (timg, tcounters, titers) = _render_both(
        jax_scenes.many_spheres(n_per_side=12), jax_scenes.many_spheres_camera(8, 8),
        width=8, height=8, spp=2, integrator=integrator, max_bounces=4, num_slots=64, seed=7,
        jax_method="pallas_interpret")
    assert pool.ray_count(tcounters) == jax_pool.ray_count(counters)
    assert pool.busy_count(tcounters) == jax_pool.busy_count(counters)
    assert titers == iters
    assert_images_match(timg.numpy(), img)


@pytest.mark.parametrize("integrator", ["mis", "nee", "brdf_only"])
def test_wave_matches_jax_many_spheres_580(integrator):
    """``trace_wave`` on the 580-sphere field at 8x8, 64 bounces: exactly
    the JAX wave engine's ray-query count."""
    jsc, jcam = jax_scenes.many_spheres(n_per_side=12), jax_scenes.many_spheres_camera(8, 8)
    W, H = 8, 8
    pixel = np.arange(W * H)
    jk = jax_rng.pixel_sample_keys(jax_rng.base_key(1), jnp.asarray(pixel, jnp.int32),
                                   jnp.zeros(W * H, jnp.int32))
    tk = rng.pixel_sample_keys(rng.base_key(1), torch.from_numpy(pixel).long(),
                               torch.zeros(W * H, dtype=torch.int64))
    jo, jd = jcam.generate_rays(jnp.asarray(pixel % W), jnp.asarray(H - 1 - pixel // W),
                                jax_rng.primary_jitter(jk))
    want = jax_integrators.trace_wave(jsc, jo, jd, jk, integrator=integrator,
                                      return_stats=True, max_bounces=64)
    tsc = scene_from_arrays(*split_fields(jsc), device="cpu")
    cam = camera_from_arrays(*split_fields(jcam), device="cpu")
    tp = torch.from_numpy(pixel)
    o, d = cam.generate_rays(tp % W, H - 1 - tp // W, rng.primary_jitter(tk), transposed=False)
    got = integrators.trace_wave(tsc, o, d, tk, integrator=integrator, return_stats=True,
                                 max_bounces=64)
    assert got[1] == int(want[1]) == WAVE_QUERIES[integrator]
    assert_images_match(got[0].numpy(), np.asarray(want[0]))


def test_render_and_cli_past_512_spheres(monkeypatch, tmp_path):
    """``render`` under every method, and the CLI's ``render`` through both
    engines, on the 580-sphere field (the CLI's many-spheres scene made
    bigger for the test)."""
    sc = scenes.many_spheres(n_per_side=12, device="cpu")
    cam = scenes.many_spheres_camera(6, 4, device="cpu")
    images = [render(sc, cam, RenderConfig(width=6, height=4, spp=1, max_bounces=8,
                                           method=m)).image for m in METHODS]
    for m, img in zip(METHODS, images):
        assert torch.equal(img, images[0]), m
    monkeypatch.setattr(scenes, "many_spheres",
                        functools.partial(scenes.many_spheres, n_per_side=12))
    for engine in ("wave", "pool"):
        out = tmp_path / f"{engine}.png"
        assert cli.main(["render", "--scene", "many-spheres", "--engine", engine, "--width", "6",
                         "--height", "4", "--spp", "1", "--max-bounces", "4", "--device", "cpu",
                         "--out", str(out)]) == 0
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
