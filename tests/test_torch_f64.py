"""The port in float64, the reference's native precision, against the JAX
package in float64.

x64 is a process-global switch in JAX, so every JAX float64 reference of
this module comes from ONE subprocess (the module fixture ``jax64``) that
writes an ``.npz``; the comparisons run here, on the port's CPU twins.
Tolerances, and why:

* the threefry draws and the widened scenes are bitwise (the same integer
  arithmetic; widening float32 is exact);
* ``fused_bounce_reference`` against the JAX ``fused_bounce`` (Pallas
  interpret mode, its VPU form): discrete outputs exact, floats within
  1e-12 relative (of ``max(|a|, 1)``): in float64 the only differences left
  are XLA's contracted multiply-adds and its non-correctly-rounded sqrt,
  ~1e-16 a step. One exception, ``next_pdf`` on lanes that hit
  many_spheres' 0.02-rough glass, held to 1e-7: its GGX lobe (alpha^2 =
  1.6e-7) turns the ~1e-14 the two packages' sampled half vectors differ by
  into up to 4.1e-8 of the pdf (measured on 8 of 256 lanes; the prefix,
  where the lobe cancels, stays within 1e-15);
* the shadow, small closest-hit and any-hit twins against the JAX kernels
  in interpret mode: masks, prim ids and materials exact; a triangle's t
  exact, a sphere's within 1e-12 relative: the root's ``|c|^2 - r^2`` form
  cancels in ``o.o - 2 c.o + k`` near the sphere, so an FMA XLA contracts
  moves the root by up to ~10^3 ulps (measured 1,360 ulps, 2.4e-13);
* whole renders: equal rays and iterations and ``max_rel <= 1e-9``, the
  bound of ``tests/test_fused.py``'s float64 check (the port's pool against
  its own wave engine: ``1e-6``, as ``tests/test_pool.py`` holds the JAX
  pool to its wave engine).

The flat and bvh routes in float64 are held in
``tests/test_torch_f64_routes.py``, the binned and resident routes in
``tests/test_torch_f64_traversals.py``; here, that every route runs
float64 (:func:`test_f64_refused_without_kernels`, named for the refusal it
replaced).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import importlib  # noqa: E402

from pathtrace_tpu_torch import cli, pool  # noqa: E402
from pathtrace_tpu_torch.models import scenes  # noqa: E402
from pathtrace_tpu_torch.ops import intersect, shade  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402

render = importlib.import_module("pathtrace_tpu_torch.render")   # the module, not the function
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
S = 256
W = H = 12

JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp
from pathtrace_tpu import pool
from pathtrace_tpu.models import scenes
from pathtrace_tpu.ops import pallas_intersect, pallas_shade
from pathtrace_tpu.ops.intersect import _round_tile
from pathtrace_tpu.render import cast_floats
from pathtrace_tpu.utils import rng

f64 = jnp.float64
z = dict(np.load(sys.argv[1]))
out = {}
keys = rng.pixel_sample_keys(rng.base_key(3), jnp.asarray(z["px"], jnp.int32),
                             jnp.asarray(z["sample"], jnp.int32))
out["u_pool"] = pool._per_slot_uniforms(keys, jnp.asarray(z["bounce"], jnp.int32), f64,
                                        transposed=True)
out["u_wave"] = rng.bounce_uniforms(keys, 5, dtype=f64)
out["jitter"] = rng.primary_jitter(keys, dtype=f64)
for name, sc in (("cornell", scenes.cornell_box()),
                 ("many", scenes.many_spheres(n_per_side=3))):
    sc = cast_floats(sc, f64)
    for f in ("tri_v0", "tri_normal", "tri_mat", "sph_center", "sph_radius", "mat_kind",
              "mat_color", "mat_ior", "light_prims", "light_geom", "tri_cluster_min"):
        out[f"cast_{name}_{f}"] = getattr(sc, f)
    lanes = [jnp.asarray(z[f"{name}_{k}"]) for k in
             ("busy", "bounce", "o", "d", "eta", "pdf", "pfx", "u")]
    res = pallas_shade.fused_bounce(
        pallas_shade.build_tables(sc), *lanes, num_tris=sc.tri_v0.shape[0],
        num_lights=sc.num_lights, integrator="mis", max_bounces=6, eps=1e-3,
        has_on=sc.has_oren_nayar, has_pbr=sc.has_pbr, has_tri_lights=sc.has_tri_lights,
        has_sph_lights=sc.has_sph_lights, transposed=True, interpret=True)
    for f, v in zip(res._fields, res):
        out[f"fused_{name}_{f}"] = v
    tiles = dict(sph_prim_tile=_round_tile(sc.sph_center.shape[0], 8),
                 tri_prim_tile=_round_tile(sc.tri_v0.shape[0], 8), ray_tile=256,
                 interpret=True)
    geo = (sc.sph_center, sc.sph_radius, sc.tri_v0, sc.tri_e1, sc.tri_e2)
    out[f"shadow_{name}"] = pallas_intersect.any_hit(
        res.next_o, res.shadow_d, 1e-3, res.shadow_tmax, *geo, transposed=True, **tiles)
    rays = [jnp.asarray(z[f"{name}_{k}"]) for k in ("ro", "rd", "lo", "hi")]
    small = pallas_intersect.combined_closest_small(
        *rays, sc.sph_center, sc.sph_radius, sc.sph_mat, sc.tri_v0, sc.tri_e1, sc.tri_e2,
        sc.tri_normal, sc.tri_mat, sc.tri_v0.shape[0], interpret=True, ray_tile=256)
    for k, v in zip(("t", "prim", "n", "m"), small):
        out[f"small_{name}_{k}"] = v
    out[f"anyhit_{name}"] = pallas_intersect.any_hit(*rays, *geo, **tiles)
W = H = 12
img, c, it = pool.render_pool(scenes.cornell_box(), scenes.cornell_camera(W, H), width=W,
                              height=H, spp=2, num_slots=37, seed=3, max_bounces=8, dtype=f64)
out.update(pool_cornell=img, pool_cornell_rays=pool.ray_count(np.asarray(c)),
           pool_cornell_iters=int(it))
img, c, it = pool.render_pool(scenes.many_spheres(n_per_side=3), scenes.many_spheres_camera(W, H),
                              width=W, height=H, spp=2, num_slots=64, seed=5, max_bounces=6,
                              dtype=f64, method="pallas_interpret")
out.update(pool_many=img, pool_many_rays=pool.ray_count(np.asarray(c)), pool_many_iters=int(it))
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""

SCENE_BOXES = {"cornell": ([-1.0, -1.0, -3.0], [1.0, 1.0, -1.0]),
               "many": ([-4.0, 0.05, -4.0], [4.0, 3.0, 4.0])}


def _port_scene(name):
    if name == "cornell":
        return scenes.cornell_box(device="cpu")
    return scenes.many_spheres(n_per_side=3, device="cpu")


def _inputs():
    """The lanes and rays both packages get, float64, made with numpy from a
    seed: lane states in kernel layout, and (N, 3) rays with t_max inf or
    random."""
    g = np.random.default_rng(0)
    z = {"px": np.arange(600) * 7919 % 100000, "sample": np.arange(600) % 13,
         "bounce": np.arange(600) % 40}
    for name, (lo, hi) in SCENE_BOXES.items():
        o = g.uniform(lo, hi, (S, 3))
        d = g.normal(size=(S, 3))
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        bounce = g.integers(0, 8, S).astype(np.int32)
        bounce[: S // 8] = g.integers(45, 60, S // 8)
        z.update({f"{name}_busy": g.random(S) < 0.9, f"{name}_bounce": bounce,
                  f"{name}_o": o.T.copy(), f"{name}_d": d.T.copy(),
                  f"{name}_eta": g.choice([1.0, 1 / 1.5, 1.5], S),
                  f"{name}_pdf": g.uniform(0.05, 5.0, S),
                  f"{name}_pfx": g.uniform(0.0, 1.0, (3, S)), f"{name}_u": g.random((9, S))})
        hi_t = np.full(S, np.inf)
        hi_t[::5] = g.uniform(0.1, 3.0, S)[::5]
        z.update({f"{name}_ro": g.uniform(lo, hi, (S, 3)), f"{name}_rd": d[::-1].copy(),
                  f"{name}_lo": np.full(S, shade.EPS), f"{name}_hi": hi_t})
    return z


@pytest.fixture(scope="module")
def jax64(tmp_path_factory):
    """The JAX float64 references, from one subprocess (x64 is global)."""
    tmp = tmp_path_factory.mktemp("f64")
    z = _inputs()
    np.savez(tmp / "in.npz", **z)
    subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.npz"), str(tmp / "out.npz")],
                   cwd=REPO, check=True, capture_output=True, text=True, timeout=300,
                   env={**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"})
    return z, dict(np.load(tmp / "out.npz"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1.0)))


def _keys(z):
    return rng.pixel_sample_keys(rng.base_key(3), _t(z["px"]), _t(z["sample"]))


def test_f64_draws_bitwise(jax64):
    """The float64 draw takes both threefry words, as JAX's: bitwise, in the
    pool's, the wave engine's and the jitter's layout."""
    z, want = jax64
    keys = _keys(z)
    got = {"u_pool": rng.per_slot_uniforms(keys, _t(z["bounce"]), F64),
           "u_wave": rng.bounce_uniforms(keys, 5, F64), "jitter": rng.primary_jitter(keys, F64)}
    for k, v in got.items():
        assert v.dtype == F64
        np.testing.assert_array_equal(v.numpy().view(np.int64), want[k].view(np.int64), k)
    assert 0.0 <= float(got["u_pool"].min()) and float(got["u_pool"].max()) < 1.0


def test_f32_draw_unchanged(jax64):
    """The float32 draw is unchanged: the top 23 bits of the two words' XOR
    as a mantissa in [1, 2), minus 1, bit for bit."""
    z, _ = jax64
    keys = _keys(z)
    k0, k1 = rng.fold_in(keys, _t(z["bounce"]))
    slots = torch.arange(rng.NUM_SLOTS)[:, None]
    b0, b1 = rng.threefry2x32(k0[None], k1[None], torch.zeros_like(slots), slots)
    want = (((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    got = rng.per_slot_uniforms(keys, _t(z["bounce"]))
    assert got.dtype == torch.float32 and torch.equal(got, want)
    with pytest.raises(ValueError, match="float32 or float64"):
        rng.per_slot_uniforms(keys, _t(z["bounce"]), torch.float16)


@pytest.mark.parametrize("name", ["cornell", "many"])
def test_cast_floats_matches_jax(jax64, name):
    """``cast_floats`` widens every floating field and leaves the integer
    ones alone: bitwise the JAX ``cast_floats`` of the same scene."""
    _, want = jax64
    sc = render.cast_floats(_port_scene(name), F64)
    for key in [k for k in want if k.startswith(f"cast_{name}_")]:
        f = key[len(f"cast_{name}_"):]
        got = getattr(sc, f)
        assert str(got.dtype)[6:] == str(want[key].dtype), f
        np.testing.assert_array_equal(got.numpy(), want[key], f)
    cam = render.cast_floats(scenes.cornell_camera(W, H, device="cpu"), "f64")
    assert cam.origin.dtype == F64 and (cam.width, cam.height) == (W, H)
    state = render.cast_floats(render.RenderState(torch.zeros(2, 2, 3), 3, 7), F64)
    assert state.image_sum.dtype == F64 and (state.num_samples, state.ray_queries) == (3, 7)
    with pytest.raises(ValueError, match="float32 or float64"):
        render.cast_floats(sc, torch.float16)


def _lanes(z, name):
    return [_t(z[f"{name}_{k}"]) for k in
            ("busy", "bounce", "o", "d", "eta", "pdf", "pfx", "u")]


@pytest.mark.parametrize("name", ["cornell", "many"])
def test_fused_bounce_twin_f64(jax64, name):
    """``fused_bounce_reference`` in float64 against the JAX kernel in
    float64 (interpret mode): discrete outputs exact, floats to 1e-12."""
    z, want = jax64
    sc = render.cast_floats(_port_scene(name), F64)
    tables = shade.build_tables(sc)
    assert all(t.dtype == F64 for t in tables)
    got = shade.fused_bounce(
        tables, *_lanes(z, name), num_tris=sc.tri_v0.shape[0], num_lights=sc.num_lights,
        integrator="mis", max_bounces=6, has_tri_lights=sc.has_tri_lights,
        has_sph_lights=sc.has_sph_lights, has_oren_nayar=sc.has_oren_nayar, has_pbr=sc.has_pbr)
    live = want[f"fused_{name}_live"]
    assert 0 < live.sum() < S
    # Lanes that hit a near-delta GGX lobe (the 0.02-rough glass).
    tables = intersect.build_tables(sc)
    _, prim, _, mat = intersect.combined_closest_small_reference(
        tables, _t(z[f"{name}_o"].T), _t(z[f"{name}_d"].T), torch.full((S,), shade.EPS,
                                                                       dtype=F64),
        torch.full((S,), float("inf"), dtype=F64))
    sharp = ((prim >= 0) & (sc.mat_roughness[mat.long()] < 0.05)).numpy()
    for f, v in zip(got._fields, got):
        w = want[f"fused_{name}_{f}"]
        if v.dtype == torch.bool:
            np.testing.assert_array_equal(v.numpy(), w, f)
            continue
        assert v.dtype == F64, f
        a, b = (w[..., live], v.numpy()[..., live]) if f in ("nee_gain", "shadow_d") else (w, v)
        if f == "next_pdf":
            assert _max_rel(a[sharp], b[sharp]) <= 1e-7 if sharp.any() else True
            a, b = a[~sharp], b[~sharp]
        assert _max_rel(a, b) <= 1e-12, (f, _max_rel(a, b))


@pytest.mark.parametrize("name", ["cornell", "many"])
def test_intersection_twins_f64(jax64, name):
    """The float64 shadow twin against the JAX ``any_hit`` (transposed), and
    the small route's ``combined_closest_small``/``any_hit`` twins against
    the JAX kernels (interpret mode): masks, prim ids and materials exact, a
    triangle's t exact and a sphere's to 1e-12 (module docstring), normals
    to 1e-12."""
    z, want = jax64
    sc = render.cast_floats(_port_scene(name), F64)
    ft = shade.build_tables(sc)
    so, sd, st = (_t(want[f"fused_{name}_{f}"]) for f in ("next_o", "shadow_d", "shadow_tmax"))
    occ = shade.shadow_any_hit(ft, so, sd, st)
    np.testing.assert_array_equal(occ.numpy(), want[f"shadow_{name}"])
    assert 0 < int(occ.sum())

    tables = intersect.build_tables(sc)
    assert tables.route == "small" and tables.tri.dtype == tables.sph.dtype == F64
    o, d, lo, hi = (_t(z[f"{name}_{k}"]) for k in ("ro", "rd", "lo", "hi"))
    t, prim, n, m = intersect.combined_closest_small(tables, o, d, lo, hi)
    np.testing.assert_array_equal(prim.numpy(), want[f"small_{name}_prim"])
    np.testing.assert_array_equal(m.numpy(), want[f"small_{name}_m"])
    assert t.dtype == n.dtype == F64 and int((prim >= 0).sum()) > S // 4
    tri = ((prim >= 0) & (prim < tables.tri_rows)).numpy()
    np.testing.assert_array_equal(t.numpy()[~tri & (prim.numpy() < 0)], np.inf)
    np.testing.assert_array_equal(t.numpy()[tri], want[f"small_{name}_t"][tri])
    sph = (prim >= tables.tri_rows).numpy()
    assert sph.any() and _max_rel(want[f"small_{name}_t"][sph], t.numpy()[sph]) <= 1e-12
    assert _max_rel(want[f"small_{name}_n"], n) <= 1e-12
    blocked = intersect.any_hit(tables.sph, tables.tri[:tables.tri_rows], o, d, lo, hi)
    np.testing.assert_array_equal(blocked.numpy(), want[f"anyhit_{name}"])
    assert 0 < int(blocked.sum()) < S


@pytest.mark.parametrize("name", ["cornell", "many"])
def test_render_pool_f64_matches_jax(jax64, name):
    """``render_pool(dtype=float64)`` against the JAX pool in float64: Cornell
    against its CPU default (the composed branch), many_spheres(3) against
    its fused kernel under ``pallas_interpret``: equal rays and iterations,
    ``max_rel <= 1e-9``."""
    _, want = jax64
    if name == "cornell":
        sc, cam = scenes.cornell_box(device="cpu"), scenes.cornell_camera(W, H, device="cpu")
        kw = dict(num_slots=37, seed=3, max_bounces=8)
    else:
        sc, cam = (scenes.many_spheres(n_per_side=3, device="cpu"),
                   scenes.many_spheres_camera(W, H, device="cpu"))
        kw = dict(num_slots=64, seed=5, max_bounces=6)
    assert pool.route(sc, "mis") == "fused"
    img, counters, iters = pool.render_pool(sc, cam, width=W, height=H, spp=2, dtype=F64, **kw)
    assert img.dtype == F64 and counters.dtype == torch.int64
    assert pool.ray_count(counters) == int(want[f"pool_{name}_rays"])
    assert iters == int(want[f"pool_{name}_iters"])
    assert _max_rel(want[f"pool_{name}"], img) <= 1e-9


def test_pool_matches_wave_engine_f64():
    """The port's pool against its own wave engine in float64, sample for
    sample (``tests/test_pool.py``'s float64 check): ``max_rel <= 1e-6``."""
    sc, cam = scenes.cornell_box(device="cpu"), scenes.cornell_camera(W, H, device="cpu")
    wave = render.render(sc, cam, render.RenderConfig(
        width=W, height=H, spp=2, max_bounces=8, seed=3, samples_per_batch=2, dtype=F64))
    img, _, _ = pool.render_pool(sc, cam, width=W, height=H, spp=2, max_bounces=8,
                                 num_slots=37, seed=3, dtype="float64")
    assert wave.image_sum.dtype == img.dtype == F64
    assert _max_rel(wave.image_sum.numpy(), img.reshape(H, W, 3)) <= 1e-6
    assert float(img.sum()) > 0


@pytest.mark.parametrize("engine", ["pool", "wave"])
def test_cli_renders_f64(tmp_path, capsys, engine):
    """``render --dtype f64`` on both engines: the checkpoint holds a float64
    sum, resumes as float64, and equals the library's float64 render."""
    ckpt = str(tmp_path / "s.npz")
    common = ["render", "--scene", "cornell", "--width", "6", "--height", "6", "--max-bounces",
              "6", "--engine", engine, "--dtype", "f64", "--device", "cpu", "--checkpoint", ckpt,
              "--out", str(tmp_path / "o.png"), "--samples-per-batch", "1"]
    assert cli.main([*common, "--spp", "1"]) == 0
    assert cli.main([*common, "--spp", "2", "--resume", "--npy", str(tmp_path / "i.npy")]) == 0
    assert "resumed at 1 spp" in capsys.readouterr().err
    z = np.load(ckpt)
    assert z["image_sum"].dtype == np.float64 and int(z["num_samples"]) == 2
    state = render.RenderState.load(ckpt, device="cpu")
    assert state.image_sum.dtype == F64
    assert np.load(str(tmp_path / "i.npy")).dtype == np.float64
    sc, cam = scenes.cornell_box(device="cpu"), scenes.cornell_camera(6, 6, device="cpu")
    if engine == "wave":
        whole = render.render(sc, cam, render.RenderConfig(
            width=6, height=6, spp=2, max_bounces=6, dtype=F64)).image_sum.numpy()
    else:
        whole = sum(pool.render_pool(sc, cam, width=6, height=6, spp=1, max_bounces=6,
                                     sample_offset=k, num_slots=32768, dtype=F64)[0]
                    for k in range(2)).reshape(6, 6, 3).numpy()
    np.testing.assert_array_equal(z["image_sum"], whole)


def test_bench_line_f64():
    """``bench --dtype f64`` renders the bench frame in float64 and says so
    in its line (an 8x8 frame here: the record, not the speed)."""
    from pathtrace_tpu_torch import bench

    scene, camera, frame = bench.setup("cpu", dtype=F64)
    assert frame["dtype"] == F64 and "dtype" not in bench.setup("cpu")[2]
    frame = dict(frame, width=8, height=8, num_slots=64)
    record = bench.timed(scene, scenes.many_spheres_camera(8, 8, device="cpu"), frame)
    assert record["extra"]["dtype"] == "f64" and record["extra"]["total_rays"] > 64


@pytest.mark.parametrize("call", ["render_pool", "render", "intersect", "wrappers"])
def test_f64_refused_without_kernels(call):
    """float64 on the binned and resident routes, which refused it before
    their kernels had float64 instances, now runs: the routes of
    ``mesh_scene(4200)`` through the pool and the wave engine give the
    brute-force route's float64 image bit for bit, ``build_tables`` builds
    their tables in float64 and ``intersect``/``occluded`` on them equal the
    twins, and the binned and resident wrappers return float64 results equal
    to the brute-force twins, all on the CPU."""
    if call in ("render_pool", "render"):
        sc = scenes.mesh_scene(4200, device="cpu")
        cam = scenes.mesh_scene_camera(4, 4, device="cpu")

        def run(method):
            if call == "render_pool":
                img, counters, iters = pool.render_pool(sc, cam, width=4, height=4, spp=1,
                                                        dtype=F64, method=method)
                return img, pool.ray_count(counters), iters
            st = render.render(sc, cam, render.RenderConfig(width=4, height=4, spp=1, dtype=F64,
                                                            method=method))
            return st.image_sum, st.ray_queries, st.num_samples

        want = run("bruteforce")
        assert want[0].dtype == F64 and want[1] > 16
        for method in ("binned", "resident"):
            got = run(method)
            assert got[1:] == want[1:] and torch.equal(got[0], want[0])
        return
    sc = render.cast_floats(scenes.mesh_scene(300, device="cpu"), F64)
    g = np.random.default_rng(4)
    o = torch.tensor(g.uniform(-2.0, 2.0, (64, 3)) + [0.0, 1.0, 4.0])
    d = torch.tensor(g.normal(size=(64, 3))) * 0.1 + torch.tensor([0.0, -0.2, -1.0], dtype=F64)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    lo, hi = torch.full((64,), 1e-3, dtype=F64), torch.full((64,), 9.0, dtype=F64)
    if call == "intersect":
        for method in ("binned", "resident"):
            tables = intersect.build_tables(sc, method)
            assert tables.route == method
            assert all(t.dtype == F64 for t in (tables.tri, tables.leaf, tables.sph))
            h = intersect.intersect(tables, o, d, lo, hi)
            want = intersect.intersect(tables, o, d, lo, hi, twin=True)
            assert h.t.dtype == F64 and (h.prim >= 0).any()
            assert all(torch.equal(a, b) for a, b in zip(h, want))
            occ = intersect.occluded(tables, o, d, lo, hi)
            assert torch.equal(occ, intersect.any_hit_reference(
                tables.sph, tables.tri[:tables.tri_rows], o, d, lo, hi))
        return
    from pathtrace_tpu_torch.ops import binned

    for method, (closest, anyhit) in (
            ("binned", (binned.triangle_closest_binned, binned.triangle_anyhit_binned)),
            ("resident", (intersect.resident_closest, intersect.resident_anyhit))):
        tables = intersect.build_tables(sc, method)
        got = closest(tables, o, d, lo, hi)
        want = intersect.triangle_closest_reference(tables, o, d, lo, hi)
        assert got[0].dtype == got[2].dtype == F64 and (want[1] >= 0).any()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(anyhit(tables, o, d, lo, hi),
                           intersect.bvh_anyhit_reference(tables, o, d, lo, hi))
