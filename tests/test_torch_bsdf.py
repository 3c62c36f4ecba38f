"""The port's BSDF lanes, light sampling and vector helpers against the JAX
package's.

Inputs are made with numpy from a seed and fed identically to both. The
material scene holds one material of every kind (Lambertian, Oren-Nayar, GGX
metal, GGX dielectric, PBR, Emissive), so every lane runs.

Tolerances, and why: both sides run the same float32 formulas, but XLA on
the CPU contracts multiply-adds into FMAs and neither side's CPU sqrt is
correctly rounded, so results differ in the last ulps, which the GGX and
Oren-Nayar chains amplify a little. Floats agree to rtol 2e-4 / atol 1e-5
(measured worst: 4.1e-5 relative, metal sample pdf). Sampling takes the
etas that ``eta_ratio`` yields for ior 1.5 (2/3 and 1.5); at eta = 1 a
dielectric's transmission Jacobian ``1 / (eta i.h + o.h)^2`` divides by ~0
and is chaotic in any precision. Light-sample floats agree to rtol 1e-5 /
atol 1e-4: points lie up to ~60 units out, where a float32 ulp is ~4e-6 and
a coordinate near zero is the difference of such numbers (measured worst:
1.3e-5 absolute on one coordinate of 12288). Pdfs agree to rtol 1e-4: the
triangle lane's ``d^2 / |cos|`` amplifies ulps near grazing (measured
worst: 2.2e-5 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.models import materials as jax_mat  # noqa: E402
from pathtrace_tpu.models import scene as jax_scene  # noqa: E402
from pathtrace_tpu.models import scenes as jax_scenes  # noqa: E402
from pathtrace_tpu.ops import bsdf as jax_bsdf  # noqa: E402
from pathtrace_tpu.ops import lights as jax_lights  # noqa: E402
from pathtrace_tpu.utils import vec as jax_vec  # noqa: E402
from pathtrace_tpu_torch.convert import scene_from_arrays, split_fields  # noqa: E402
from pathtrace_tpu_torch.ops import bsdf, lights  # noqa: E402
from pathtrace_tpu_torch.utils import vec  # noqa: E402

N = 4096
RTOL, ATOL = 2e-4, 1e-5
# Material ids of _material_scene, one per kind.
KINDS = {"lambert": 0, "oren_nayar": 1, "metal": 2, "dielectric": 3, "pbr": 4, "emissive": 5}


def _material_scene():
    b = jax_scene.SceneBuilder()
    b.add_sphere((0, 0, 0), 1, jax_mat.Lambertian((0.7, 0.5, 0.3)))
    b.add_sphere((3, 0, 0), 1, jax_mat.OrenNayar((0.6, 0.6, 0.2), 0.4))
    b.add_sphere((6, 0, 0), 1, jax_mat.Mirror(roughness=0.3, color=(0.9, 0.8, 0.7), metallic=1.0))
    b.add_sphere((9, 0, 0), 1, jax_mat.Mirror(roughness=0.4, metallic=0.0, ior=1.5))
    b.add_sphere((12, 0, 0), 1, jax_mat.PBRMaterial((0.8, 0.4, 0.2), 0.5, metallic=0.3))
    b.add_sphere((15, 0, 0), 1, jax_mat.Emissive((3.0, 3.0, 3.0)))
    jsc = b.build()
    return jsc, scene_from_arrays(*split_fields(jsc))


def _unit(g, n):
    v = g.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _inputs(seed):
    """Shading normals, view directions on their side, any outgoing
    directions, material ids, etas and uniforms."""
    g = np.random.default_rng(seed)
    nrm = _unit(g, N)
    i = _unit(g, N)
    i = np.where((np.sum(i * nrm, axis=1) < 0)[:, None], -i, i).astype(np.float32)
    return dict(
        nrm=nrm, i=i, o=_unit(g, N), mid=g.integers(0, len(KINDS), N).astype(np.int32),
        eta=g.choice(np.float32([1.0, 1 / 1.5, 1.5]), N),
        eta_s=g.choice(np.float32([1 / 1.5, 1.5]), N),
        u=g.random((3, N), dtype=np.float32), front=g.random(N) < 0.5,
    )


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def material_scene():
    return _material_scene()


def test_material_scene_has_every_lane(material_scene):
    jsc, tsc = material_scene
    assert tsc.has_oren_nayar and tsc.has_mirror and tsc.has_pbr
    assert sorted(tsc.mat_kind.tolist()) == [0, 1, 2, 2, 3, 4]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_eval_bsdf(material_scene, kind):
    jsc, tsc = material_scene
    x = _inputs(0)
    m = x["mid"] == KINDS[kind]
    want_b, want_p = jax_bsdf.eval_bsdf(jsc, jnp.asarray(x["mid"]), jnp.asarray(x["i"]),
                                        jnp.asarray(x["eta"]), jnp.asarray(x["o"]),
                                        jnp.asarray(x["nrm"]))
    got_b, got_p = bsdf.eval_bsdf(tsc, _t(x["mid"]), _t(x["i"]), _t(x["eta"]), _t(x["o"]),
                                  _t(x["nrm"]))
    assert m.sum() > 500
    _close(got_b[m], np.asarray(want_b)[m])
    _close(got_p[m], np.asarray(want_p)[m])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sample_bsdf(material_scene, kind):
    jsc, tsc = material_scene
    x = _inputs(1)
    m = x["mid"] == KINDS[kind]
    u = x["u"]
    want = jax_bsdf.sample_bsdf(jsc, jnp.asarray(x["mid"]), jnp.asarray(x["i"]),
                                jnp.asarray(x["eta_s"]), jnp.asarray(x["nrm"]),
                                jnp.asarray(u[0]), jnp.asarray(u[1]), jnp.asarray(u[2]))
    got = bsdf.sample_bsdf(tsc, _t(x["mid"]), _t(x["i"]), _t(x["eta_s"]), _t(x["nrm"]),
                           _t(u[0]), _t(u[1]), _t(u[2]))
    for g, w in zip(got, want):
        _close(g[m], np.asarray(w)[m])


def test_eta_ratio_and_emission(material_scene):
    jsc, tsc = material_scene
    x = _inputs(2)
    np.testing.assert_array_equal(
        bsdf.eta_ratio(tsc, _t(x["mid"]), _t(x["front"])).numpy(),
        np.asarray(jax_bsdf.eta_ratio(jsc, jnp.asarray(x["mid"]), jnp.asarray(x["front"]))))
    mp = bsdf.mat_of(tsc, _t(x["mid"]))
    jmp = jax_bsdf.mat_of(jsc, jnp.asarray(x["mid"]))
    np.testing.assert_array_equal(bsdf.emitted_params(mp).numpy(),
                                  np.asarray(jax_bsdf.emitted_params(jmp)))
    np.testing.assert_array_equal(bsdf.is_emissive_params(mp).numpy(),
                                  np.asarray(jax_bsdf.is_emissive_params(jmp)))


def test_vec_helpers():
    g = np.random.default_rng(5)
    a, n = _unit(g, N), _unit(g, N)
    eta = g.choice(np.float32([1 / 1.5, 1.5]), N)
    r1, r2 = g.random((2, N), dtype=np.float32)
    n[:64] = [0.0, 1.0, 0.0]                  # the tangent frame's +X fallback
    j, t = (jnp.asarray(a), jnp.asarray(n)), (_t(a), _t(n))
    _close(vec.reflect(*t), jax_vec.reflect(*j))
    for got, want in zip(vec.refract(*t, _t(eta)), jax_vec.refract(*j, jnp.asarray(eta))):
        _close(got, want)
    _close(vec.face_forward(*t), jax_vec.face_forward(*j))
    for got, want in zip(vec.tangent_frame(t[1]), jax_vec.tangent_frame(j[1])):
        _close(got, want)
    for name in ("uniform_hemisphere_direction", "cosine_hemisphere_direction"):
        _close(getattr(vec, name)(t[1], _t(r1), _t(r2)),
               getattr(jax_vec, name)(j[1], jnp.asarray(r1), jnp.asarray(r2)))
    _close(vec.vmax(t[0]), jax_vec.vmax(j[0]))
    _close(vec.luminance(t[0]), jax_vec.luminance(j[0]))
    bad = np.float32([[np.inf, -1.0, np.nan]])
    np.testing.assert_array_equal(vec.finite_or_zero(_t(bad)).numpy(),
                                  np.asarray(jax_vec.finite_or_zero(jnp.asarray(bad))))


def _mixed_lights():
    """A triangle light and a sphere light: both light lanes run."""
    b = jax_scene.SceneBuilder()
    b.add_quad((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5), jax_mat.Lambertian((0.5, 0.5, 0.5)))
    b.add_quad((-1, 4, -1), (1, 4, -1), (1, 4, 1), (-1, 4, 1), jax_mat.Emissive((6.0, 6.0, 6.0)))
    b.add_sphere((3.0, 2.0, 0.0), 0.5, jax_mat.Emissive((9.0, 8.0, 7.0)))
    return b.build()


LIGHT_SCENES = {
    "mesh": (lambda: jax_scenes.mesh_scene(4200), [-3.0, -1.0, -3.0], [3.0, 2.0, 3.0]),
    "cornell": (jax_scenes.cornell_box, [-1.0, -1.0, -3.0], [1.0, 1.0, -1.0]),
    "mixed": (_mixed_lights, [-4.0, 0.5, -4.0], [4.0, 3.0, 4.0]),
}


@pytest.mark.parametrize("name", sorted(LIGHT_SCENES))
def test_sample_light_point(name):
    build, lo, hi = LIGHT_SCENES[name]
    jsc = build()
    tsc = scene_from_arrays(*split_fields(jsc))
    g = np.random.default_rng(3)
    p = g.uniform(lo, hi, (N, 3)).astype(np.float32)
    u = g.random((3, N), dtype=np.float32)
    want = jax_lights.sample_light_point(jsc, jnp.asarray(p), *(jnp.asarray(r) for r in u))
    got = lights.sample_light_point(tsc, _t(p), *(_t(r) for r in u))
    assert (tsc.has_tri_lights, tsc.has_sph_lights) == {
        "mesh": (False, True), "cornell": (True, False), "mixed": (True, True)}[name]
    for field in ("point", "normal", "emission", "dir", "dist"):
        _close(getattr(got, field), getattr(want, field), rtol=1e-5, atol=1e-4)
    _close(got.pdf, want.pdf, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(LIGHT_SCENES))
def test_light_pdf_toward(name):
    build, lo, hi = LIGHT_SCENES[name]
    jsc = build()
    tsc = scene_from_arrays(*split_fields(jsc))
    g = np.random.default_rng(4)
    p = g.uniform(lo, hi, (N, 3)).astype(np.float32)
    u = g.random((3, N), dtype=np.float32)
    # Targets: points sampled on the lights, queried by their prim ids.
    ls = lights.sample_light_point(tsc, _t(p), *(_t(r) for r in u))
    idx = np.minimum((u[0] * tsc.num_lights).astype(np.int32), tsc.num_lights - 1)
    prim = tsc.light_prims.numpy()[idx]
    origin = g.uniform(lo, hi, (N, 3)).astype(np.float32)
    want = jax_lights.light_pdf_toward(jsc, jnp.asarray(prim), jnp.asarray(origin),
                                       jnp.asarray(ls.point.numpy()))
    got = lights.light_pdf_toward(tsc, _t(prim), _t(origin), ls.point)
    _close(got, want, rtol=1e-4)
