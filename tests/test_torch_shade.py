"""The port's shading and shadow twins against the JAX package's Pallas
kernels, run as the JAX tests run them on the CPU (interpret mode).

Inputs are lane states made with numpy from a seed, fed identically to both.
Tolerances, and why:

* Cornell (roughest lobe 0.3): discrete outputs (``live``, ``shade``) are
  exact; floats agree to rtol 1e-4 / atol 1e-5. ``next_pdf`` of glass lanes
  near grazing transmission is the exception, held to rtol 1e-3 with at most
  1% of lanes past 1e-4: XLA on the CPU contracts multiply-adds into FMAs and
  its f32 sqrt is not correctly rounded, and the transmission Jacobian
  ``|o.h| / (eta i.h + o.h)^2`` amplifies those last-ulp differences
  (measured on 2048 such lanes: 15 past 1e-4, worst 8.2e-4).
* many_spheres has 0.02-rough glass, whose GGX lobe is f32-chaotic (see
  ``tests/test_fused.py``): discrete outputs agree on >= 99.9% of lanes and
  the 99th percentile of the relative error over all consumed float outputs
  is <= 1e-3.
* the ON/PBR scene of ``tests/test_fused.py`` (Oren-Nayar ground, PBR and
  mirror spheres, every lobe at least 0.3 rough), with the Oren-Nayar and
  PBR lanes on: the Cornell bounds, but up to 2% of lanes may have a
  ``next_pdf``, and the ``next_prefix`` divided by it, past 1e-4 (measured
  13 of 1024, worst 3.2e-4 relative, for each integrator; the prefix 2
  lanes, 2.0e-4): the PBR pdf blends the GGX pdf, which amplifies the
  FMA and sqrt differences as the glass Jacobian does, and the Oren-Nayar
  lane adds ``atan2`` and ``cos``, which torch and XLA round differently on
  the CPU.

A float output is compared on the lanes where the pool consumes it: the NEE
gain and the shadow ray only on live lanes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.models import scenes as jax_scenes  # noqa: E402
from pathtrace_tpu.ops import pallas_intersect, pallas_shade  # noqa: E402
from pathtrace_tpu.ops.intersect import _round_tile  # noqa: E402
from pathtrace_tpu_torch.convert import scene_from_arrays, split_fields  # noqa: E402
from pathtrace_tpu_torch.ops import shade  # noqa: E402

S = 1024
CONSUMED_ON_LIVE = ("nee_gain", "shadow_d")
def _on_pbr_scene():
    """The ON/PBR scene of ``tests/test_fused.py``, built by the JAX builder."""
    from pathtrace_tpu.models import materials as jm
    from pathtrace_tpu.models.scene import SceneBuilder as JaxBuilder

    b = JaxBuilder()
    b.add_quad((-20, 0, -20), (20, 0, -20), (20, 0, 20), (-20, 0, 20),
               jm.OrenNayar((0.6, 0.55, 0.5), 0.5))
    b.add_sphere((0.0, 1.0, -3.0), 1.0, jm.PBRMaterial((0.7, 0.3, 0.3), roughness=0.4,
                                                       metallic=0.0))
    b.add_sphere((-2.2, 1.0, -3.0), 1.0, jm.PBRMaterial((0.9, 0.8, 0.4), roughness=0.35,
                                                        metallic=1.0))
    b.add_sphere((2.2, 1.0, -3.0), 1.0, jm.Mirror(roughness=0.4, metallic=1.0))
    b.add_sphere((4.0, 1.0, -5.0), 1.0, jm.Lambertian((0.3, 0.5, 0.7)))
    b.add_sphere((0.0, 6.0, -3.0), 1.5, jm.Emissive((12.0, 12.0, 12.0)))
    b.add_triangle((-3.0, 5.0, -1.0), (-1.0, 5.0, -1.0), (-2.0, 5.0, -2.0),
                   jm.Emissive((8.0, 8.0, 8.0)))
    return b.build()


SCENES = {
    "cornell": (jax_scenes.cornell_box, {}, [-1.0, -1.0, -3.0], [1.0, 1.0, -1.0]),
    "many": (jax_scenes.many_spheres, {"n_per_side": 3}, [-4.0, 0.05, -4.0], [4.0, 3.0, 4.0]),
    "on_pbr": (_on_pbr_scene, {}, [-3.0, 0.05, -6.0], [3.0, 4.0, 2.0]),
}


def _lanes(seed, lo, hi, n=S):
    """Lane states: random origins in the scene's box, unit directions, a mix
    of depths (some past the RR max depth), etas and pdfs."""
    g = np.random.default_rng(seed)
    o = g.uniform(lo, hi, (n, 3)).astype(np.float32).T.copy()
    d = g.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32).T.copy()
    busy = g.random(n) < 0.9
    bounce = g.integers(0, 8, n).astype(np.int32)
    bounce[: n // 8] = g.integers(45, 60, n // 8)
    eta = g.choice(np.float32([1.0, 1 / 1.5, 1.5]), n).astype(np.float32)
    pdf = g.uniform(0.05, 5.0, n).astype(np.float32)
    pfx = g.uniform(0.0, 1.0, (3, n)).astype(np.float32)
    u = g.random((9, n), dtype=np.float32)
    return busy, bounce, o, d, eta, pdf, pfx, u


def _both(name, integrator, seed=0, has_pbr=None):
    """The JAX kernel and the port's twin on the same lanes; ``has_pbr``
    overrides the scene's flag in both."""
    build, kw, lo, hi = SCENES[name]
    jsc = build(**kw)
    if has_pbr is not None:
        jsc = jsc.replace(has_pbr=has_pbr)
    tsc = scene_from_arrays(*split_fields(jsc), device="cpu")
    args = _lanes(seed, lo, hi)
    ref = pallas_shade.fused_bounce(
        pallas_shade.build_tables(jsc), *(jnp.asarray(a) for a in args),
        num_tris=jsc.tri_v0.shape[0], num_lights=jsc.num_lights,
        integrator=integrator, max_bounces=6, eps=shade.EPS,
        has_on=jsc.has_oren_nayar, has_pbr=jsc.has_pbr,
        has_tri_lights=jsc.has_tri_lights, has_sph_lights=jsc.has_sph_lights,
        transposed=True, interpret=True,
    )
    got = shade.fused_bounce_reference(
        shade.build_tables(tsc), *(torch.from_numpy(a) for a in args),
        num_tris=tsc.tri_v0.shape[0], num_lights=tsc.num_lights,
        integrator=integrator, max_bounces=6,
        has_tri_lights=tsc.has_tri_lights, has_sph_lights=tsc.has_sph_lights,
        has_oren_nayar=tsc.has_oren_nayar, has_pbr=tsc.has_pbr,
    )
    return ref, got


def _consumed(ref, got, field):
    """Float output pair, restricted to the lanes where the pool uses it."""
    a = np.asarray(getattr(ref, field))
    b = getattr(got, field).numpy()
    if field in CONSUMED_ON_LIVE:
        live = np.asarray(ref.live)
        a, b = a[..., live], b[..., live]
    return a, b


FLOAT_FIELDS = [f for f in shade.BounceResult._fields if f not in ("live", "shade")]


@pytest.mark.parametrize("integrator", ["mis", "nee", "brdf_only"])
def test_fused_bounce_twin_cornell(integrator):
    ref, got = _both("cornell", integrator)
    for field in ("live", "shade"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(ref, field)))
    for field in FLOAT_FIELDS:
        a, b = _consumed(ref, got, field)
        assert b.shape == a.shape and b.dtype == np.float32, field
        if field == "next_pdf":
            np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-5, err_msg=field)
            assert (~np.isclose(b, a, rtol=1e-4, atol=1e-5)).mean() <= 0.01
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=field)


@pytest.mark.parametrize("integrator", ["mis", "nee", "brdf_only"])
def test_fused_bounce_twin_many_spheres(integrator):
    ref, got = _both("many", integrator)
    for field in ("live", "shade"):
        agree = getattr(got, field).numpy() == np.asarray(getattr(ref, field))
        assert agree.mean() >= 0.999, field
    errs = []
    for field in FLOAT_FIELDS:
        a, b = _consumed(ref, got, field)
        assert np.isfinite(b).all(), field
        errs.append((np.abs(b - a) / np.maximum(np.abs(a), 1.0)).ravel())
    assert np.quantile(np.concatenate(errs), 0.99) <= 1e-3


@pytest.mark.parametrize("integrator", ["mis", "nee", "brdf_only"])
def test_fused_bounce_twin_on_pbr(integrator):
    """The Oren-Nayar and PBR lanes of the twin against the JAX kernel's."""
    ref, got = _both("on_pbr", integrator)
    tables = pallas_shade.build_tables(SCENES["on_pbr"][0]())
    kinds = set(np.asarray(tables.sph)[:, 5].tolist()) | set(np.asarray(tables.tri)[:, 12].tolist())
    assert {3.0, 4.0} <= kinds                            # KIND_OREN_NAYAR, KIND_PBR
    _assert_close_cornell_bounds(ref, got, loose=("next_pdf", "next_prefix"), share=0.02)


def _assert_close_cornell_bounds(ref, got, loose=("next_pdf",), share=0.01):
    """Discrete outputs exact; floats to rtol 1e-4 / atol 1e-5, the ``loose``
    ones to rtol 1e-3 with at most ``share`` of lanes past 1e-4."""
    for field in ("live", "shade"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(ref, field)))
    for field in FLOAT_FIELDS:
        a, b = _consumed(ref, got, field)
        assert b.shape == a.shape and b.dtype == np.float32, field
        if field in loose:
            np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-5, err_msg=field)
            assert (~np.isclose(b, a, rtol=1e-4, atol=1e-5)).mean() <= share
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=field)


def test_fused_bounce_twin_honours_has_pbr():
    """A scene whose ``has_pbr`` is False (a hand-built JAX ``Scene``'s
    default) shades its PBR rows as Lambert, in the JAX kernel and in the
    twin alike; with the flag the PBR lane changes those lanes."""
    ref, got = _both("on_pbr", "mis", has_pbr=False)
    _assert_close_cornell_bounds(ref, got)
    _, on = _both("on_pbr", "mis")
    assert not torch.equal(got.next_prefix, on.next_prefix)


def test_build_tables_exact():
    for build, kw, _, _ in SCENES.values():
        jsc = build(**kw)
        want = pallas_shade.build_tables(jsc)
        got = shade.build_tables(scene_from_arrays(*split_fields(jsc), device="cpu"))
        for name in ("sph", "tri", "lgt"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)


def _shadow_queries(name):
    """Real shadow rays: the NEE rays of a bounce of random lane states, plus
    lanes with no query (t_max < eps)."""
    build, kw, lo, hi = SCENES[name]
    tsc = scene_from_arrays(*split_fields(build(**kw)), device="cpu")
    tables = shade.build_tables(tsc)
    args = [torch.from_numpy(a) for a in _lanes(7, lo, hi)]
    args[0][:] = True
    res = shade.fused_bounce_reference(
        tables, *args, num_tris=tsc.tri_v0.shape[0], num_lights=tsc.num_lights,
        integrator="mis", max_bounces=6,
        has_tri_lights=tsc.has_tri_lights, has_sph_lights=tsc.has_sph_lights)
    return build(**kw), tables, res.next_o, res.shadow_d, res.shadow_tmax


@pytest.mark.parametrize("name", sorted(SCENES))
def test_shadow_twin_matches_any_hit(name):
    """Equal masks to the JAX CPU pool's shadow route (``occluded_transposed``
    -> ``pallas_intersect.any_hit``, one tile per class)."""
    jsc, tables, o, d, tmax = _shadow_queries(name)
    t_rows, s_rows = jsc.tri_v0.shape[0], jsc.sph_center.shape[0]
    want = pallas_intersect.any_hit(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), shade.EPS, jnp.asarray(tmax.numpy()),
        jsc.sph_center, jsc.sph_radius, jsc.tri_v0, jsc.tri_e1, jsc.tri_e2,
        sph_prim_tile=_round_tile(s_rows, 8), tri_prim_tile=_round_tile(t_rows, 8),
        ray_tile=1024, transposed=True, interpret=True,
    )
    got = shade.shadow_any_hit_reference(tables, o, d, tmax)
    assert int(got.sum()) > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_shadow_twin_matches_any_hit_quad(name):
    """Against the TPU route (MXU quad-form any-hit, interval test): at most
    0.1% of lanes differ, the bf16 knife edges."""
    jsc, tables, o, d, tmax = _shadow_queries(name)
    want = pallas_shade.any_hit_quad(
        pallas_shade.build_tables(jsc), jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(tmax.numpy()), eps=shade.EPS, interpret=True)
    got = shade.shadow_any_hit_reference(tables, o, d, tmax)
    assert (got.numpy() != np.asarray(want)).mean() <= 1e-3


def test_wrappers_run_twins_on_cpu_and_check_inputs():
    jsc = jax_scenes.cornell_box()
    tsc = scene_from_arrays(*split_fields(jsc), device="cpu")
    tables = shade.build_tables(tsc)
    args = [torch.from_numpy(a) for a in _lanes(1, [-1, -1, -3], [1, 1, -1], n=64)]
    kw = dict(num_tris=tsc.tri_v0.shape[0], num_lights=tsc.num_lights,
              integrator="mis", max_bounces=6)
    a = shade.fused_bounce(tables, *args, **kw)
    b = shade.fused_bounce_reference(tables, *args, **kw)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    occ = shade.shadow_any_hit(tables, a.next_o, a.shadow_d, a.shadow_tmax)
    assert torch.equal(occ, shade.shadow_any_hit_reference(tables, a.next_o, a.shadow_d,
                                                           a.shadow_tmax))
    assert shade.LAUNCHES["fused_bounce"] == 0   # twins are not launches
    bad = list(args)
    bad[3] = bad[3].double()
    with pytest.raises(ValueError, match="ray_d"):
        shade.fused_bounce(tables, *bad, **kw)
    bad = list(args)
    bad[2] = bad[2].T.contiguous().T            # (3, S) but not contiguous
    with pytest.raises(ValueError, match="ray_o"):
        shade.fused_bounce(tables, *bad, **kw)
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError):
        shade.fused_bounce(shade.Tables(*(t.to("meta") for t in tables)), *meta, **kw)
    with pytest.raises(ValueError, match="integrator"):
        shade.fused_bounce(tables, *args, **dict(kw, integrator="path"))
