"""The port's wave engine against the JAX package's on the CPU.

Both start from identical inputs: the JAX scene and camera enter the port
through ``scene_from_arrays``/``camera_from_arrays``, and the threefry keys
are the same words. The JAX side runs its CPU default route (``bruteforce``)
and the port the plain twins of its kernels on the scene's route (small for
Cornell, flat for ``mesh_scene(1000)``). The draws must be bitwise equal;
the traced-ray counts exactly equal; the images within the
``tests/imgutil.py`` knife-edge budget (the twins test spheres in the
kernels' ``|c|^2 - r^2`` form, the JAX CPU route in the ``o - c`` form, and
XLA contracts multiply-adds, so a path at a silhouette may branch apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pathtrace_tpu import integrators as jax_integrators  # noqa: E402
from pathtrace_tpu.models import scenes as jax_scenes  # noqa: E402
from pathtrace_tpu.utils import rng as jax_rng  # noqa: E402
from pathtrace_tpu_torch import integrators  # noqa: E402
from pathtrace_tpu_torch.convert import (  # noqa: E402
    camera_from_arrays,
    scene_from_arrays,
    split_fields,
)
from pathtrace_tpu_torch.models import scenes  # noqa: E402
from pathtrace_tpu_torch.ops import intersect, shade  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402

from .imgutil import assert_images_match  # noqa: E402


def _keys(seed, pixel, sample):
    jk = jax_rng.pixel_sample_keys(jax_rng.base_key(seed), jnp.asarray(pixel, jnp.int32),
                                   jnp.asarray(sample, jnp.int32))
    tk = rng.pixel_sample_keys(rng.base_key(seed), torch.from_numpy(pixel).long(),
                               torch.from_numpy(sample).long())
    return jk, tk


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("bounce", [0, 5, 63])
def test_bounce_uniforms_bitwise(bounce):
    g = np.random.default_rng(bounce)
    pixel = g.integers(0, 2**20, 2048)
    sample = g.integers(0, 5000, 2048)
    jk, tk = _keys(int(g.integers(0, 2**31)), pixel, sample)
    want = jax_rng.bounce_uniforms(jk, bounce)
    got = rng.bounce_uniforms(tk, bounce)
    assert got.shape == (2048, rng.NUM_SLOTS)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(rng.primary_jitter(tk).numpy()),
                                  _bits(jax_rng.primary_jitter(jk)))


@pytest.mark.parametrize("j", [1, 3])
def test_light_sample_keys_bitwise(j):
    """The NEE fold of light sample j: ``fold_in(key, 0x4E4545 + j)`` per ray."""
    g = np.random.default_rng(j)
    jk, tk = _keys(7, g.integers(0, 4096, 512), g.integers(0, 64, 512))
    want = jax.vmap(jax.random.fold_in, in_axes=(0, None))(jk, jax_integrators._NEE_FOLD_BASE + j)
    got = rng.light_sample_keys(tk, j)
    words = np.asarray(jax.random.key_data(want))
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(), words.astype(np.int64))
    assert rng.NEE_FOLD_BASE == jax_integrators._NEE_FOLD_BASE


@pytest.mark.parametrize("name", ["cornell", "mesh"])
def test_primary_rays_n3(name):
    """``(N, 3)`` primary rays: the transpose of the kernel layout bit for
    bit, and within a few ulps of the JAX camera's (XLA contracts a
    multiply-add)."""
    jcam = (jax_scenes.cornell_camera(16, 16) if name == "cornell"
            else jax_scenes.mesh_scene_camera(24, 16))
    cam = camera_from_arrays(*split_fields(jcam), device="cpu")
    g = np.random.default_rng(11)
    px = g.integers(0, jcam.width, 400).astype(np.int32)
    py = g.integers(0, jcam.height, 400).astype(np.int32)
    jit = g.random((400, 2), dtype=np.float32)
    args = (torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(jit))
    o, d = cam.generate_rays(*args, transposed=False)
    o_t, d_t = cam.generate_rays(*args)
    assert o.shape == d.shape == (400, 3) and d.is_contiguous()
    np.testing.assert_array_equal(d.numpy(), d_t.T.numpy())
    jo, jd = jcam.generate_rays(jnp.asarray(px), jnp.asarray(py), jnp.asarray(jit))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    ulps = np.abs(_bits(d.numpy()).astype(np.int64) - _bits(jd).astype(np.int64))
    assert ulps.max() <= 4


def test_sweep_cameras_match_jax():
    for cam, jcam in zip(scenes.sweep_cameras(5, 32, 18, device="cpu"),
                         jax_scenes.sweep_cameras(5, 32, 18)):
        assert (cam.width, cam.height) == (jcam.width, jcam.height)
        for f in ("origin", "lower_left_corner", "horizontal", "vertical"):
            want = np.asarray(getattr(jcam, f))
            ulps = np.abs(_bits(getattr(cam, f).numpy()).astype(np.int64)
                          - _bits(want).astype(np.int64))
            assert ulps.max() <= 1, f


# ---- trace_wave against the JAX wave engine ---------------------------------

def _wave(jsc, jcam, seed=3, sample=0, **kw):
    """One wave over every pixel, traced by both engines from the same keys
    and primary rays: ``((rad, rays), (rad, rays))``."""
    W, H = jcam.width, jcam.height
    pixel = np.arange(W * H)
    jk, tk = _keys(seed, pixel, np.full_like(pixel, sample))
    jo, jd = jcam.generate_rays(jnp.asarray(pixel % W), jnp.asarray(H - 1 - pixel // W),
                                jax_rng.primary_jitter(jk))
    want = jax_integrators.trace_wave(jsc, jo, jd, jk, return_stats=True, **kw)
    tsc = scene_from_arrays(*split_fields(jsc), device="cpu")
    cam = camera_from_arrays(*split_fields(jcam), device="cpu")
    tp = torch.from_numpy(pixel)
    o, d = cam.generate_rays(tp % W, H - 1 - tp // W, rng.primary_jitter(tk), transposed=False)
    before = dict(shade.LAUNCHES)
    got = integrators.trace_wave(tsc, o, d, tk, return_stats=True, **kw)
    assert dict(shade.LAUNCHES) == before            # CPU tensors: twins, no launch
    return (np.asarray(want[0]), int(want[1])), (got[0].numpy(), got[1])


@pytest.mark.parametrize("integrator,nls", [("mis", 1), ("nee", 1), ("brdf_only", 1),
                                            ("mis", 2)])
def test_trace_wave_matches_jax_cornell(integrator, nls):
    """Cornell 16x16, one sample per pixel, 64 bounces: the small route
    (combined_closest_small, any_hit over the spheres and triangles)."""
    (want, want_rays), (got, got_rays) = _wave(
        jax_scenes.cornell_box(), jax_scenes.cornell_camera(16, 16),
        integrator=integrator, max_bounces=64, num_light_samples=nls)
    assert got_rays == want_rays
    assert np.isfinite(got).all() and got.sum() > 0
    assert_images_match(got, want)


@pytest.mark.parametrize("integrator", ["mis", "nee", "brdf_only"])
def test_trace_wave_matches_jax_flat_mesh(integrator):
    """``mesh_scene(1000)`` (992 triangles, 3 spheres) at 8x8: the flat
    route (sphere_closest, then triangle_closest over 4 clusters)."""
    jsc = jax_scenes.mesh_scene(1000)
    tsc = scene_from_arrays(*split_fields(jsc), device="cpu")
    assert intersect.build_tables(tsc).route == "flat"
    (want, want_rays), (got, got_rays) = _wave(
        jsc, jax_scenes.mesh_scene_camera(8, 8), integrator=integrator, max_bounces=64)
    assert got_rays == want_rays
    assert_images_match(got, want)


def test_trace_wave_max_bounces_and_count():
    """The loop stops at ``max_bounces``: with one bounce, MIS traces the
    primary wave plus one shadow and one peek query per live lane."""
    (want, want_rays), (got, got_rays) = _wave(
        jax_scenes.cornell_box(), jax_scenes.cornell_camera(8, 8), integrator="mis",
        max_bounces=1)
    assert got_rays == want_rays and 64 < got_rays <= 3 * 64
    assert_images_match(got, want)


def test_trace_wave_rejects_bad_arguments():
    sc = scenes.cornell_box(device="cpu")
    o = torch.zeros((4, 3))
    keys = rng.pixel_sample_keys(rng.base_key(0), torch.arange(4), torch.zeros(4).long())
    with pytest.raises(ValueError, match="integrator"):
        integrators.trace_wave(sc, o, o, keys, integrator="path")
    with pytest.raises(ValueError, match="num_light_samples"):
        integrators.trace_wave(sc, o, o, keys, num_light_samples=0)
