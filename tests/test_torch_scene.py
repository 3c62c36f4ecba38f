"""The port's scenes, meshes, cameras and primary rays equal the JAX
package's."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu import meshes as jax_meshes  # noqa: E402
from pathtrace_tpu.models import scene as jax_scene  # noqa: E402
from pathtrace_tpu.models import scenes as jax_scenes  # noqa: E402
from pathtrace_tpu.models.materials import Lambertian as JaxLambertian  # noqa: E402
from pathtrace_tpu_torch import meshes  # noqa: E402
from pathtrace_tpu_torch.convert import (  # noqa: E402
    camera_from_arrays,
    scene_from_arrays,
    split_fields,
)
from pathtrace_tpu_torch.models import scenes  # noqa: E402
from pathtrace_tpu_torch.models.scene import SceneBuilder  # noqa: E402
from pathtrace_tpu_torch.models.materials import Lambertian  # noqa: E402

SCENES = {
    "cornell": ({}, "cornell_box"),
    "default_spheres": ({}, "default_spheres"),
    "many_spheres_3": ({"n_per_side": 3}, "many_spheres"),
    "mesh_4200": ({"n_tris": 4200}, "mesh_scene"),    # SAH row order
}
CAMERAS = {
    "cornell": ("cornell_camera", (16, 16)),
    "default_spheres": ("default_spheres_camera", (32, 24)),
    "many_spheres": ("many_spheres_camera", (48, 27)),
    "mesh": ("mesh_scene_camera", (32, 18)),
}


def _assert_fields_equal(port, ref_arrays, ref_static):
    for f in dataclasses.fields(port):
        v = getattr(port, f.name)
        if f.name in ref_static:
            assert v == ref_static[f.name], f.name
            continue
        want = ref_arrays[f.name]
        got = v.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_fields_exact(name):
    kw, fn = SCENES[name]
    arrays, static = split_fields(getattr(jax_scenes, fn)(**kw))
    _assert_fields_equal(getattr(scenes, fn)(**kw), arrays, static)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_from_arrays_round_trip(name):
    kw, fn = SCENES[name]
    arrays, static = split_fields(getattr(jax_scenes, fn)(**kw))
    port = scene_from_arrays(arrays, static)
    _assert_fields_equal(port, arrays, static)
    _assert_fields_equal(port, *split_fields(getattr(scenes, fn)(**kw)))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b).max()


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_camera_fields(name):
    fn, (w, h) = CAMERAS[name]
    ref = getattr(jax_scenes, fn)(w, h)
    port = getattr(scenes, fn)(w, h)
    assert (port.width, port.height) == (ref.width, ref.height)
    for field in ("origin", "lower_left_corner", "horizontal", "vertical"):
        assert _ulps(getattr(port, field).numpy(), getattr(ref, field)) <= 1, field
    back = camera_from_arrays(*split_fields(ref))
    for field in ("origin", "lower_left_corner", "horizontal", "vertical"):
        np.testing.assert_array_equal(getattr(back, field).numpy(),
                                      np.asarray(getattr(ref, field)))


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_primary_rays(name):
    """Kernel-layout primary rays agree with the JAX camera's to a few ulps
    (XLA on the CPU may contract a multiply-add; torch does not)."""
    fn, (w, h) = CAMERAS[name]
    ref = getattr(jax_scenes, fn)(w, h)
    port = camera_from_arrays(*split_fields(ref))
    g = np.random.default_rng(3)
    px = g.integers(0, w, 500).astype(np.int32)
    py = g.integers(0, h, 500).astype(np.int32)
    jit = g.random((500, 2), dtype=np.float32)
    o_ref, d_ref = ref.generate_rays(jnp.asarray(px), jnp.asarray(py), jnp.asarray(jit),
                                     transposed=True)
    o, d = port.generate_rays(torch.from_numpy(px), torch.from_numpy(py),
                              torch.from_numpy(jit))
    assert o.shape == d.shape == (3, 500)
    np.testing.assert_array_equal(o.numpy(), np.asarray(o_ref))
    assert _ulps(d.numpy(), d_ref) <= 4


def test_builder_refuses_mesh_sized_soup():
    """A soup past the morton limit (513 triangles) is no longer refused: it
    takes the SAH split order, row for row the JAX package's."""
    b, jb = SceneBuilder(), jax_scene.SceneBuilder()
    g = np.random.default_rng(7)
    for _ in range(513):
        v = g.uniform(-5, 5, (3, 3))
        b.add_triangle(*v, Lambertian((0.5, 0.5, 0.5)))
        jb.add_triangle(*v, JaxLambertian((0.5, 0.5, 0.5)))
    _assert_fields_equal(b.build(), *split_fields(jb.build()))


@pytest.mark.parametrize("kw", [{"n_tris": 4200}, {"n_tris": 9000, "p": 3, "q": 5}])
def test_knot_mesh(kw):
    v, f = meshes.knot_mesh(**kw)
    jv, jf = jax_meshes.knot_mesh(**kw)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


def test_icosphere_and_grid():
    for a, b in zip(meshes.icosphere(2, 0.5, (1, 2, 3)), jax_meshes.icosphere(2, 0.5, (1, 2, 3))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(meshes.grid_mesh(5, 4, wrap_v=False),
                                  jax_meshes.grid_mesh(5, 4, wrap_v=False))


def test_convert_rejects_unknown_field():
    arrays, static = split_fields(jax_scenes.cornell_box())
    arrays["bogus"] = np.zeros(3)
    with pytest.raises(ValueError, match="bogus"):
        scene_from_arrays(arrays, static)
