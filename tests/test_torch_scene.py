"""The port's scenes, cameras and primary rays equal the JAX package's."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.models import scenes as jax_scenes  # noqa: E402
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
}
CAMERAS = {
    "cornell": ("cornell_camera", (16, 16)),
    "default_spheres": ("default_spheres_camera", (32, 24)),
    "many_spheres": ("many_spheres_camera", (48, 27)),
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
    b = SceneBuilder()
    for i in range(513):
        b.add_triangle((i, 0, 0), (i + 1, 0, 0), (i, 1, 0), Lambertian((0.5, 0.5, 0.5)))
    with pytest.raises(NotImplementedError, match="mesh"):
        b.build()


def test_convert_rejects_unknown_field():
    arrays, static = split_fields(jax_scenes.cornell_box())
    arrays["bogus"] = np.zeros(3)
    with pytest.raises(ValueError, match="bogus"):
        scene_from_arrays(arrays, static)
