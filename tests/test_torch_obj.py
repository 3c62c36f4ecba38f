"""The port's OBJ reader and writer against the JAX package's, on files the
tests write themselves."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pathtrace_tpu import meshes as jax_meshes  # noqa: E402
from pathtrace_tpu.models import scene as jax_scene  # noqa: E402
from pathtrace_tpu.models.materials import Lambertian as JaxLambertian  # noqa: E402
from pathtrace_tpu_torch import meshes  # noqa: E402
from pathtrace_tpu_torch.convert import split_fields  # noqa: E402
from pathtrace_tpu_torch.models.materials import Lambertian  # noqa: E402
from pathtrace_tpu_torch.models.scene import SceneBuilder  # noqa: E402

# Quads and a pentagon (fan-triangulated), v/vt/vn and v//vn tokens,
# negative indices, comments and records the reader skips.
OBJ = """# test mesh
o box
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vn 0 0 1
f 1/1/1 2/1/1 3/1/1 4/1/1
v 0.5 0.5 1.25
v -0.25 0.75 0.5
f -2//1 -6//1 -5//1
s off
f 1 2 5 6 4
f -1 -3 -4
"""


@pytest.fixture
def obj_path(tmp_path):
    p = tmp_path / "t.obj"
    p.write_text(OBJ)
    return str(p)


def test_load_obj_matches_jax(obj_path):
    v, f = meshes.load_obj(obj_path)
    assert v.dtype == np.float64 and f.dtype == np.int64
    assert v.shape == (6, 3) and f.shape == (7, 3)
    for jv, jf in (jax_meshes.load_obj(obj_path), jax_meshes._load_obj_py(obj_path)):
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(f, jf)


def test_save_obj_matches_jax_and_round_trips(tmp_path):
    verts, faces = meshes.icosphere(1, radius=1.5, center=(0.25, -1.0, 2.0))
    port, ref = str(tmp_path / "port.obj"), str(tmp_path / "jax.obj")
    meshes.save_obj(port, verts, faces)
    jax_meshes.save_obj(ref, verts, faces)
    assert open(port).read() == open(ref).read()
    v, f = meshes.load_obj(port)
    np.testing.assert_allclose(v, verts, atol=5e-7)
    np.testing.assert_array_equal(f, faces)


def test_loaded_mesh_gives_equal_scene_tables(obj_path):
    """A loaded mesh through ``add_mesh`` on both sides: equal tables."""
    v, f = meshes.load_obj(obj_path)
    jv, jf = jax_meshes.load_obj(obj_path)
    port = SceneBuilder(device="cpu").add_mesh(v, f, Lambertian((0.7, 0.6, 0.5))).build()
    ref = jax_scene.SceneBuilder().add_mesh(jv, jf, JaxLambertian((0.7, 0.6, 0.5))).build()
    arrays, static = split_fields(ref)
    for fld in dataclasses.fields(port):
        got = getattr(port, fld.name)
        if fld.name in static:
            assert got == static[fld.name], fld.name
        else:
            np.testing.assert_array_equal(got.numpy(), arrays[fld.name], err_msg=fld.name)
