"""The port's bridge to the C++ oracle (``pathtrace_tpu_torch/oracle.py``)
against the JAX package's (``pathtrace_tpu/oracle.py``).

Both bridges hand the same float64/int32 tables of the same scene to the
repository's one ``csrc/oracle.cpp``, built with the same flags, so their
images must be bitwise equal. The scenes: the Cornell box and the three
scenes of ``tests/test_parity.py`` (``chip_smoke.parity_scene`` builds each
with either package's ``SceneBuilder`` from one recipe), under all three
integrators, at 16x16 and 16 spp, with a window of each. The port's window
must equal the same region of its full render, and the golden image's
window must come back bitwise at 8,192 spp.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from pathtrace_tpu import oracle as jax_oracle  # noqa: E402
from pathtrace_tpu.models import materials as jax_materials  # noqa: E402
from pathtrace_tpu.models import scenes as jax_scenes  # noqa: E402
from pathtrace_tpu.models.scene import SceneBuilder as JaxSceneBuilder  # noqa: E402
from pathtrace_tpu_torch import oracle  # noqa: E402
from pathtrace_tpu_torch.models import materials, scenes  # noqa: E402
from pathtrace_tpu_torch.models.scene import SceneBuilder  # noqa: E402

from . import test_parity  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 16
SPP = 16
SCENES = ("cornell", "diffuse", "sphere_light", "oren_nayar")


def _scenes(name):
    """The scene and its 16x16 camera in both packages: ``(jax, port)``."""
    if name == "cornell":
        jsc, sc = jax_scenes.cornell_box(), scenes.cornell_box("cpu")
    else:
        jsc = chip_smoke.parity_scene(name, JaxSceneBuilder(), jax_materials)
        sc = chip_smoke.parity_scene(name, SceneBuilder("cpu"), materials)
    return (jsc, jax_scenes.cornell_camera(W, H)), (sc, scenes.cornell_camera(W, H, "cpu"))


@pytest.mark.parametrize("integrator", ["mis", "nee", "brdf_only"])
@pytest.mark.parametrize("name", SCENES)
def test_bridge_matches_jax_bridge(name, integrator):
    (jsc, jcam), (sc, cam) = _scenes(name)
    ref = jax_oracle.render_oracle(jsc, jcam, W, H, SPP, integrator, seed=7)
    got = oracle.render_oracle(sc, cam, W, H, SPP, integrator, seed=7)
    assert got.shape == (H, W, 3) and got.dtype == np.float64
    assert np.isfinite(got).all() and got.mean() > 0
    np.testing.assert_array_equal(got, ref)
    ref_win = jax_oracle.render_oracle_window(jsc, jcam, W, H, 3, 5, 6, 4, SPP, integrator,
                                              seed=7)
    got_win = oracle.render_oracle_window(sc, cam, W, H, 3, 5, 6, 4, SPP, integrator, seed=7)
    np.testing.assert_array_equal(got_win, ref_win)


@pytest.mark.parametrize("name, build", [("diffuse", test_parity.cornell_diffuse),
                                         ("sphere_light", test_parity.cornell_sphere_light)])
def test_parity_scene_recipe_is_test_parity_scene(name, build):
    """The shared recipe builds exactly ``tests/test_parity.py``'s scenes."""
    ref = build()
    got = chip_smoke.parity_scene(name, JaxSceneBuilder(), jax_materials)
    for field in ("tri_v0", "tri_e1", "tri_e2", "tri_mat", "sph_center", "sph_radius",
                  "sph_mat", "mat_kind", "mat_color", "mat_emission", "mat_roughness",
                  "mat_ior", "light_prims"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(ref, field)), err_msg=field)
    assert (got.num_tris, got.num_spheres, got.num_lights) == (
        ref.num_tris, ref.num_spheres, ref.num_lights)


def test_window_is_the_full_render_region():
    sc, cam = scenes.cornell_box("cpu"), scenes.cornell_camera(W, H, "cpu")
    full = oracle.render_oracle(sc, cam, W, H, SPP, "mis", seed=3)
    win = oracle.render_oracle_window(sc, cam, W, H, 4, 9, 7, 5, SPP, "mis", seed=3)
    np.testing.assert_array_equal(win, full[9:14, 4:11])


def test_golden_window_bitwise():
    golden = np.load(os.path.join(REPO, chip_smoke.GOLDEN))["image"]
    G = chip_smoke.GOLDEN_SIZE
    x0, y0, w, h = chip_smoke.GOLDEN_WINDOW
    win = oracle.render_oracle_window(scenes.cornell_box("cpu"), scenes.cornell_camera(G, G, "cpu"),
                                      G, G, x0, y0, w, h, chip_smoke.GOLDEN_SPP, "mis", seed=0)
    np.testing.assert_array_equal(win, golden[240:244, 190:198])


def test_build_is_named_by_source_and_flags():
    """The library lives in the port's own build directory, under a name
    that carries the hash of the shared source and the flags."""
    path = oracle.build()
    assert path == oracle.library_path() and path.exists()
    assert path.parent == oracle.BUILD_DIR and path.parent.parent.name == "pathtrace_tpu_torch"
    assert oracle.SOURCE == oracle.PACKAGE.parent / "csrc" / "oracle.cpp"
    assert oracle.GXX_FLAGS == ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp")
