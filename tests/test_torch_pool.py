"""The port's persistent-pool renderer against the JAX package's pool.

Both start from identical inputs: the JAX scene and camera enter the port
through ``scene_from_arrays``/``camera_from_arrays``. For the small scenes
the JAX pool runs its fused branch in Pallas interpret mode
(``set_default_method("pallas_interpret")``); for the mesh scene it runs its
CPU default, the composed branch (with the Pallas override ``resolve_auto``
would send the mesh to the flat route, which is not the BVH one). The port
runs the kernels' plain-torch twins on the CPU. The traced-ray count and the
iteration count must be equal, and the image within the
``tests/imgutil.py`` knife-edge budget.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pathtrace_tpu import pool as jax_pool  # noqa: E402
from pathtrace_tpu.models import scenes as jax_scenes  # noqa: E402
from pathtrace_tpu.ops.intersect import set_default_method  # noqa: E402
from pathtrace_tpu_torch import pool  # noqa: E402
from pathtrace_tpu_torch.convert import (  # noqa: E402
    camera_from_arrays,
    scene_from_arrays,
    split_fields,
)
from pathtrace_tpu_torch.models import scenes  # noqa: E402
from pathtrace_tpu_torch.models.materials import Emissive, Lambertian, OrenNayar  # noqa: E402
from pathtrace_tpu_torch.models.scene import SceneBuilder  # noqa: E402
from pathtrace_tpu_torch.ops import intersect  # noqa: E402

from .imgutil import assert_images_match  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _render_both(jsc, jcam, fused=True, **kw):
    set_default_method("pallas_interpret" if fused else None)
    try:
        img, counters, iters = jax_pool.render_pool(jsc, jcam, **kw)
        img = np.asarray(img)
    finally:
        set_default_method(None)
    port = pool.render_pool(scene_from_arrays(*split_fields(jsc), device="cpu"),
                            camera_from_arrays(*split_fields(jcam), device="cpu"), **kw)
    return (img, counters, int(iters)), port


def _assert_same_render(ref, got):
    (img, counters, iters), (timg, tcounters, titers) = ref, got
    assert pool.ray_count(tcounters) == jax_pool.ray_count(counters)
    assert pool.busy_count(tcounters) == jax_pool.busy_count(counters)
    assert titers == iters
    assert timg.shape == img.shape and timg.dtype == torch.float32
    assert_images_match(timg.numpy(), img)


@pytest.mark.parametrize("integrator", ["mis", "nee", "brdf_only"])
def test_pool_matches_jax_cornell(integrator):
    ref, got = _render_both(
        jax_scenes.cornell_box(), jax_scenes.cornell_camera(16, 16),
        width=16, height=16, spp=2, integrator=integrator, max_bounces=6,
        num_slots=64, seed=5)
    _assert_same_render(ref, got)
    if integrator == "mis":   # the counts measured for the JAX pool
        assert (pool.ray_count(got[1]), got[2]) == (3568, 48)


def test_pool_matches_jax_many_spheres():
    ref, got = _render_both(
        jax_scenes.many_spheres(n_per_side=3), jax_scenes.many_spheres_camera(12, 12),
        width=12, height=12, spp=2, integrator="mis", max_bounces=6,
        num_slots=64, seed=5)
    _assert_same_render(ref, got)
    assert (pool.ray_count(got[1]), got[2]) == (834, 16)


@pytest.mark.parametrize("integrator", ["mis", "nee", "brdf_only"])
def test_pool_matches_jax_mesh(integrator):
    """The composed branch on the BVH route's twins (4182 triangles, >= 4096)
    against the JAX pool's composed branch."""
    jsc = jax_scenes.mesh_scene(4200)
    ref, got = _render_both(
        jsc, jax_scenes.mesh_scene_camera(8, 8), fused=False,
        width=8, height=8, spp=2, integrator=integrator, max_bounces=4,
        num_slots=64, seed=5)
    sc = scene_from_arrays(*split_fields(jsc), device="cpu")
    assert pool.route(sc, integrator) == "composed"
    _assert_same_render(ref, got)
    if integrator == "mis":   # the counts measured for the JAX pool
        assert (pool.ray_count(got[1]), got[2]) == (348, 8)


def test_pool_matches_jax_mesh_long_paths():
    """Fewer slots and deeper paths: more iterations through the composed
    branch, Russian roulette included."""
    ref, got = _render_both(
        jax_scenes.mesh_scene(4200), jax_scenes.mesh_scene_camera(8, 8), fused=False,
        width=8, height=8, spp=2, integrator="mis", max_bounces=8, num_slots=8, seed=2)
    _assert_same_render(ref, got)
    assert got[2] >= 32


@pytest.mark.parametrize("name", ["cornell", "mesh"])
def test_pool_bruteforce_matches_jax_composed(name):
    """``method="bruteforce"``: the JAX pool runs its composed branch (its
    fused gate wants a Pallas method) with the brute-force intersection; the
    port runs its composed branch on the route of ``"pallas"``, whose hits
    are brute force's. Same rays, busy slots and iterations, at the sizes
    and seed of the cases above."""
    if name == "cornell":
        jsc, jcam = jax_scenes.cornell_box(), jax_scenes.cornell_camera(16, 16)
        kw = dict(width=16, height=16, spp=2, max_bounces=6)
    else:
        jsc, jcam = jax_scenes.mesh_scene(4200), jax_scenes.mesh_scene_camera(8, 8)
        kw = dict(width=8, height=8, spp=2, max_bounces=4)
    ref, got = _render_both(jsc, jcam, fused=False, integrator="mis", num_slots=64, seed=5,
                            method="bruteforce", **kw)
    sc = scene_from_arrays(*split_fields(jsc), device="cpu")
    assert pool.route(sc, "mis", "bruteforce") == "composed"
    assert pool.route(sc, "mis") == ("fused" if name == "cornell" else "composed")
    _assert_same_render(ref, got)


def test_sample_offset_matches_jax():
    ref, got = _render_both(
        jax_scenes.cornell_box(), jax_scenes.cornell_camera(16, 16),
        width=16, height=16, spp=1, integrator="mis", max_bounces=6,
        num_slots=64, seed=5, sample_offset=3)
    _assert_same_render(ref, got)


def test_progressive_passes_sum_to_one_render():
    """Two 1-spp passes at sample offsets 0 and 1 trace the samples of one
    2-spp render."""
    kw = dict(width=16, height=16, integrator="mis", max_bounces=6, num_slots=64, seed=5)
    args = (scenes.cornell_box(device="cpu"), scenes.cornell_camera(16, 16, device="cpu"))
    a, ca, _ = pool.render_pool(*args, spp=1, sample_offset=0, **kw)
    b, cb, _ = pool.render_pool(*args, spp=1, sample_offset=1, **kw)
    both, cboth, _ = pool.render_pool(*args, spp=2, **kw)
    assert pool.ray_count(ca) + pool.ray_count(cb) == pool.ray_count(cboth)
    assert_images_match((a + b).numpy(), both.numpy())


def test_pool_counter_encoding():
    img, counters, iters = pool.render_pool(
        scenes.cornell_box(device="cpu"), scenes.cornell_camera(8, 8, device="cpu"), width=8,
        height=8, spp=1,
        num_slots=16, max_bounces=4)
    assert counters.shape == (4,) and counters.dtype == torch.int64
    assert int(counters.max()) < 2**32 and iters % pool.FLUSH_EVERY == 0
    hi_lo = np.asarray([[1, 5, 0, 7]], np.int64)
    assert pool.ray_count(hi_lo) == (1 << 32) + 5 and pool.busy_count(hi_lo) == 7


def test_unsupported_scenes_raise():
    """Only unknown integrators raise now. More than 512 spheres with few
    triangles takes the composed branch on the flat route with the sphere
    cluster boxes, and Oren-Nayar within the fused caps the fused branch with
    its Oren-Nayar lane (both rendered here on the CPU twins)."""
    cam = scenes.cornell_camera(4, 4, device="cpu")
    b = SceneBuilder(device="cpu")
    for i in range(600):
        b.add_sphere((i, 0, -3), 0.4, Lambertian((0.5, 0.5, 0.5)))
    sc = b.build()
    assert pool.route(sc, "mis") == "composed"
    tables = intersect.build_tables(sc)
    assert tables.route == "flat" and tables.sph_box.shape[0] == 3
    img, _, _ = pool.render_pool(sc, cam, width=4, height=4, spp=1)
    assert torch.isfinite(img).all()
    b = SceneBuilder(device="cpu").add_sphere((0, 0, -3), 1.0, OrenNayar((0.5, 0.5, 0.5), 0.3))
    sc = b.build()
    assert sc.has_oren_nayar and pool.route(sc, "mis") == "fused"
    img, _, _ = pool.render_pool(sc, cam, width=4, height=4, spp=1)
    assert torch.isfinite(img).all()
    with pytest.raises(NotImplementedError):
        pool.render_pool(scenes.cornell_box(device="cpu"), cam, width=4,
                         height=4, spp=1, integrator="path")


def _on_pbr_scene():
    """The ON/PBR scene of ``tests/test_fused.py``, built by the JAX builder:
    an Oren-Nayar ground, two PBR spheres (dielectric and metal), a GGX
    mirror, a Lambert sphere, a spherical and a triangle light; all lobes at
    least 0.3 rough."""
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


@pytest.mark.parametrize("integrator", ["mis", "brdf_only"])
def test_pool_matches_jax_on_pbr(integrator):
    """The fused pool with the Oren-Nayar and PBR lanes against the JAX fused
    pool (its kernel in interpret mode, ``has_on``/``has_pbr`` set from the
    scene) on the ON/PBR scene, 16x16."""
    jsc = _on_pbr_scene()
    assert jsc.has_oren_nayar and jsc.has_pbr
    ref, got = _render_both(
        jsc, jax_scenes.default_spheres_camera(16, 16),
        width=16, height=16, spp=2, integrator=integrator, max_bounces=6,
        num_slots=64, seed=3)
    assert pool.route(scene_from_arrays(*split_fields(jsc), device="cpu"), integrator) == "fused"
    _assert_same_render(ref, got)
    assert (pool.ray_count(got[1]), got[2]) == ON_PBR_COUNTS[integrator]


ON_PBR_COUNTS = {"mis": (1328, 24), "brdf_only": (913, 24)}   # measured for the JAX fused pool


def _lights65():
    from .test_torch_intersect import _lights65 as make

    return make()


def test_pool_engine_per_scene():
    """Which engine the pool runs, and on which intersection route: the JAX
    pool's choice (``pool.py`` fused gate + ``resolve_auto``)."""
    def engine(jsc):
        sc = scene_from_arrays(*split_fields(jsc), device="cpu")
        branch = pool.route(sc, "mis")
        return branch, branch == "fused" or intersect.build_tables(sc).route

    assert engine(jax_scenes.cornell_box()) == ("fused", True)
    assert engine(jax_scenes.many_spheres(n_per_side=3)) == ("fused", True)
    assert engine(jax_scenes.mesh_scene(1000)) == ("composed", "flat")
    assert engine(jax_scenes.mesh_scene(4200)) == ("composed", "bvh")
    assert engine(_lights65()) == ("composed", "small")
    b = SceneBuilder(device="cpu")
    for i in range(65):      # past the fused kernels' 64-triangle cap
        b.add_triangle((i, 0, 0), (i + 1, 0, 0), (i, 1, 0), Lambertian((0.5, 0.5, 0.5)))
    b.add_triangle((0, 2, 0), (1, 2, 0), (0, 3, 0), Emissive((4.0, 4.0, 4.0)))
    sc = b.build()
    assert pool.route(sc, "mis") == "composed" and intersect.build_tables(sc).route == "flat"
    b = SceneBuilder(device="cpu")
    for i in range(600):
        b.add_sphere((i, 0, -3), 0.4, Lambertian((0.5, 0.5, 0.5)))
    sc = b.build()
    assert pool.route(sc, "mis") == "composed" and intersect.build_tables(sc).route == "flat"
    assert engine(jax_scenes.many_spheres(n_per_side=12)) == ("composed", "flat")
    b = SceneBuilder(device="cpu").add_sphere((0, 0, -3), 1.0, OrenNayar((0.5, 0.5, 0.5), 0.3))
    assert pool.route(b.build(), "mis") == "fused"
    assert engine(_on_pbr_scene()) == ("fused", True)


@pytest.mark.parametrize("integrator", ["mis", "nee", "brdf_only"])
def test_pool_matches_jax_flat_mesh(integrator):
    """The composed branch on the flat route's twins (992 triangles) against
    the JAX pool's composed branch (its CPU default route)."""
    ref, got = _render_both(
        jax_scenes.mesh_scene(1000), jax_scenes.mesh_scene_camera(8, 8), fused=False,
        width=8, height=8, spp=2, integrator=integrator, max_bounces=6,
        num_slots=64, seed=5)
    _assert_same_render(ref, got)


def test_pool_matches_jax_many_lights():
    """A small scene with 65 lights: the composed branch on the small
    route (combined_closest_small's twin) against the JAX composed pool."""
    ref, got = _render_both(
        _lights65(), jax_scenes.default_spheres_camera(8, 8), fused=False,
        width=8, height=8, spp=2, integrator="mis", max_bounces=6, num_slots=64, seed=5)
    _assert_same_render(ref, got)
    assert pool.ray_count(got[1]) > 128


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'pathtrace_tpu'): sys.modules[name] = None  # block them\n"
        "import pkgutil, importlib, pathtrace_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'pathtrace_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'pathtrace_tpu')\n"
        "             and sys.modules[k] is not None)\n"
        "assert len(mods) >= 30, mods\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout
