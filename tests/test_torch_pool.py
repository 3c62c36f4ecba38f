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
from pathtrace_tpu_torch.models.materials import Lambertian, OrenNayar  # noqa: E402
from pathtrace_tpu_torch.models.scene import SceneBuilder  # noqa: E402

from .imgutil import assert_images_match  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _render_both(jsc, jcam, fused=True, **kw):
    set_default_method("pallas_interpret" if fused else None)
    try:
        img, counters, iters = jax_pool.render_pool(jsc, jcam, **kw)
        img = np.asarray(img)
    finally:
        set_default_method(None)
    port = pool.render_pool(scene_from_arrays(*split_fields(jsc)),
                            camera_from_arrays(*split_fields(jcam)), **kw)
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
    assert pool.route(scene_from_arrays(*split_fields(jsc)), integrator) == "composed"
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
    args = (scenes.cornell_box(), scenes.cornell_camera(16, 16))
    a, ca, _ = pool.render_pool(*args, spp=1, sample_offset=0, **kw)
    b, cb, _ = pool.render_pool(*args, spp=1, sample_offset=1, **kw)
    both, cboth, _ = pool.render_pool(*args, spp=2, **kw)
    assert pool.ray_count(ca) + pool.ray_count(cb) == pool.ray_count(cboth)
    assert_images_match((a + b).numpy(), both.numpy())


def test_pool_counter_encoding():
    img, counters, iters = pool.render_pool(
        scenes.cornell_box(), scenes.cornell_camera(8, 8), width=8, height=8, spp=1,
        num_slots=16, max_bounces=4)
    assert counters.shape == (4,) and counters.dtype == torch.int64
    assert int(counters.max()) < 2**32 and iters % pool.FLUSH_EVERY == 0
    hi_lo = np.asarray([[1, 5, 0, 7]], np.int64)
    assert pool.ray_count(hi_lo) == (1 << 32) + 5 and pool.busy_count(hi_lo) == 7


def test_unsupported_scenes_raise():
    b = SceneBuilder()
    for i in range(65):      # past the fused kernels' 64-triangle cap
        b.add_triangle((i, 0, 0), (i + 1, 0, 0), (i, 1, 0), Lambertian((0.5, 0.5, 0.5)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pool.render_pool(b.build(), scenes.cornell_camera(4, 4), width=4, height=4, spp=1)
    b = SceneBuilder()        # between the fused caps and the BVH route
    for i in range(1000):
        b.add_triangle((i, 0, 0), (i + 1, 0, 0), (i, 1, 0), Lambertian((0.5, 0.5, 0.5)))
    with pytest.raises(NotImplementedError, match="triangle_closest.*ROADMAP Queue 2, item 8"):
        pool.render_pool(b.build(), scenes.cornell_camera(4, 4), width=4, height=4, spp=1)
    b = SceneBuilder().add_sphere((0, 0, -3), 1.0, OrenNayar((0.5, 0.5, 0.5), 0.3))
    with pytest.raises(NotImplementedError, match="Oren-Nayar"):
        pool.render_pool(b.build(), scenes.cornell_camera(4, 4), width=4, height=4, spp=1)
    with pytest.raises(NotImplementedError):
        pool.render_pool(scenes.cornell_box(), scenes.cornell_camera(4, 4), width=4,
                         height=4, spp=1, integrator="path")


def test_port_never_imports_jax():
    code = (
        "import sys, pkgutil, importlib, pathtrace_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'pathtrace_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'pathtrace_tpu'))\n"
        "assert len(mods) >= 19, mods\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout
