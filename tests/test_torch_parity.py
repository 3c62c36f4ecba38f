"""Statistical parity of the port against the native C++ oracle on the CPU,
and the port's white-furnace and sampler checks (``tests/test_furnace.py``).

The oracle (``csrc/oracle.cpp`` through ``pathtrace_tpu_torch.oracle``) is
the independent float64 implementation of the estimator; its RNG differs,
so parity is statistical, as in ``tests/test_parity.py``. That test renders
48x48 at 192 spp (glass and diffuse scenes, wave engine) with bounds set
from multi-seed runs. Here the port's production renderer, the pool, runs
its kernels' plain twins on the CPU at a size the test budget allows, 24x24
at 64 spp, and the bounds are rescaled by the noise law of that docstring:

* per-pixel RMSE ~ sigma_1 / sqrt(spp), so the RMSE bound grows by
  sqrt(192 / 64) = sqrt(3) = 1.7321: diffuse 0.18 -> 0.3118, glass
  0.5 -> 0.8660;
* the whole-image channel mean averages W * H * spp samples, so its bound
  grows by sqrt(48^2 * 192 / (24^2 * 64)) = sqrt(442368 / 36864) = sqrt(12)
  = 3.4641: diffuse 0.012 -> 0.04157, glass 0.02 -> 0.06928.

The oracle keeps the JAX test's sample counts (1,024 and 768). The
full-size check, the five JAX cases at their own sizes and bounds through
the port on the card, is ``chip_smoke.py``'s phase 7.

The furnace and sampler tests keep the JAX tolerances; their uniforms come
from numpy with a fixed seed.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from pathtrace_tpu_torch import oracle  # noqa: E402
from pathtrace_tpu_torch.debug import render_pixel_samples  # noqa: E402
from pathtrace_tpu_torch.models import materials, scenes  # noqa: E402
from pathtrace_tpu_torch.models.camera import Camera  # noqa: E402
from pathtrace_tpu_torch.models.materials import Emissive, Lambertian  # noqa: E402
from pathtrace_tpu_torch.models.scene import SceneBuilder  # noqa: E402
from pathtrace_tpu_torch.ops import lights  # noqa: E402
from pathtrace_tpu_torch.pool import render_pool  # noqa: E402
from pathtrace_tpu_torch.utils import vec  # noqa: E402

W = H = 24
SPP = 64
JAX_W, JAX_SPP = 48, 192                      # tests/test_parity.py's frame
RMSE_SCALE = math.sqrt(JAX_SPP / SPP)                       # sqrt(3)
MEAN_SCALE = math.sqrt(JAX_W * JAX_W * JAX_SPP / (W * H * SPP))   # sqrt(12)


@pytest.mark.parametrize("name, oracle_spp, mean_tol, rmse_tol", [
    ("diffuse", 1024, 0.012, 0.18),
    ("cornell", 768, 0.02, 0.5),   # glass: fireflies dominate the per-pixel RMSE
])
def test_pool_parity_vs_oracle(name, oracle_spp, mean_tol, rmse_tol):
    scene = (scenes.cornell_box("cpu") if name == "cornell" else
             chip_smoke.parity_scene(name, SceneBuilder("cpu"), materials))
    camera = scenes.cornell_camera(W, H, "cpu")
    img, _, _ = render_pool(scene, camera, width=W, height=H, spp=SPP, integrator="mis",
                            seed=5)
    img = (img / SPP).reshape(H, W, 3).numpy()
    ref = oracle.render_oracle(scene, camera, W, H, oracle_spp, "mis", seed=11)
    mean_diff, rmse = chip_smoke.parity_stats(img, ref)
    assert np.isfinite(img).all()
    assert (mean_diff < mean_tol * MEAN_SCALE).all(), (mean_diff, rmse)
    assert rmse < rmse_tol * RMSE_SCALE, (mean_diff, rmse)


def test_lambert_furnace():
    """A convex Lambert sphere in a uniform emissive enclosure: its outgoing
    radiance is exactly albedo * E under BRDF-only sampling."""
    rho, E = 0.6, 2.0
    sc = (
        SceneBuilder("cpu")
        .add_sphere((0, 0, 0), 50.0, Emissive((E, E, E)))     # enclosure
        .add_sphere((0, 0, -3), 1.0, Lambertian((rho, rho, rho)))
        .build()
    )
    cam = Camera.perspective((0, 0, 0), 32, 32, 1.0, 20.0, device="cpu")
    samples = render_pixel_samples(sc, cam, 16, 16, width=32, height=32, spp=2048,
                                   integrator="brdf_only", max_bounces=8, seed=0)
    # Analytic: rho * E = 1.2; MC sigma ~ rho * E / sqrt(2048) ~ 0.03
    np.testing.assert_allclose(samples.mean(axis=0), rho * E, rtol=0.05)


def _chi2(counts, expected) -> float:
    return float(((counts - expected) ** 2 / expected).sum())


def test_cosine_sampler_chi_square():
    """The cosine-weighted sampler against its CDF P(cos theta < c) = c^2.

    The uniforms are numpy's seed-1 stream. Its seed-0 stream fails the
    bound by itself: the float64 sqrt of its uniforms, before any code of
    the port, gives chi2 = 28.5, a one-in-a-thousand draw. So the sampler's
    bins are also held equal to those of that exact transform."""
    n = 1 << 16
    u = np.random.default_rng(1).random((n, 2), dtype=np.float32)
    normal = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3)
    ut = torch.from_numpy(u)
    c = vec.cosine_hemisphere_direction(normal, ut[:, 0], ut[:, 1])[:, 2].numpy()
    bins = np.linspace(0, 1, 11)
    counts, _ = np.histogram(c, bins=bins)
    np.testing.assert_array_equal(counts, np.histogram(np.sqrt(u[:, 1].astype(np.float64)),
                                                       bins=bins)[0])
    expected = (bins[1:] ** 2 - bins[:-1] ** 2) * n
    # 9 dof; P(chi2 > 27.9) ~ 0.001
    assert _chi2(counts, expected) < 27.9, (counts, expected)


def test_triangle_light_sampler_chi_square():
    """Area-uniform triangle sampling: barycentric u has density 2(1 - u)."""
    b = SceneBuilder("cpu")
    b.add_triangle((0, 5, 0), (1, 5, 0), (0, 5, 1), Emissive((1, 1, 1)))
    b.add_sphere((0, -100, 0), 0.1, Lambertian((1, 1, 1)))
    sc = b.build()
    n = 1 << 15
    uu = torch.from_numpy(np.random.default_rng(1).random((n, 3), dtype=np.float32))
    ls = lights.sample_light_point(sc, torch.zeros((n, 3)), uu[:, 0], uu[:, 1], uu[:, 2])
    # barycentric u is the x coordinate (v0 = (0, 5, 0), e1 = (1, 0, 0))
    u = ls.point[:, 0].numpy()
    bins = np.linspace(0, 1, 11)
    counts, _ = np.histogram(u, bins=bins)

    def cdf(x):
        return 1 - (1 - x) ** 2

    expected = (cdf(bins[1:]) - cdf(bins[:-1])) * n
    assert _chi2(counts, expected) < 27.9, (counts, expected)
