"""The port's small public helpers against the JAX package's:
``vec.normal_from_triangle`` and ``bsdf.emitted`` / ``bsdf.is_emissive``.
Inputs are made with numpy from a seed. The normals agree to rtol/atol 1e-6
(float32 ulps: XLA on the CPU contracts the cross product's multiply-adds
and neither side's sqrt is correctly rounded); the material lookups are
exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.models import scenes as jax_scenes  # noqa: E402
from pathtrace_tpu.ops import bsdf as jax_bsdf  # noqa: E402
from pathtrace_tpu.utils import vec as jax_vec  # noqa: E402
from pathtrace_tpu_torch.convert import scene_from_arrays, split_fields  # noqa: E402
from pathtrace_tpu_torch.ops import bsdf  # noqa: E402
from pathtrace_tpu_torch.utils import vec  # noqa: E402


def test_normal_from_triangle_matches_jax():
    rng = np.random.default_rng(17)
    v0, v1, v2 = (rng.normal(size=(4096, 3)).astype(np.float32) for _ in range(3))
    v2[:8] = v0[:8]          # degenerate triangles: the zero vector passes through
    got = vec.normal_from_triangle(*map(torch.from_numpy, (v0, v1, v2))).numpy()
    want = np.asarray(jax_vec.normal_from_triangle(*map(jnp.asarray, (v0, v1, v2))))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[:8], 0.0)


@pytest.mark.parametrize("name", ["cornell_box", "default_spheres"])
def test_emitted_and_is_emissive_match_jax(name):
    jsc = getattr(jax_scenes, name)()
    sc = scene_from_arrays(*split_fields(jsc), device="cpu")
    n_mats = sc.mat_kind.shape[0]
    mid = np.random.default_rng(3).integers(0, n_mats, 512).astype(np.int32)
    mid[:n_mats] = np.arange(n_mats)
    t = torch.from_numpy(mid)
    np.testing.assert_array_equal(bsdf.emitted(sc, t).numpy(),
                                  np.asarray(jax_bsdf.emitted(jsc, jnp.asarray(mid))))
    flags = bsdf.is_emissive(sc, t).numpy()
    np.testing.assert_array_equal(flags, np.asarray(jax_bsdf.is_emissive(jsc, jnp.asarray(mid))))
    assert flags.any() and not flags.all()
