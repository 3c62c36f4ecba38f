"""The port's threefry2x32 draws equal the JAX package's bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu import pool as jax_pool  # noqa: E402
from pathtrace_tpu.utils import rng as jax_rng  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402

S = 4096


@pytest.mark.parametrize("case", range(3))
def test_pool_uniforms_bitwise(case):
    """(9, S) per-slot draws for random seed, pixel < 2**21, sample < 10**4,
    bounce < 64 equal ``_per_slot_uniforms(pixel_sample_keys(...))``."""
    g = np.random.default_rng(100 + case)
    seed = int(g.integers(0, 2**31))
    pixel = g.integers(0, 2**21, S).astype(np.int32)
    sample = g.integers(0, 10**4, S).astype(np.int32)
    bounce = g.integers(0, 64, S).astype(np.int32)

    keys = jax_rng.pixel_sample_keys(
        jax_rng.base_key(seed), jnp.asarray(pixel), jnp.asarray(sample))
    want = np.asarray(jax_pool._per_slot_uniforms(
        keys, jnp.asarray(bounce), jnp.float32, transposed=True))

    tkeys = rng.pixel_sample_keys(
        rng.base_key(seed), torch.from_numpy(pixel).long(), torch.from_numpy(sample).long())
    got = rng.per_slot_uniforms(tkeys, torch.from_numpy(bounce).long()).numpy()

    assert got.shape == (rng.NUM_SLOTS, S) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_key_chain_bitwise():
    """``fold_in`` chains give JAX's key words, including seeds past 2**31."""
    for seed in (0, 1, 2**31 + 5, 2**32 - 1):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), 7), 123456)
        want = np.asarray(jax.random.key_data(k))
        k0, k1 = rng.fold_in(rng.fold_in(rng.base_key(seed), torch.tensor(7)),
                             torch.tensor(123456))
        assert [int(k0), int(k1)] == [int(w) for w in want]


def test_slot_layout_matches():
    for name in ("SLOT_LIGHT_SELECT", "SLOT_LIGHT_U", "SLOT_LIGHT_V", "SLOT_BSDF_U",
                 "SLOT_BSDF_V", "SLOT_FRESNEL", "SLOT_RR", "SLOT_JITTER_X",
                 "SLOT_JITTER_Y", "NUM_SLOTS"):
        assert getattr(rng, name) == getattr(jax_rng, name), name


def test_base_key_rejects_wide_seed():
    with pytest.raises(ValueError):
        rng.base_key(2**32)
