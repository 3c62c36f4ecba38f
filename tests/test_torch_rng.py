"""The port's threefry2x32 draws equal the JAX package's bit for bit."""

import collections
import contextlib
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu import pool as jax_pool  # noqa: E402
from pathtrace_tpu.utils import rng as jax_rng  # noqa: E402
from pathtrace_tpu_torch.kernels import binding  # noqa: E402
from pathtrace_tpu_torch.ops import shade  # noqa: E402
from pathtrace_tpu_torch.utils import rng  # noqa: E402

S = 4096
SEEDS = (0, 2**31 + 5, 2**32 - 1)
DTYPES = (torch.float32, torch.float64)


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


def _pool_lanes(n, seed):
    """Pixels < 2**21, samples < 10**4 and bounces < 64 as numpy int32."""
    g = np.random.default_rng(seed)
    return (g.integers(0, 2**21, n).astype(np.int32), g.integers(0, 10**4, n).astype(np.int32),
            g.integers(0, 64, n).astype(np.int32))


def _torch_lanes(pixel, sample, bounce):
    """The pool's carry: pixel and sample int64, bounce int32."""
    return (torch.from_numpy(pixel).long(), torch.from_numpy(sample).long(),
            torch.from_numpy(bounce))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
def test_pool_uniforms_equals_twin_and_jax(seed, dtype):
    """``pool_uniforms`` (bounce int32) is bit for bit the twin's
    ``per_slot_uniforms(pixel_sample_keys(...))`` and JAX's
    ``_per_slot_uniforms`` in the kernel layout, seeds past 2**31 included."""
    pixel, sample, bounce = _pool_lanes(1024, seed % 1000)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    with jax.enable_x64(dtype == torch.float64):
        keys = jax_rng.pixel_sample_keys(
            jax_rng.base_key(seed), jnp.asarray(pixel), jnp.asarray(sample))
        want = np.asarray(jax_pool._per_slot_uniforms(keys, jnp.asarray(bounce), jdt,
                                                      transposed=True))
    key = rng.base_key(seed)
    tp, ts, tb = _torch_lanes(pixel, sample, bounce)
    got = rng.pool_uniforms(key, tp, ts, tb, dtype)
    twin = rng.per_slot_uniforms(rng.pixel_sample_keys(key, tp, ts), tb.long(), dtype)
    assert got.shape == (rng.NUM_SLOTS, 1024) and got.dtype == dtype and got.is_contiguous()
    assert want.dtype == got.numpy().dtype
    bits = np.uint32 if dtype == torch.float32 else np.uint64
    np.testing.assert_array_equal(got.numpy().view(bits), twin.numpy().view(bits))
    np.testing.assert_array_equal(got.numpy().view(bits), want.view(bits))


_BAD = {
    "pixel int32": lambda p, s, b: (p.int(), s, b),
    "pixel (S, 1)": lambda p, s, b: (p[:, None], s, b),
    "sample float": lambda p, s, b: (p, s.double(), b),
    "sample short": lambda p, s, b: (p, s[:-1], b),
    "bounce int64": lambda p, s, b: (p, s, b.long()),
    "bounce long": lambda p, s, b: (p, s, torch.cat([b, b[:1]])),
    "bounce strided": lambda p, s, b: (p, s, torch.stack([b, b], 1)[:, 0]),
}


@pytest.mark.parametrize("case", list(_BAD))
def test_pool_uniforms_rejects_bad_lanes(case):
    """Wrong dtypes, shapes or strides of pixel, sample or bounce raise, on
    the route the CPU takes as on the card's."""
    lanes = _torch_lanes(*_pool_lanes(64, 1))
    with pytest.raises(ValueError):
        rng.pool_uniforms(rng.base_key(1), *_BAD[case](*lanes))


def test_pool_uniforms_rejects_other_dtypes():
    lanes = _torch_lanes(*_pool_lanes(64, 2))
    with pytest.raises(ValueError):
        rng.pool_uniforms(rng.base_key(2), *lanes, torch.float16)


def _c_params(name):
    """ctypes types of ``extern "C" int name(...)`` in ``csrc/rng.cu``."""
    src = (Path(binding.__file__).parent.parent / "csrc" / "rng.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)[1].split(",")
    return [binding._P if "*" in p else binding._L if "long long" in p else binding._I
            for p in params]


def _host(ptr, n, dtype):
    """``n`` values of ``dtype`` at host address ``ptr``, copied."""
    size = torch.empty((), dtype=dtype).element_size()
    return torch.frombuffer(bytearray(ctypes.string_at(ptr, n * size)), dtype=dtype)


def _put(ptr, x):
    ctypes.memmove(ptr, x.contiguous().data_ptr(), x.numel() * x.element_size())


class _RngLib:
    """A mock kernel library whose rng entry points follow the C contract of
    ``csrc/rng.cu`` on host memory, with the twin's arithmetic: each reads its
    inputs and writes its outputs through the pointers it is given. Other
    entry points only take their declared argument types."""

    def __init__(self):
        self.calls = collections.Counter()

    def _pool(self, dtype, k0, k1, pixel, sample, bounce, u, n, stream):
        key = (_host(k0, 1, torch.int64)[0], _host(k1, 1, torch.int64)[0])
        keys = rng.fold_in(rng.fold_in(key, _host(pixel, n, torch.int64)),
                           _host(sample, n, torch.int64))
        _put(u, rng.per_slot_uniforms(keys, _host(bounce, n, torch.int32).long(), dtype))

    def _bounce(self, dtype, k0, k1, bounce, u, n, stream):
        keys = (_host(k0, n, torch.int64), _host(k1, n, torch.int64))
        _put(u, rng.per_slot_uniforms(keys, torch.full((n,), bounce, dtype=torch.int64), dtype))

    def _fold(self, dtype, k0, k1, stride, data0, value0, data1, out, n, stream):
        m = n if stride else 1
        keys = (_host(k0, m, torch.int64), _host(k1, m, torch.int64))
        keys = rng.fold_in(keys, _host(data0, n, torch.int64) if data0 else
                           torch.full((n,), value0))
        if data1:
            keys = rng.fold_in(keys, _host(data1, n, torch.int64))
        _put(out, torch.stack(torch.broadcast_tensors(*keys)))

    def __getattr__(self, name):
        m = re.fullmatch(r"pt_rng_(pool|bounce|fold)(_uniforms)?(_f64)?", name)
        dtype = torch.float64 if m and m[3] else torch.float32
        lib = self

        class Fn:
            def __call__(self, *args):
                lib.calls[m[1]] += 1
                getattr(lib, "_" + m[1])(dtype, *args)
                return 0
        entry = Fn()
        setattr(self, name, entry)
        return entry


RNG_ENTRIES = ("pt_rng_pool_uniforms", "pt_rng_pool_uniforms_f64", "pt_rng_bounce_uniforms",
               "pt_rng_bounce_uniforms_f64", "pt_rng_fold")


@pytest.fixture
def card_route(monkeypatch):
    """``utils/rng.py`` taking its CPU tensors for the card's, launching
    through :class:`_RngLib`; ``rng.LAUNCHES`` and ``shade.LAUNCHES`` are
    restored after."""
    lib = _RngLib()
    saved = [(c, collections.Counter(c)) for c in (rng.LAUNCHES, shade.LAUNCHES)]
    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding.build, "build", lambda: ("mock.so", 0.0))
    monkeypatch.setattr(binding.ctypes, "CDLL", lambda path: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(binding, "_stream", lambda dev: 0)
    monkeypatch.setattr(binding, "device_kind", lambda x: "cuda")
    yield lib
    for counter, counts in saved:
        counter.clear()
        counter.update(counts)


def test_card_route_declares_the_c_signatures(card_route):
    """The argument types the binding declares for the rng entry points are
    those of their ``extern "C"`` signatures."""
    binding.library()
    for name in RNG_ENTRIES:
        assert getattr(card_route, name).argtypes == _c_params(name), name


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
def test_card_route_gives_the_twins_bits(dtype, card_route):
    """Through a mock library that follows the kernels' C contract, the card's
    route of every dispatching function returns the CPU route's bits and
    layout: the pool's draw, the wave's keys, bounce draw, jitter and NEE
    light-sample keys."""
    lanes = _torch_lanes(*_pool_lanes(300, 7))
    key = rng.base_key(2**32 - 1)
    u = rng.pool_uniforms(key, *lanes, dtype)
    ids, sample = lanes[0], torch.full_like(lanes[0], 11)
    keys = rng.pixel_sample_keys(key, ids, sample)
    ub = rng.bounce_uniforms(keys, 5, dtype)
    jitter = rng.primary_jitter(keys, dtype)
    lkeys = rng.light_sample_keys(keys, 2)
    assert card_route.calls == {"pool": 1, "fold": 2, "bounce": 2}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(binding, "device_kind", lambda x: "cpu")
        want_u = rng.pool_uniforms(key, *lanes, dtype)
        want_keys = rng.pixel_sample_keys(key, ids, sample)
        want_ub = rng.bounce_uniforms(want_keys, 5, dtype)
        want_jitter = rng.primary_jitter(want_keys, dtype)
        want_lkeys = rng.light_sample_keys(want_keys, 2)
    assert card_route.calls == {"pool": 1, "fold": 2, "bounce": 2}
    assert u.shape == (rng.NUM_SLOTS, 300) and u.is_contiguous()
    assert ub.shape == (300, rng.NUM_SLOTS) and ub.stride() == want_ub.stride()
    for got, want in ((u, want_u), (ub, want_ub), (jitter, want_jitter), *zip(keys, want_keys),
                      *zip(lkeys, want_lkeys)):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_card_route_counts_launches(card_route):
    """One launch a call, counted in ``rng.LAUNCHES`` under the kernel's
    name and, for a float64 draw, its instance's; none in
    ``shade.LAUNCHES``."""
    lanes = _torch_lanes(*_pool_lanes(40, 3))
    key = rng.base_key(5)
    before, shade_before = collections.Counter(rng.LAUNCHES), dict(shade.LAUNCHES)
    for dtype in DTYPES:
        rng.pool_uniforms(key, *lanes, dtype)
        keys = rng.pixel_sample_keys(key, lanes[0], lanes[1])
        rng.primary_jitter(keys, dtype)
    rng.light_sample_keys(keys, 1)
    assert collections.Counter(rng.LAUNCHES) - before == {
        "rng_pool_uniforms": 1, "rng_pool_uniforms_f64": 1, "rng_fold": 3,
        "rng_bounce_uniforms": 1, "rng_bounce_uniforms_f64": 1}
    assert dict(shade.LAUNCHES) == shade_before
    assert card_route.calls == {"pool": 2, "fold": 3, "bounce": 2}


def test_card_route_rejects_bad_keys(card_route):
    """The card's route checks what the kernels read: int64 key words, 0-dim
    or one a lane, and int64 lane data."""
    lanes = _torch_lanes(*_pool_lanes(16, 4))
    key = rng.base_key(9)
    with pytest.raises(ValueError):
        rng.pixel_sample_keys(key, lanes[0].int(), lanes[1])
    with pytest.raises(ValueError):
        rng.pixel_sample_keys((key[0].expand(3), key[1].expand(3)), lanes[0], lanes[1])
    keys = rng.pixel_sample_keys(key, lanes[0], lanes[1])
    with pytest.raises(ValueError):
        rng.bounce_uniforms((keys[0].int(), keys[1]), 0)
    with pytest.raises(ValueError):
        rng.bounce_uniforms(keys, 0, torch.float16)
    with pytest.raises(ValueError):
        rng.light_sample_keys((key[0], key[1]), 1)
    assert card_route.calls == {"fold": 1}


def test_draw_launches_counted_but_do_not_place_spans(card_route):
    """A traced pass counts the draw's launches in ``rec.launches``; its span
    anchors (``launch_in``/``launch_out``, which ``ptbench/spans.py`` matches
    with the trace's intersection and shading kernels) leave them out."""
    from pathtrace_tpu_torch import profiler
    from ptbench import spans

    lanes = _torch_lanes(*_pool_lanes(32, 5))
    key = rng.base_key(3)
    profiler.clear()
    with profiler.tracing(), profiler.traced_pass("pool", "cpu"):
        with profiler.span("pool.rng"):
            rng.pool_uniforms(key, *lanes)
        with profiler.span("pool.bounce"):
            shade.LAUNCHES["fused_bounce_raygen"] += 1   # a placing launch
        with profiler.span("wave.rng"):
            rng.bounce_uniforms(rng.pixel_sample_keys(key, *lanes[:2]), 0)
    rec = profiler.passes()[-1]
    profiler.clear()
    assert rec.launches == {"rng_pool_uniforms": 1, "fused_bounce_raygen": 1, "rng_fold": 1,
                            "rng_bounce_uniforms": 1}
    assert rec.names == ["pool.pass", "pool.rng", "pool.bounce", "wave.rng"]
    assert (rec.launch_in, rec.launch_out) == ([0, 0, 0, 1], [1, 0, 1, 1])
    assert spans.owners(rec.launch_in, rec.launch_out) == [2]
