"""Counter-based RNG: bit-exact threefry2x32 in plain torch ops.

Counterpart of ``pathtrace_tpu/utils/rng.py`` and of the pool's per-slot draw
(``pathtrace_tpu/pool.py:_per_slot_uniforms``). Every random decision has the
coordinate ``(pixel, sample, bounce, slot)``; this module reproduces JAX's
threefry2x32 key derivation and ``uniform`` draw bit for bit (the
``jax_threefry_partitionable`` layout), so the port and the JAX package trace
the same paths from the same seed and every comparison between them can be
made sample for sample.

A key is a pair of 32-bit words. Torch's uint32 coverage is thin, so words
are carried in int64 tensors masked to 32 bits.

The draws have a hand-written CUDA kernel, ``csrc/rng.cu``, and the torch
code here is its twin. :func:`pool_uniforms`, :func:`pixel_sample_keys`,
:func:`bounce_uniforms` (so :func:`primary_jitter`) and
:func:`light_sample_keys` dispatch on the device of their inputs, as
``ops/shade.py`` does: CPU tensors run the torch code, CUDA tensors launch
the kernel, one launch a call (the pool's whole draw of an iteration in
one), each counted in :data:`LAUNCHES` under the kernel's name. Integers
only, so both give the same bits. :func:`threefry2x32`, :func:`fold_in` and
:func:`per_slot_uniforms` are the twin's parts and run torch ops on any
device.
"""

from __future__ import annotations

import collections

import torch

from .. import profiler
from ..kernels import binding

# Fixed slot layout of the per-bounce uniform vector (pathtrace_tpu/utils/rng.py).
SLOT_LIGHT_SELECT = 0
SLOT_LIGHT_U = 1
SLOT_LIGHT_V = 2
SLOT_BSDF_U = 3
SLOT_BSDF_V = 4
SLOT_FRESNEL = 5
SLOT_RR = 6
SLOT_JITTER_X = 7
SLOT_JITTER_Y = 8
NUM_SLOTS = 9

_MASK = 0xFFFFFFFF

# Launches of the draw's kernels by name, a float64 instance with ``_f64``
# appended. Kept apart from ``ops/shade.py``'s ``LAUNCHES``, whose counts
# place the profiler's spans on the device trace; ``profiler.PassRecord``
# adds both into a pass's ``launches``.
LAUNCHES: collections.Counter = collections.Counter()
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 block (20 rounds) on int64 tensors holding uint32 words.

    ``k0, k1`` (the key) and ``x0, x1`` (the counter) broadcast together;
    returns the two output words.
    """
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def base_key(seed: int, device=None):
    """``jax.random.key(seed)`` for ``0 <= seed < 2**32``: the words ``(0, seed)``."""
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed must fit in 32 bits, got {seed}")
    with profiler.span("sync.h2d"):     # a copy from the host
        k = torch.tensor([0, seed], dtype=torch.int64, device=device)
    return k[0], k[1]


def fold_in(key, data: torch.Tensor):
    """``jax.random.fold_in``: threefry of the counter ``(0, data)`` under ``key``."""
    k0, k1 = key
    return threefry2x32(k0, k1, torch.zeros_like(data), data & _MASK)


def _on_one_device(*specs) -> torch.device:
    """Checks each ``(name, tensor, dtype, shape)`` (``binding.check``; a None
    tensor is skipped) and that all lie on one device, which it returns."""
    device = None
    for name, x, dtype, shape in specs:
        if x is None:
            continue
        binding.check(name, x, dtype, shape)
        device = x.device if device is None else device
        if x.device != device:
            raise ValueError(f"{name} on {x.device}, not {device}")
    return device


def _fold_kernel(keys, data0, value0: int = 0, data1=None):
    """The key words ``(2, N)`` of ``keys`` folded with ``data0`` (None:
    ``value0`` for every lane), then with ``data1`` (None: no second fold),
    in one launch of ``pt_rng_fold``. ``keys``: two int64 words, 0-dim (one
    key for every lane, with ``data0``) or ``(N,)``; the data int64 ``(N,)``."""
    i64 = torch.int64
    n = (keys[0] if data0 is None else data0).numel()
    key_shape = () if data0 is not None and keys[0].dim() == 0 else (n,)
    device = _on_one_device(("key[0]", keys[0], i64, key_shape),
                            ("key[1]", keys[1], i64, key_shape),
                            ("data", data0, i64, (n,)), ("data", data1, i64, (n,)))
    out = torch.empty((2, n), dtype=i64, device=device)
    binding.launch_rng_fold(keys, len(key_shape), data0, value0, data1, out)
    LAUNCHES["rng_fold"] += 1
    return out[0], out[1]


def pixel_sample_keys(key, pixel_ids: torch.Tensor, sample_idx: torch.Tensor):
    """One key per ray: ``fold_in(fold_in(key, pixel), sample)``. On the
    card ``pixel_ids`` and ``sample_idx`` are int64 ``(N,)`` and the two
    folds are one launch."""
    if binding.device_kind(pixel_ids) == "cpu":
        return fold_in(fold_in(key, pixel_ids), sample_idx)
    return _fold_kernel(key, pixel_ids, data1=sample_idx)


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """JAX's uniform mapping: the top 23 bits as a mantissa in [1, 2), minus 1."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def bits_to_unit_double(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """JAX's float64 uniform from the two threefry words: the 64-bit word
    ``(w0 << 32) | w1``, its top 52 bits as a mantissa in [1, 2), minus 1.
    The mantissa is built as ``(w0 << 20) | (w1 >> 12)``: the whole word
    would not fit in int64, whose ``>>`` is arithmetic."""
    mant = (w0 << 20) | (w1 >> 12) | 0x3FF0000000000000
    return mant.view(torch.float64) - 1.0


def per_slot_uniforms(keys, bounces: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The pool's per-iteration draw: ``uniform(fold_in(key, bounce), (9,),
    dtype)`` for every lane, in kernel layout ``(NUM_SLOTS, S)``; ``dtype``
    float32 (the words' XOR, as JAX draws 32 bits) or float64 (both words)."""
    dtype = _uniform_dtype(dtype)
    k0, k1 = fold_in(keys, bounces)
    slots = torch.arange(NUM_SLOTS, dtype=torch.int64, device=k0.device)[:, None]
    b0, b1 = threefry2x32(k0[None, :], k1[None, :], torch.zeros_like(slots), slots)
    if dtype == torch.float64:
        return bits_to_unit_double(b0, b1)
    return bits_to_unit_float(b0 ^ b1)


def _uniform_dtype(dtype) -> torch.dtype:
    """``dtype`` if the draws come in it (float32, float64), else raises."""
    if dtype not in binding.SUFFIX:
        raise ValueError(f"uniforms come in float32 or float64, not {dtype}")
    return dtype


def pool_uniforms(key, pixel: torch.Tensor, sample: torch.Tensor, bounce: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """The pool's whole draw of an iteration, ``(NUM_SLOTS, S)``: bit for bit
    ``per_slot_uniforms(pixel_sample_keys(key, pixel, sample), bounce,
    dtype)``. ``key`` is the base key (:func:`base_key`), ``pixel`` and
    ``sample`` int64 ``(S,)``, ``bounce`` int32 ``(S,)``, all on one device;
    on the card one launch of ``pt_rng_pool_uniforms``."""
    dtype = _uniform_dtype(dtype)
    S, i64 = pixel.numel(), torch.int64
    device = _on_one_device(("pixel", pixel, i64, (S,)), ("sample", sample, i64, (S,)),
                            ("bounce", bounce, torch.int32, (S,)), ("key[0]", key[0], i64, ()),
                            ("key[1]", key[1], i64, ()))
    if binding.device_kind(pixel) == "cpu":
        return per_slot_uniforms(pixel_sample_keys(key, pixel, sample), bounce.long(), dtype)

    u = torch.empty((NUM_SLOTS, S), dtype=dtype, device=device)
    binding.launch_rng_pool_uniforms(key, pixel, sample, bounce, u)
    LAUNCHES["rng_pool_uniforms" + binding.SUFFIX[dtype]] += 1
    return u


def bounce_uniforms(keys, bounce: int, dtype=torch.float32) -> torch.Tensor:
    """The wave engine's draw for one bounce: the same stream as
    :func:`per_slot_uniforms`, laid out ``(N, NUM_SLOTS)`` (the transpose of
    a ``(NUM_SLOTS, N)`` draw). On the card ``keys`` are two int64 ``(N,)``
    words and the draw is one launch of ``pt_rng_bounce_uniforms``."""
    if binding.device_kind(keys[0]) == "cpu":
        return per_slot_uniforms(keys, torch.full_like(keys[0], bounce), dtype).T
    dtype = _uniform_dtype(dtype)
    n = keys[0].numel()
    device = _on_one_device(("keys[0]", keys[0], torch.int64, (n,)),
                            ("keys[1]", keys[1], torch.int64, (n,)))
    u = torch.empty((NUM_SLOTS, n), dtype=dtype, device=device)
    binding.launch_rng_bounce_uniforms(keys, bounce, u)
    LAUNCHES["rng_bounce_uniforms" + binding.SUFFIX[dtype]] += 1
    return u.T


def primary_jitter(keys, dtype=torch.float32) -> torch.Tensor:
    """Sub-pixel jitter ``(N, 2)``: slots 7-8 of the bounce-0 draw."""
    return bounce_uniforms(keys, 0, dtype)[:, SLOT_JITTER_X:SLOT_JITTER_Y + 1]


# Key-fold namespace of NEE light samples beyond the first: sample j draws
# from fold_in(key, NEE_FOLD_BASE + j); sample 0 keeps the unfolded key.
NEE_FOLD_BASE = 0x4E4545   # "NEE"


def light_sample_keys(keys, j: int):
    """Per-ray keys of NEE light sample ``j >= 1``: ``fold_in(key, NEE_FOLD_BASE + j)``
    (on the card one launch, ``keys`` two int64 ``(N,)`` words)."""
    if binding.device_kind(keys[0]) == "cpu":
        return fold_in(keys, torch.full_like(keys[0], NEE_FOLD_BASE + j))
    return _fold_kernel(keys, None, NEE_FOLD_BASE + j)
