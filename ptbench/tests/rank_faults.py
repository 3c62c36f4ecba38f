"""Faults planted in the ranks of a multi-rank run (``parts["plant"]``,
``harness.planted``): each ``function(rank)`` returns a context manager held
around the rank's run in every rank's process, rank 0's included."""

from __future__ import annotations

import contextlib
import os
import signal
import sys
import types
from unittest import mock

import numpy as np
import torch

from pathtrace_tpu_torch.parallel import distributed, sharding


@contextlib.contextmanager
def zero_rank1_block(rank: int):
    """Rank 1's pool adds nothing: its frames' radiance sums are zero."""
    original = sharding._pool_loop

    def zero(*args, **kw):
        image, counters, iters = original(*args, **kw)
        return torch.zeros_like(image), counters, iters

    with mock.patch.object(sharding, "_pool_loop", zero) if rank == 1 else contextlib.nullcontext():
        yield


@contextlib.contextmanager
def no_gather(rank: int):
    """The frames' gather left out on every rank: each stands its own block
    for every rank's."""
    def own_block(self, x):
        x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
        return np.stack([x] * self.shape["dp"])

    with mock.patch.object(distributed.Mesh, "gather_dp", own_block):
        yield


@contextlib.contextmanager
def swap_frames(rank: int):
    """Frames 0 and 2 (rank 0's first, rank 1's first) change places."""
    original = sharding.frames_pool_sharded

    def swapped(*args, **kw):
        frames, counters, iters = original(*args, **kw)
        return frames[[2, 1, 0]], counters, iters

    with mock.patch.object(sharding, "frames_pool_sharded", swapped):
        yield


@contextlib.contextmanager
def exit_at_once(rank: int):
    """Rank 1 exits non-zero before it joins the group."""
    if rank == 1:
        os._exit(1)
    yield


@contextlib.contextmanager
def killed_mid_window(rank: int):
    """Rank 1 is killed in its second window pass (its third render)."""
    original = sharding.frames_pool_sharded
    calls = []

    def killed(*args, **kw):
        calls.append(1)
        if len(calls) == 3:
            os.kill(os.getpid(), signal.SIGKILL)
        return original(*args, **kw)

    with mock.patch.object(sharding, "frames_pool_sharded", killed) if rank == 1 \
            else contextlib.nullcontext():
        yield


@contextlib.contextmanager
def jax_in_rank1(rank: int):
    """Rank 1 holds a module named ``jax`` once its part of the run is over
    (a stand-in put in ``sys.modules``, as an import would)."""
    try:
        yield
    finally:
        if rank == 1:
            sys.modules["jax"] = types.ModuleType("jax")
