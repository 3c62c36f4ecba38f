"""A run with the timed path broken underneath comes out not correct: the
harness's look for a GPU is skipped and the rest of a run is driven on the
CPU, at each cell's small stand-in, with each fault a renderer's pass can
have planted in the program's entry point:

* ``unchanged``: a pass returns the state it was given (adds nothing);
* ``half``: half of a pass's work left out and the mean taken over the rest
  (the pool: half its samples, doubled; the wave: half its pixels, each
  given the mean of the others);
* ``altered``: a pass's answer altered where it is produced (its radiance
  scaled by 1.01).

There is one chip and no exchange between chips to leave out."""

from __future__ import annotations

import importlib

import pytest
import torch

from ptbench import harness
from ptbench.tests import cells

pool = importlib.import_module("pathtrace_tpu_torch.pool")
render = importlib.import_module("pathtrace_tpu_torch.render")
FAULTS = ("unchanged", "half", "altered")


def _broken_pool(fault: str):
    original = pool.render_pool
    calls = []

    def render_pool(*args, **kw):
        calls.append(1)
        if len(calls) != 2:          # the warm-up, and the window's later passes
            return original(*args, **kw)
        if fault == "half":
            image, counters, iters = original(*args, **dict(kw, spp=kw["spp"] // 2))
            return image * 2.0, counters, iters
        image, counters, iters = original(*args, **kw)
        return (torch.zeros_like(image) if fault == "unchanged" else image * 1.01,
                counters, iters)

    return render_pool


def _broken_render(fault: str):
    original = render.render
    calls = []

    def broken(scene, camera, config, state=None, progress_callback=None):
        calls.append(1)
        out = original(scene, camera, config, state, progress_callback)
        if len(calls) != 2:
            return out
        delta = out.image_sum - state.image_sum
        if fault == "unchanged":
            delta = torch.zeros_like(delta)
        elif fault == "half":
            flat = delta.reshape(-1, 3).clone()
            flat[1::2] = flat[0::2].mean(dim=0)
            delta = flat.reshape(delta.shape)
        else:
            delta = delta * 1.01
        return render.RenderState(state.image_sum + delta, out.num_samples, out.ray_queries)

    return broken


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", sorted(cells.SMALL))
def test_a_broken_pass_is_not_correct(workload, fault, monkeypatch):
    parts = cells.small_parts(workload)
    if parts["traffic"]["engine"] == "pool":
        parts["traffic"]["spp_per_pass"] = 2
        monkeypatch.setattr(pool, "render_pool", _broken_pool(fault))
    else:
        monkeypatch.setattr(render, "render", _broken_render(fault))
    result = harness.run_cell(cells.spec(), workload, 2**31 + 3, 0.0, False, device="cpu",
                              parts=parts)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", sorted(cells.SMALL))
def test_the_same_run_unbroken_is_correct(workload):
    parts = cells.small_parts(workload)
    if parts["traffic"]["engine"] == "pool":
        parts["traffic"]["spp_per_pass"] = 2
    result = harness.run_cell(cells.spec(), workload, 2**31 + 3, 0.0, False, device="cpu",
                              parts=parts)
    assert result["correct"], result["checks"]
