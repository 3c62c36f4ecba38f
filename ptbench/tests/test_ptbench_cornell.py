"""The Cornell box cell on the CPU: its recipe gives the port's own
``cornell_box()`` and its camera ``cornell_camera(400, 400)``, and a small
CPU run of the cell (the kernels' plain twins) passes its check."""

from __future__ import annotations

import copy
import dataclasses

import torch

from ptbench import harness, program, scene
from ptbench.tests import cells


def _parts(width: int = 400, height: int = 400) -> dict:
    parts = copy.deepcopy(harness.cell_parts(cells.spec(), "cornell400.pool"))
    parts["config"].update(width=width, height=height)
    return parts


def test_the_recipe_builds_the_ports_cornell_box_and_camera():
    from pathtrace_tpu_torch.models import scenes

    cfg = _parts()["config"]
    system = program.build(scene.build(cfg["scene"]), cfg, "cpu")
    want = scenes.cornell_box(device="cpu")
    assert (want.tri_v0.shape[0], want.sph_center.shape[0]) == (12, 1)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(system.scene, f.name)
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b, f.name

    cam = scenes.cornell_camera(400, 400, device="cpu")
    px = torch.arange(0, 400, 7)
    py = torch.arange(0, 400, 7).flip(0)
    jitter = torch.rand((px.shape[0], 2), generator=torch.Generator().manual_seed(3))
    for a, b in zip(cam.generate_rays(px, py, jitter),
                    system.camera.generate_rays(px, py, jitter)):
        torch.testing.assert_close(a, b, rtol=2 ** -22, atol=2 ** -22)


def test_a_small_cpu_run_of_the_cell_is_correct():
    parts = _parts(16, 16)
    parts["traffic"].update(num_slots=256, spp_per_pass=2, trace_spp=1)
    parts["check"]["pixels"] = 64
    result = harness.run_cell(cells.spec(), "cornell400.pool", 2**31 + 29, 0.3, False,
                              device="cpu", parts=parts)
    assert result["correct"], result["checks"]
    assert result["checks"]["l1_rel_err"]["value"] < 1e-6
