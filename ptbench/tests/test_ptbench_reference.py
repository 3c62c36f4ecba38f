"""The plain reference against the port on the CPU (its kernels' plain
twins) at small sizes: the same samples of the same pixels agree to
rounding on every cell's path, and the check passes on a whole CPU run."""

from __future__ import annotations

import pytest
import torch

from ptbench import check, harness, reference
from ptbench.tests import cells


def test_threefry_draws_equal_the_programs():
    from pathtrace_tpu_torch.utils import rng

    pixels = torch.tensor([0, 1, 77, 2_073_599])
    samples = torch.tensor([0, 5, 1 << 20, 3])
    for seed in (0, 7, 2**31 + 99, 2**32 - 1):
        k0, k1 = reference.sample_keys(seed, pixels, samples)
        p0, p1 = rng.pixel_sample_keys(rng.base_key(seed), pixels, samples)
        assert torch.equal(k0, p0) and torch.equal(k1, p1)
        for vertex in (0, 3, 31):
            want = rng.per_slot_uniforms((p0, p1), torch.full_like(pixels, vertex)).T
            assert torch.equal(reference.uniforms(k0, k1, vertex), want)


@pytest.mark.parametrize("workload", sorted(cells.SMALL))
def test_whole_cpu_run_is_correct(workload):
    spec = cells.spec()
    result = harness.run_cell(spec, workload, 2**31 + 17, 0.3, False, device="cpu",
                              parts=cells.small_parts(workload))
    assert result["correct"], result["checks"]
    assert result["checks"]["l1_rel_err"]["value"] < 1e-6


def test_reference_sums_are_linear_in_the_sample_window():
    parts = cells.small_parts("rtiow_1080p.pool")
    cfg = parts["config"]
    from ptbench import scene

    desc = scene.build(cfg["scene"])
    kw = dict(width=cfg["width"], height=cfg["height"], seed=5, integrator="mis",
              max_bounces=cfg["max_bounces"])
    ids = check.pixel_sample(5, cfg["width"] * cfg["height"], 16)
    whole = reference.render_pixels(desc, cfg["camera"], ids, 0, 6, **kw)
    parts_ = (reference.render_pixels(desc, cfg["camera"], ids, 0, 2, **kw)
              + reference.render_pixels(desc, cfg["camera"], ids, 2, 6, **kw))
    assert torch.allclose(whole, parts_, rtol=1e-12, atol=0)
    assert (whole > 0).any()


@pytest.mark.parametrize("workload", ["rtiow_1080p.pool", "rtiow_1080p.wave"])
def test_traced_cpu_run_reports_its_host_and_counter_metrics(workload):
    result = harness.run_cell(cells.spec(), workload, 2**31 + 19, 0.2, True, device="cpu",
                              parts=cells.small_parts(workload))
    assert result["correct"], result["checks"]
    engine = cells.small_parts(workload)["traffic"]["engine"]
    want = {"trace.mrays_per_s"} | ({"pool.iter_ms", "pool.occupancy"} if engine == "pool"
                                    else {"wave.pass_ms_p50"})
    assert set(result["metrics"]) == want     # no device: no device-trace metric
    assert result["device"]["busy_s"] == 0 and result["breakdown"]["device_ops"] == []


def test_traced_pool_passes_take_the_mix_trace_spp(monkeypatch):
    """A pool mix's ``trace_spp`` sizes the three side passes (device-traced,
    host-traced, replayed), not the warm-up or the window's passes."""
    from pathtrace_tpu_torch import pool

    calls, original = [], pool.render_pool

    def spy(*args, **kw):
        calls.append((kw["sample_offset"], kw["spp"]))
        return original(*args, **kw)

    monkeypatch.setattr(pool, "render_pool", spy)
    parts = cells.small_parts("rtiow_1080p.pool")
    assert (parts["traffic"]["spp_per_pass"], parts["traffic"]["trace_spp"]) == (2, 1)
    result = harness.run_cell(cells.spec(), "rtiow_1080p.pool", 2**31 + 23, 0.0, True,
                              device="cpu", parts=parts)
    assert result["correct"], result["checks"]
    assert calls == [(0, 1), (2, 2), (4, 1), (4, 1), (4, 1)]
