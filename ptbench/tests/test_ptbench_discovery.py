"""Cells, configurations, traffic mixes and metrics are found by name: each
cell of BENCHMARK.json resolves to its files, and one added as files alone,
from a temporary copy, runs without an edit to any file already there."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from ptbench import harness
from ptbench.tests import cells


def test_every_cell_resolves_to_its_files():
    spec = cells.spec()
    for wl in spec["workloads"]:
        parts = harness.cell_parts(spec, wl["name"])
        assert parts["config"]["name"] == wl["config"]
        assert parts["traffic"]["engine"] in ("pool", "wave")
        assert set(parts["check"]["limits"]) == {"l1_rel_err", "median_rel_err"}
        for m in parts["end_to_end"] + parts["per_layer"]:
            assert callable(harness.metric_module(m["name"]).read)
        assert {m["name"] for m in parts["end_to_end"]} >= {"setup_s", "msamples_per_s"}
        assert parts["per_layer"]


def test_metric_list_of_each_cell_follows_its_workloads_key():
    spec = cells.spec()
    parts = harness.cell_parts(spec, "knot70k_1080p.pool")
    names = {m["name"] for m in parts["per_layer"]}
    assert "bvh_closest_roofline" in names and "fused_bounce_raygen_roofline" not in names
    assert "wave.pass_ms_p50" not in names and "pool.iter_ms" in names


def test_a_cell_added_as_files_alone_runs(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "ptbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = cells.spec()
    (root / "ptbench" / "configs" / "field_small.json").write_text(json.dumps({
        "name": "field_small", "source": "a test", "width": 24, "height": 12,
        "scene": {"recipe": "sphere_field", "params": {"seed": 5, "n_per_side": 1}},
        "camera": {"origin": [13.0, 2.0, 3.0], "target": [0.0, 0.0, 0.0],
                   "up": [0.0, 1.0, 0.0], "fov": 30.0},
        "integrator": "nee", "max_bounces": 6, "dtype": "float32", "method": "auto"}))
    (root / "ptbench" / "traffic" / "pool_1spp_64.json").write_text(json.dumps(
        {"engine": "pool", "spp_per_pass": 1, "num_slots": 64}))
    (root / "ptbench" / "checks" / "field_small.pool.json").write_text(json.dumps(
        {"pixels": 32, "limits": {"l1_rel_err": 1e-3, "median_rel_err": 1e-5}}))
    (root / "ptbench" / "metrics" / "pool.passes.py").write_text(
        "def read(rec):\n    return float(len(rec['walls']))\n")
    spec["configs"].append({"name": "field_small", "source": "a test", "reduced": [],
                            "file": "ptbench/configs/field_small.json", "why": "a test"})
    spec["workloads"].append({"name": "field_small.pool", "config": "field_small",
                              "traffic": "pool_1spp_64", "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "pool.passes", "unit": "passes", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["field_small.pool"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "BENCH_DIR", root / "ptbench")

    torch.manual_seed(0)
    spec = harness.load_json(root / "BENCHMARK.json")
    result = harness.run_cell(spec, "field_small.pool", 11, 0.2, False, device="cpu")
    assert result["correct"], result["checks"]
    assert result["metrics"]["pool.passes"]["value"] >= 1
    assert {"setup_s", "msamples_per_s"} <= set(result["metrics"])


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.cell_parts(cells.spec(), "no_such.cell")
