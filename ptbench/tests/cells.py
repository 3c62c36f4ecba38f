"""Small CPU stand-ins of the benchmark's cells: each cell's own files, cut
to a frame, a scene and a pool that a CPU test run holds."""

from __future__ import annotations

import copy

from ptbench import harness

SMALL = {
    "rtiow_1080p.pool": ({"width": 32, "height": 18}, {"seed": 3, "n_per_side": 2},
                         {"spp_per_pass": 2, "num_slots": 256, "trace_spp": 1}),
    "knot70k_1080p.pool": ({"width": 16, "height": 9}, {"n_tris": 4200},
                           {"spp_per_pass": 1, "num_slots": 64}),
    "rtiow_1080p.wave": ({"width": 32, "height": 18}, {"seed": 3, "n_per_side": 2}, {}),
}


def spec() -> dict:
    return harness.load_json(harness.BENCH_DIR.parent / "BENCHMARK.json")


def small_parts(workload: str, pixels: int = 64) -> dict:
    """The cell's parts with its frame, scene and pool cut down and its
    check's limits kept."""
    parts = copy.deepcopy(harness.cell_parts(spec(), workload))
    cfg, scene_params, traffic = SMALL[workload]
    parts["config"].update(cfg)
    parts["config"]["scene"]["params"] = scene_params
    parts["traffic"].update(traffic)
    parts["check"]["pixels"] = pixels
    return parts
