"""Readings that a cell's check limits are set from (never run by a
benchmark run):

    python3 ptbench/calibrate.py --workload rtiow_1080p.pool --passes 3 \\
        --seeds 11,12,13 --control-seeds 11,12,13

One process builds the cell's scene once. For each of ``--seeds`` it renders
``--passes`` window passes through the program at the cell's own load and
compares the framebuffer with the float32 reference at the check's pixels,
as a run does: the lower readings. For each of ``--control-seeds`` it puts
the reference computed in bfloat16, the nearest precision below the
configuration's float32, in the program's place and compares it the same
way: the upper readings. Prints one JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--passes", type=int, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    from ptbench import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    for line in readings(harness.cell_parts(spec, args.workload), args.passes,
                         [int(s) for s in args.seeds.split(",") if s],
                         [int(s) for s in args.control_seeds.split(",") if s], "cuda"):
        print(json.dumps(dict(workload=args.workload, **line)), flush=True)
    return 0


def readings(parts: dict, passes: int, seeds, control_seeds, device):
    """Yield the program's reading for each seed, then the control's."""
    import importlib

    import torch

    from ptbench import check, program, reference, scene

    cfg, traffic = parts["config"], parts["traffic"]
    desc = scene.build(cfg["scene"])
    system = program.build(desc, cfg, device)
    pixels = cfg["width"] * cfg["height"]
    n_check = int(parts["check"]["pixels"])
    engines = importlib.import_module(f"ptbench.engines.{traffic['engine']}")
    got = {}
    for seed in seeds:
        engine = engines.Engine(system, traffic, seed)
        t0 = time.perf_counter()
        for _ in range(passes):
            engine.window_pass()
        if device == "cuda":
            torch.cuda.synchronize()
        ids = check.pixel_sample(seed, pixels, n_check)
        fb = engine.framebuffer()
        got[seed] = (ids, *engine.samples(), fb[ids.to(fb.device)].cpu(),
                     time.perf_counter() - t0)
        del engine, fb
    del system
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    def ref(seed, ids, lo, hi, dtype):
        t0 = time.perf_counter()
        out = reference.render_pixels(
            desc, cfg["camera"], ids.to(device), lo, hi, width=cfg["width"],
            height=cfg["height"], seed=seed, integrator=cfg["integrator"],
            max_bounces=cfg["max_bounces"], dtype=dtype, device=device)
        return out, time.perf_counter() - t0

    want = {}
    for seed, (ids, lo, hi, fb, secs) in got.items():
        want[seed], ref_s = ref(seed, ids, lo, hi, torch.float32)
        yield {"side": "program", "seed": seed, "samples": [lo, hi], "render_s": secs,
               "reference_s": ref_s, **check.compare(fb, want[seed])}
    spp = int(traffic["spp_per_pass"])
    for seed in control_seeds:
        ids = check.pixel_sample(seed, pixels, n_check)
        lo, hi = spp, spp * (passes + 1)
        base = want[seed] if seed in want else ref(seed, ids, lo, hi, torch.float32)[0]
        low, ref_s = ref(seed, ids, lo, hi, torch.bfloat16)
        yield {"side": "control", "seed": seed, "samples": [lo, hi], "reference_s": ref_s,
               **check.compare(low, base)}


if __name__ == "__main__":
    sys.exit(main())
