"""Full-resolution parity of the port against the pinned oracle golden.

Counterpart of ``examples/parity_anchor.py``. Renders the reference workload
(the Cornell box at 400x400, MIS, 64 bounces, seed 0) through the port's
production renderer, ``pool.render_pool`` with its defaults but the slot
count, in progressive passes over ``sample_offset``, and compares the mean
image with the 8,192-spp float64 oracle golden
(``tests/golden/oracle_cornell_400_mis_8192.npz``).

Run on a GPU, in a process of its own (16,384 spp took 1,205 s on an H100
80GB HBM3 at 700 W):

    python3 tools/parity_anchor.py [--spp 16384] [--budget-s 1300]

Passes: a first pass of 64 spp times the frame, the next one fills up to
1,024, and every later pass is 1,024 spp, until ``--spp`` is reached or the
next pass would end past ``--budget-s`` seconds of rendering. The pool has
one slot a pixel (160,000), so the whole frame is one chunk: at 64 spp on
an H100 an iteration took about as long as at the default 32,768 slots
(8.3 ms against 8.8 ms) and the pass 2.9x less time. Every draw is keyed
by (pixel, sample, bounce), so the image depends neither on the passes
nor on the slot count.

Prints a line a pass, then the RMSE of the pre-gamma image, its Rec. 709
luminance RMSE, the channel-mean bias, the spp reached, the render's wall
time and traced Mrays/s, the predicted Monte-Carlo floor
sigma * sqrt(1/spp + 1/8192) (sigma = 0.4846, from the JAX pool's 0.006558
at 16,384 spp in ``docs/PARITY.md``), the card's ``nvidia-smi`` name and
power limit, and last one JSON line with all of it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GOLDEN = os.path.join(ROOT, "tests", "golden", "oracle_cornell_400_mis_8192.npz")
GOLDEN_SPP = 8192
SIGMA = 0.4846       # per-sample sigma of the frame: 0.006558 / sqrt(1/16384 + 1/8192)
LUMA = np.array([0.2126, 0.7152, 0.0722])
W = H = 400
SLOTS = W * H        # one slot a pixel: the whole frame is one chunk
FIRST_PASS, PASS_SPP = 64, 1024


def floor(spp: int) -> float:
    """The RMSE two independent renders at ``spp`` and the golden's 8,192
    spp leave from noise alone."""
    return SIGMA * math.sqrt(1.0 / spp + 1.0 / GOLDEN_SPP)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    import torch

    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.pool import ray_count, render_pool

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--spp", type=int, default=16384, help="samples a pixel to reach")
    p.add_argument("--budget-s", type=float, default=1300.0,
                   help="start no pass that would end past this many seconds")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("parity_anchor: no CUDA device is available", file=sys.stderr)
        return 2
    smi = card()

    golden = np.load(GOLDEN)["image"]
    scene, camera = scenes.cornell_box(), scenes.cornell_camera(W, H)
    acc = torch.zeros((W * H, 3), dtype=torch.float64, device=scene.device)
    done, rays, wall = 0, 0, 0.0
    while done < args.spp:
        n = min(FIRST_PASS if done == 0 else PASS_SPP - done % PASS_SPP, args.spp - done)
        if done and wall + wall / done * n > args.budget_s:
            break
        t0 = time.perf_counter()
        img, counters, iters = render_pool(scene, camera, width=W, height=H, spp=n,
                                           integrator="mis", max_bounces=64,
                                           num_slots=SLOTS, seed=0, sample_offset=done)
        acc += img.double()
        pass_rays = ray_count(counters)     # a host transfer: the pass is done
        dt = time.perf_counter() - t0
        done, rays, wall = done + n, rays + pass_rays, wall + dt
        print(f"pass {done - n}..{done} spp: {dt:.2f} s, {iters} iterations, "
              f"{pass_rays / dt / 1e6:.2f} Mrays/s (total {wall:.1f} s)", flush=True)

    mean = (acc / done).cpu().numpy().reshape(H, W, 3)
    diff = mean - golden
    result = {
        "frame": f"cornell {W}x{H} MIS depth 64, pool, {SLOTS} slots",
        "spp": done, "rmse": float(np.sqrt((diff ** 2).mean())),
        "luminance_rmse": float(np.sqrt(((diff @ LUMA) ** 2).mean())),
        "mean_bias_rgb": diff.reshape(-1, 3).mean(axis=0).tolist(),
        "floor": floor(done), "wall_s": wall, "rays": rays, "mrays_per_s": rays / wall / 1e6,
        "finite": bool(np.isfinite(mean).all()), "card": smi,
    }
    result["rmse_over_floor"] = result["rmse"] / result["floor"]
    print(f"spp={done}  RMSE={result['rmse']:.6f}  luminance RMSE="
          f"{result['luminance_rmse']:.6f}  floor={result['floor']:.6f} "
          f"(x{result['rmse_over_floor']:.3f})")
    print(f"mean channel bias: {result['mean_bias_rgb']}")
    print(f"wall {wall:.1f} s, {rays} rays, {result['mrays_per_s']:.2f} Mrays/s")
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
