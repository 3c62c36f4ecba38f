"""Run one cell of the benchmark and print its result as one JSON line.

    python3 ptbench/run.py --workload rtiow_1080p.pool --seed 7 --seconds 30 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, ``ptbench/`` and
the program, ``pathtrace_tpu_torch``, on a machine with an NVIDIA GPU. With
``--trace 0`` the line's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, read from a profiled pass after the
window. Every run checks the window's framebuffer against the plain
reference and prints the compared numbers with their limits as the last
lines of standard error and under ``checks`` in the line.

The program's kernel library is built in ``pathtrace_tpu_torch/_build/``
(the first run of a checkout builds it). Exits non-zero with no line when
there is no GPU, when JAX or the JAX package was loaded (in any rank's
process), and when a rank of a multi-rank cell failed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pathtrace_tpu")


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))

    import torch

    from ptbench import harness, ranks

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    parts = harness.cell_parts(spec, args.workload)
    chips = parts["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ptbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                                  bool(args.trace), device="cuda", t_start=T_START, parts=parts)
    except ranks.RanksFailed as e:
        print(f"ptbench: {e}; no result", file=sys.stderr)
        return ranks.EXIT_RANK_FAILED
    bad = loaded_forbidden()
    if bad:
        print(f"ptbench: the process loaded {bad}; nothing of JAX may run", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                        **result["device"], "power_limit": power_limit()}
    result["checks"] = result.pop("checks")   # the compared numbers come last
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
