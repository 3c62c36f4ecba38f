"""Check the program's spans on the card, for benchmark cells.

    python3 tools/trace_spans.py --seed 5 --workload cornell400.pool [--workload ...]

For each cell (``ptbench``'s files: configuration, traffic, scene), after one
warm pass at the cell's shapes, on the mix's side passes (``trace_spp``):

- ``detect``: a pass started inside a ``torch.profiler`` session with CUDA
  activity only is recorded (the benchmark's device-traced pass);
- ``cost``: side passes with tracing off and under ``profiler.tracing()``
  without a profiler session, in turns (off, on, on, off, off, on): walls, and the
  host ms an iteration (pool) or a bounce (wave); and the host us a span
  costs off and on (10,000 empty spans);
- ``profiled``: side passes under a profiler session with CUDA activity
  only (the benchmark's device-traced pass), with the spans recorded and with
  them left out (as a program without them runs), in turns (on, off, off,
  on): walls;
- ``clock``: one side pass under a profiler session with CPU and CUDA
  activity, its chrome trace exported: the trace's ``baseTimeNanoseconds``
  against the base ``ptbench/spans.py`` recovers from the spans and the
  kernels they launched, and each span's host start and end against its
  ``user_annotation`` event (us);
- ``syncs``: the CUDA runtime calls of that pass that block the host
  (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
  ``cudaEventSynchronize``), counted by the innermost program span around
  them, and the pass's device operations in the host-traced trace;
- ``device_work``: ``profiler.device_work`` over a side pass with spans
  recorded and with them left out: device ms and operations.

Prints a JSON line a cell on standard output, and each check's result as it
ends on standard error.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import importlib
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from pathtrace_tpu_torch import profiler  # noqa: E402
from ptbench import harness, program, scene, spans  # noqa: E402

BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def sync():
    torch.cuda.synchronize()


def timed(engine, first):
    sync()
    t0 = time.perf_counter()
    stats = engine.side_pass(first)
    sync()
    return time.perf_counter() - t0, stats


def steps(rec):
    return rec.counts.get("pool.iter", 0) + rec.counts.get("wave.bounce", 0)


def cost(engine, first):
    """Walls off and on in turns (off, on, on, off, off, on), steps from the
    on passes."""
    walls, recs = {"off": [], "on": []}, []
    for k, mode in enumerate(("off", "on", "on", "off", "off", "on")):
        ctx = profiler.tracing() if mode == "on" else contextlib.nullcontext()
        with ctx:
            wall, _ = timed(engine, first + k * engine.side_spp)
        walls[mode].append(wall)
        if mode == "on":
            recs.append(profiler.passes()[-1])
    n = statistics.mean(steps(r) for r in recs)
    per = {m: [1e3 * w / n for w in ws] for m, ws in walls.items()}

    def empty_spans(on):
        ctx = profiler.tracing() if on else contextlib.nullcontext()
        with ctx, profiler.traced_pass("pool", engine.sys.scene.device):
            sync()
            t0 = time.perf_counter()
            for _ in range(10_000):
                with profiler.span("probe"):
                    pass
            return (time.perf_counter() - t0) / 10_000 * 1e6

    return {"walls_s": walls, "steps": n, "ms_a_step": per,
            "span_us_off": empty_spans(False), "span_us_on": empty_spans(True)}


def profiled(engine, first):
    """Device-traced side passes with and without the spans, in turns."""
    from torch.profiler import ProfilerActivity, profile

    walls = {"on": [], "off": []}
    active = profiler._profiler_active
    for k, mode in enumerate(("on", "off", "off", "on")):
        if mode == "off":
            profiler._profiler_active = lambda: False
        try:
            with profile(activities=[ProfilerActivity.CUDA]):
                wall, _ = timed(engine, first + k * engine.side_spp)
        finally:
            profiler._profiler_active = active
        walls[mode].append(wall)
    return {"walls_s": walls}


def detect(engine, first):
    from torch.profiler import ProfilerActivity, profile

    profiler.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        engine.side_pass(first)
        sync()
    recs = profiler.passes()
    return {"recorded": len(recs) == 1, "profiled": bool(recs and recs[0].profiled)}


def clock(engine, first):
    """One host-traced pass: base, alignment and the host's blocking calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.side_pass(first)
        sync()
    rec = profiler.passes()[-1]
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    base = int(doc["baseTimeNanoseconds"])
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    del doc
    names = set(rec.names)
    ann = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in names:
            ann[e["name"]].append(e)
    for v in ann.values():
        v.sort(key=lambda e: e["ts"])
    seen = collections.Counter()
    d_start, d_end, matched = [], [], []
    for i, name in enumerate(rec.names):
        k = seen[name]
        seen[name] += 1
        if k >= len(ann[name]):
            continue
        e = ann[name][k]
        a_ns = base + round(e["ts"] * 1e3)
        b_ns = base + round((e["ts"] + e["dur"]) * 1e3)
        d_start.append((a_ns - rec.start_ns[i]) / 1e3)
        d_end.append((rec.end_ns[i] - b_ns) / 1e3)
        matched.append((i, e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6))

    # The base the readers recover, from this trace's kernels and their spans.
    hand_rx = spans._hand_pattern()
    kernels = sorted(((e["ts"] * 1e-6, e["name"]) for e in events
                      if e.get("cat") == "kernel"), key=lambda x: x[0])
    hand = [k for k in kernels if hand_rx.search(k[1])]
    own = spans.owners(rec.launch_in, rec.launch_out)
    pairs = [(rec.start_ns[i], k[0]) for k, i in zip(hand, own)]
    got_base, lag = spans.recover_base(pairs) if pairs and len(hand) == len(own) else (None, None)

    # Launch to kernel start by the runtime call's correlation id: where the
    # trace puts each kernel against the host call that launched it.
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    gaps = sorted(e["ts"] - launch[e["args"]["correlation"]] for e in events
                  if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in launch)

    # Blocking runtime calls by the innermost program span (annotation) around them.
    tid = next(e["tid"] for e in events if e.get("cat") == "user_annotation")
    mine = sorted(((a, b, rec.names[i]) for i, a, b in matched), key=lambda x: x[0])
    starts = [m[0] for m in mine]
    blocking = collections.Counter()
    blocking_ms = collections.Counter()
    for e in events:
        if e.get("cat") == "cuda_runtime" and e["name"] in BLOCKING and e.get("tid") == tid:
            t = e["ts"] * 1e-6
            k = bisect.bisect_right(starts, t) - 1
            where = "outside"
            while k >= 0:
                if mine[k][1] >= t:
                    where = mine[k][2]
                    break
                k -= 1
            blocking[f"{e['name']} in {where}"] += 1
            blocking_ms[f"{e['name']} in {where}"] += e.get("dur", 0.0) / 1e3

    def stats(xs):
        xs = sorted(abs(x) for x in xs)
        return {"n": len(xs), "median_us": xs[len(xs) // 2] if xs else None,
                "p99_us": xs[int(0.99 * (len(xs) - 1))] if xs else None,
                "max_us": xs[-1] if xs else None}

    out = {"base_ns": base, "base_whole_seconds": base % spans.SECOND_NS == 0,
           "recovered_base_ns": got_base, "recovered_equal": got_base == base,
           "least_lag_us": None if lag is None else lag / 1e3,
           "launch_to_kernel_us": {"n": len(gaps), "min": gaps[0] if gaps else None,
                                   "median": gaps[len(gaps) // 2] if gaps else None,
                                   "max": gaps[-1] if gaps else None},
           "start_error": stats(d_start), "end_error": stats(d_end),
           "first_start_error_us": d_start[0] if d_start else None,
           "spans": len(rec.names), "annotations_matched": len(matched),
           "device_ops_host_traced": sum(1 for e in events
                                         if e.get("cat") in ("kernel", "gpu_memcpy",
                                                             "gpu_memset")),
           "hand_kernels": len(hand), "hand_launches": len(own),
           "steps": steps(rec), "syncs": rec.syncs,
           "blocking_calls": dict(blocking.most_common()),
           "blocking_ms": {k: round(v, 3) for k, v in blocking_ms.most_common()}}
    return out


def device_work(engine, first):
    names = [k.removesuffix("_kernel")
             for k in harness.metric_module("kernels.device_share").KERNELS]
    with_spans = profiler.device_work(lambda: engine.side_pass(first), names)
    active = profiler._profiler_active
    profiler._profiler_active = lambda: False
    try:
        without = profiler.device_work(lambda: engine.side_pass(first), names)
    finally:
        profiler._profiler_active = active
    return {"with_spans": with_spans[:2], "without": without[:2]}


CHECKS = {"detect": detect, "cost": cost, "profiled": profiled, "clock": clock,
          "device_work": device_work}


def run(workload, seed, checks):
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    parts = harness.cell_parts(spec, workload)
    cfg, traffic = parts["config"], parts["traffic"]
    desc = scene.build(cfg["scene"])
    system = program.build(desc, cfg, "cuda")
    engine = importlib.import_module(f"ptbench.engines.{traffic['engine']}").Engine(
        system, traffic, seed)
    engine.warm()
    first = 1 << 10
    out = {"workload": workload, "seed": seed}
    for name, fn in CHECKS.items():
        if name not in checks:
            continue
        t0 = time.perf_counter()
        out[name] = fn(engine, first)
        out[name]["seconds"] = round(time.perf_counter() - t0, 2)
        first += 8 * engine.side_spp
        print(f"[trace_spans] {workload} {name}: {out[name]}", file=sys.stderr, flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--checks", default=",".join(CHECKS),
                    help="comma-separated, of " + ", ".join(CHECKS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_spans: needs a CUDA device", file=sys.stderr)
        return 2
    for wl in args.workload:
        print(json.dumps(run(wl, args.seed, args.checks.split(","))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
