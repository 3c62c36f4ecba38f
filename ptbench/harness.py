"""One run of one cell: set-up, the measured window, the traced passes, the
metrics and the correctness check.

Everything a cell is made of is found by name from ``BENCHMARK.json``: its
configuration (``ptbench/configs/<config>.json``, whose scene comes from
``ptbench/recipes/<recipe>.py``), its traffic mix
(``ptbench/traffic/<traffic>.json``, driven by
``ptbench/engines/<engine>.py``), its check (``ptbench/checks/<workload>.json``)
and each metric (``ptbench/metrics/<metric>.py``). Adding a cell or a metric
adds files; it edits none.

A metric module has ``read(rec) -> float | None`` over the run's record
(:func:`run_cell`), ``None`` where it finds nothing to read. A module that
counts a kernel's work also has ``LAUNCHER = (module, function)`` and
``work(args, kwargs, result) -> (bytes, ops) | None``: the traced passes are
replayed with that function wrapped, and each launch's least time is summed
under the metric's name in ``rec["work"]``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import tempfile
import time
import traceback
from pathlib import Path

import torch

from ptbench import check, ranks, reference, scene, yardstick
from ptbench.ranks import log

BENCH_DIR = Path(__file__).resolve().parent
TRACE_SPAN = "ptbench.trace_window"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_parts(spec: dict, workload: str) -> dict:
    """The workload entry of ``BENCHMARK.json``, its configuration, traffic
    and check files, and the metric entries that this cell reports."""
    wl = {w["name"]: w for w in spec["workloads"]}.get(workload)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in spec["configs"]}[wl["config"]]

    def mine(m):
        return workload in m.get("workloads", [workload])

    parts = {
        "workload": wl,
        "config": load_json(BENCH_DIR.parent / cfg_entry["file"]),
        "traffic": load_json(BENCH_DIR / "traffic" / f"{wl['traffic']}.json"),
        "check": load_json(BENCH_DIR / "checks" / f"{workload}.json"),
        "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
        "per_layer": [m for m in spec["per_layer"] if mine(m)],
    }
    planting = [k for k, v in parts.items() if isinstance(v, dict) and "plant" in v]
    if planting:    # a plant is a test's alone (``planted``)
        raise ValueError(f"the {planting} of {workload} name a plant; no cell may")
    return parts


def metric_module(name: str):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"ptbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def counting(modules: dict, work: dict):
    """Wrap each counting metric's launcher for the duration: every call's
    ``(bytes, ops)`` adds its least time and a launch under the metric."""
    saved = []
    try:
        for name, mod in modules.items():
            target = importlib.import_module(mod.LAUNCHER[0])
            fn = getattr(target, mod.LAUNCHER[1])
            acc = work.setdefault(name, {"launches": 0, "least_s": 0.0})

            def wrapped(*args, _fn=fn, _mod=mod, _acc=acc, **kwargs):
                result = _fn(*args, **kwargs)
                try:
                    w = _mod.work(args, kwargs, result)
                except Exception:   # a reader that fails leaves its metric out
                    _acc["failed"] = True
                    log(traceback.format_exc())
                    w = None
                if w is not None:
                    _acc["launches"] += 1
                    _acc["least_s"] += yardstick.least_seconds(*w)
                return result

            saved.append((target, mod.LAUNCHER[1], fn))
            setattr(target, mod.LAUNCHER[1], wrapped)
        yield
    finally:
        for target, attr, fn in reversed(saved):
            setattr(target, attr, fn)


def profile_passes(engine, first: int, n: int, device, host: bool) -> yardstick.Trace:
    """Profile ``n`` side passes from sample ``first`` and reduce the trace.
    With ``host`` the host's operations are traced too (for what the host
    was doing in each idle gap; that tracing slows the host), else the
    device's alone, with the window the host clock's.

    The profiler keeps at most 128 MB of device records a session (about
    1.2M records, ~3 for each device operation) and silently drops the
    rest, so a mix sizes its side passes (``side_spp``) to stay well under
    that; the log line gives the operations and the span they cover."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] if host or torch.device(device).type != "cuda" else []
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(TRACE_SPAN):
            _sync(device)
            t0 = time.perf_counter()
            stats = [engine.side_pass(first + k * engine.side_spp) for k in range(n)]
            _sync(device)
            wall = time.perf_counter() - t0
    t = yardstick.Trace(trace_events(prof, host), TRACE_SPAN if host else None, wall)
    span = max((b for _, _, b in t.device), default=0.0) - min(
        (a for _, a, _ in t.device), default=0.0)
    log(f"[trace] {'host and device' if host else 'device'}: {n} passes of "
        f"{engine.side_spp} spp from sample {first}, {len(t.device)} device operations over "
        f"{span:.3f} s of a {wall:.3f}-s wall; pass counts {stats}")
    return t


def trace_events(prof, host: bool) -> list:
    """The profiler's chrome-trace events of the categories the reduction
    reads. The trace (0.4-0.6 GB for a pool pass) is written to a temporary
    file in ``TMPDIR`` and deleted once read."""
    cats = set(yardstick.DEVICE_CATS) | ({"cpu_op", "user_annotation"} if host else set())
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return [e for e in load_json(Path(path)).get("traceEvents", []) if e.get("cat") in cats]
    finally:
        os.remove(path)


@contextlib.contextmanager
def planted(name: str | None, rank: int):
    """A test's fault or probe, ``parts["plant"]`` = ``"module:function"``:
    ``function(rank)`` returns a context manager that is held around the
    rank's run, in every rank's process. The cells' own parts name none
    (``cell_parts`` refuses one)."""
    if not name:
        yield
        return
    module, function = name.split(":")
    with getattr(importlib.import_module(module), function)(rank):
        yield


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None, parts: dict | None = None) -> dict:
    """One run of ``workload``; returns the result line's object. ``parts``
    replaces the cell's files (tests drive small cells through it). A cell
    whose workload asks for ``chips: N > 1`` runs as ``N`` ranks, this
    process rank 0, which starts the others (``ptbench/ranks.py``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    job = {"workload": workload, "seed": seed & 0xFFFFFFFF,   # the renderer's key: 32 bits
           "seconds": seconds, "trace": bool(trace), "device": str(device),
           "parts": parts or cell_parts(spec, workload)}
    n = int(job["parts"]["workload"]["chips"])
    if n == 1:
        return run_rank(job, 0, t_start)
    from ptbench import program

    program.prepare(device)
    with ranks.Peers(job, n, BENCH_DIR.parent) as job:
        return run_rank(job, 0, t_start)


def run_rank(job: dict, rank: int, t_start: float | None = None) -> dict | None:
    """Rank ``rank``'s part of a run (``job`` as :func:`run_cell` and
    ``ranks.Peers`` make it); returns the result on rank 0, None on a peer.

    Every rank builds the scene and its engine, warms up, runs the window's
    passes (as many as rank 0's clock allows) and, with ``trace``, the side
    passes; rank 0 alone profiles and counts them, reads the metrics and
    checks its framebuffer, which holds every rank's frames."""
    from ptbench import program

    t_start = time.perf_counter() if t_start is None else t_start
    workload, seed, seconds, trace = job["workload"], job["seed"], job["seconds"], job["trace"]
    parts, n, device = job["parts"], job.get("ranks", 1), job["device"]
    cfg, traffic, chk = parts["config"], parts["traffic"], parts["check"]
    with contextlib.ExitStack() as group:
        group.enter_context(planted(parts.get("plant"), rank))
        if n > 1:
            device = program.join(job["coordinator"], n, rank, device, job["timeout_s"])
            group.callback(program.leave)   # after the last collective
        desc = scene.build(cfg["scene"])
        system = program.build(desc, cfg, device)
        engine = importlib.import_module(f"ptbench.engines.{traffic['engine']}").Engine(
            system, traffic, seed)
        cams = system.cameras
        frame_px = cfg["width"] * cfg["height"]
        pixels = len(cams) * frame_px
        blocks = check.frame_blocks(len(cams), n)

        # Set-up ends after one untimed pass of the cell's own shapes on
        # every rank.
        engine.warm()
        _sync(device)
        ranks.barrier()
        setup_s = time.perf_counter() - t_start
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()

        walls, stats = [], []
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            stats.append(engine.window_pass())
            _sync(device)
            b = time.perf_counter()
            walls.append(b - a)
            if not ranks.agree(b - t0 < seconds):    # rank 0's clock
                break
        window_s = b - t0
        peak = (torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda"
                else 0)
        peaks, passes = zip(*ranks.gather((peak, len(walls))))
        lo, hi = engine.samples()
        log(f"[window] {workload}: {len(walls)} passes of {engine.spp} spp in "
            f"{window_s:.3f} s, samples [{lo}, {hi}), set-up {setup_s:.3f} s; pass walls "
            f"{[round(w, 3) for w in walls]}, iterations {[p.get('iters') for p in stats]}"
            + (f"; rank {rank} of {n}, passes by rank {list(passes)}" if n > 1 else ""))

        rec = {"config": cfg, "traffic": traffic, "engine": traffic["engine"],
               "pixels": pixels, "spp": engine.spp, "setup_s": setup_s,
               "window_s": window_s, "walls": walls, "passes": stats, "trace": None,
               "trace_samples": 0, "work": {}}
        if trace:
            n_t = int(traffic.get("trace_passes", 1))
            if rank == 0:
                t_tr = time.perf_counter()
                rec["trace"] = profile_passes(engine, hi, n_t, device, host=False)
                # Rank 0's own frames: what its trace holds.
                rec["trace_samples"] = n_t * engine.side_spp * frame_px * len(blocks[0])
                t_host = time.perf_counter()
                gaps = profile_passes(engine, hi, n_t, device, host=True).idle_gaps()
                t_work = time.perf_counter()
                counters = {m["name"]: mod for m in parts["per_layer"]
                            if hasattr(mod := metric_module(m["name"]), "LAUNCHER")}
                with counting(counters, rec["work"]):
                    for k in range(n_t):
                        engine.side_pass(hi + k * engine.side_spp)
                    _sync(device)
                log(f"[trace] device pass {t_host - t_tr:.1f} s, host-traced pass "
                    f"{t_work - t_host:.1f} s, counted replay "
                    f"{time.perf_counter() - t_work:.1f} s")
            else:   # in lock-step with rank 0's traced, host-traced and counted passes
                for k in range(3 * n_t):
                    engine.side_pass(hi + k % n_t * engine.side_spp)
                _sync(device)
    if rank != 0:
        return None

    wanted = parts["per_layer"] if trace else parts["end_to_end"]
    metrics = {}
    for m in wanted:
        value = metric_module(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": False, "attempted": len(walls), "attempted_by_rank": list(passes),
              "failed": 0, "metrics": metrics,
              "device": {"count": n, "memory_peak_bytes": max(peaks),
                         "memory_peak_bytes_by_rank": list(peaks)}}
    if trace and rec["trace"] is not None:
        t = rec["trace"]
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": t.top_ops(), "idle_gaps": gaps}

    # The check: the window's framebuffer at pixels drawn from the seed over
    # every frame, against the reference, once the program's state is freed.
    ids = check.pixel_sample(seed, pixels, int(chk["pixels"]))
    missed = check.missed_blocks(ids, frame_px, len(cams), n)
    if missed:
        raise RuntimeError(f"the check's {ids.numel()} pixels miss every frame of rank(s) "
                           f"{missed}; the frames by rank are {blocks}")
    got = engine.framebuffer()[ids.to(engine.framebuffer().device)].to("cpu", torch.float64)
    del engine, system, cams
    rec.clear()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = reference.render_frames(
        desc, scene.cameras(cfg), ids, lo, hi, width=cfg["width"], height=cfg["height"],
        seed=seed, integrator=cfg["integrator"], max_bounces=cfg["max_bounces"],
        device=device)
    numbers = check.compare(got, want)
    log(f"[check] reference over {ids.numel()} pixels x {hi - lo} samples in "
        f"{time.perf_counter() - t_ref:.3f} s")
    result["correct"] = check.judge(numbers, chk["limits"])
    result["checks"] = {k: {"value": numbers[k], "limit": chk["limits"][k]}
                        for k in check.NUMBERS}
    return result
