"""The port's spans and counters (``pathtrace_tpu_torch.profiler``) and the
benchmark's readers of them (``ptbench/spans.py``, ``ptbench/metrics/``).

The pool and the wave record their phases as nested spans with exact host
sync counts only while tracing; tracing leaves every image and counter bit
for bit as it was. The readers give known values on a synthetic pass
record and nothing where there is nothing to read."""

from __future__ import annotations

import collections
import types

import pytest
import torch

from pathtrace_tpu_torch import RenderConfig, pool, profiler, render
from pathtrace_tpu_torch.models import scenes
from ptbench import harness, spans, yardstick

PARENTS = {
    "pool.iter": {"pool.pass"}, "pool.refill": {"pool.iter"}, "pool.rng": {"pool.refill"},
    "pool.bounce": {"pool.iter"}, "pool.shadow": {"pool.iter"}, "pool.flush": {"pool.iter"},
    "pool.count": {"pool.iter"}, "sync.flush_index": {"pool.flush"},
    "sync.pool_exit": {"pool.pass"},
    "wave.sample": {"wave.pass"}, "wave.rng": {"wave.sample", "wave.bounce"},
    "wave.bounce": {"wave.sample"}, "sync.wave_alive": {"wave.sample"},
    "sync.wave_rays": {"wave.sample"}, "wave.nee": {"wave.bounce"},
    "wave.scatter": {"wave.bounce"}, "wave.peek": {"wave.bounce"},
    "intersect": {"pool.bounce", "pool.shadow", "wave.sample", "wave.nee", "wave.peek"},
    "bsdf": {"pool.bounce", "wave.sample", "wave.nee", "wave.scatter", "wave.peek"},
    "lights": {"pool.bounce", "wave.nee", "wave.peek"},
}
PARENTS["sync.h2d"] = set(PARENTS) | {"pool.pass", "wave.pass"}   # a copy anywhere
POOL_LEAVES = ["pool.bounce", "pool.count", "pool.flush", "pool.refill", "pool.shadow"]


@pytest.fixture(autouse=True)
def fresh_records():
    profiler.clear()
    yield
    profiler.clear()


def _cornell(n=8):
    return scenes.cornell_box(device="cpu"), scenes.cornell_camera(n, n, device="cpu")


def _pool(method=None):
    sc, cam = _cornell()
    return pool.render_pool(sc, cam, width=8, height=8, spp=2, num_slots=16, seed=7,
                            max_bounces=6, method=method)


def _wave(max_bounces=3):
    sc, cam = _cornell()
    cfg = RenderConfig(width=8, height=8, spp=2, max_bounces=max_bounces, seed=7)
    return render(sc, cam, cfg)


def _children(rec):
    """Each span's children, the host-constant copies (``sync.h2d``) left out."""
    kids = collections.defaultdict(list)
    for i, p in enumerate(rec.parents):
        if p >= 0 and rec.names[i] != "sync.h2d":
            kids[p].append(i)
    return kids


@pytest.mark.parametrize("method", [None, "bruteforce"], ids=["fused", "composed"])
def test_pool_spans_nest_and_count_exactly(method):
    with profiler.tracing():
        image, counters, iters = _pool(method)
    (rec,) = profiler.passes()
    assert rec.kind == "pool" and rec.names[0] == "pool.pass" and rec.parents[0] == -1
    assert all(e > s for s, e in zip(rec.start_ns, rec.end_ns))
    kids = _children(rec)
    for i, name in enumerate(rec.names[1:], 1):
        parent = rec.names[rec.parents[i]]
        assert parent in PARENTS[name], (name, parent)
        assert rec.start_ns[rec.parents[i]] <= rec.start_ns[i] <= rec.end_ns[i] \
            <= rec.end_ns[rec.parents[i]]
    iter_spans = [i for i, n in enumerate(rec.names) if n == "pool.iter"]
    assert len(iter_spans) == iters == rec.counts["pool.iter"]
    for i in iter_spans:
        assert sorted(rec.names[k] for k in kids[i]) == POOL_LEAVES
        by = {rec.names[k]: k for k in kids[i]}
        (rng_span,) = kids[by["pool.refill"]]
        assert rec.names[rng_span] == "pool.rng" and not kids[rng_span]
        assert [rec.names[k] for k in kids[by["pool.flush"]]] == ["sync.flush_index"]
    composed = {"intersect", "bsdf", "lights"} & set(rec.names)
    assert composed == (set() if method is None else {"intersect", "bsdf", "lights"})
    # One flush sync an iteration, one exit test a block and the test that ends the loop.
    syncs = rec.syncs
    assert syncs.pop("sync.flush_index") == iters
    assert syncs.pop("sync.pool_exit") == iters // pool.FLUSH_EVERY + 1
    # Host constants: the key and the packed camera; composed, also each
    # iteration's camera size and three ray ranges (the hit's two, the shadow's t_min).
    h2d = syncs.pop("sync.h2d")
    assert h2d == 2 if method is None else h2d >= 1 + 4 * iters
    assert syncs == {}
    assert rec.launches == collections.Counter()     # the CPU runs the kernels' twins
    assert rec.events is None and rec.device_ms() is None


@pytest.mark.parametrize("max_bounces", [2, 6])
def test_wave_spans_nest_and_count_each_alive_test(max_bounces):
    with profiler.tracing():
        state = _wave(max_bounces)
    (rec,) = profiler.passes()
    assert rec.kind == "wave" and rec.names[0] == "wave.pass"
    kids = _children(rec)
    for i, name in enumerate(rec.names[1:], 1):
        assert rec.names[rec.parents[i]] in PARENTS[name], name
    samples = [i for i, n in enumerate(rec.names) if n == "wave.sample"]
    assert len(samples) == state.num_samples == 2
    tests = 0
    for s in samples:
        names = [rec.names[k] for k in kids[s]]
        bounces = names.count("wave.bounce")
        # The loop tests the live lanes before each bounce, and once more
        # unless it stopped at max_bounces.
        tests += bounces + (bounces < max_bounces)
        assert names.count("sync.wave_rays") == 1 and names[0] == "wave.rng"
        for b in (k for k in kids[s] if rec.names[k] == "wave.bounce"):
            assert [rec.names[k] for k in kids[b]] == [
                "wave.rng", "wave.nee", "wave.scatter", "wave.peek"]
    syncs = rec.syncs
    assert syncs.pop("sync.wave_alive") == tests and syncs.pop("sync.wave_rays") == 2
    # The key; a sample's camera size, ray count and primary ranges; a
    # bounce's three ranges (the peek's two, the shadow's t_min).
    assert syncs.pop("sync.h2d") >= 1 + 4 * 2 + 3 * rec.counts["wave.bounce"]
    assert syncs == {}
    assert rec.counts["wave.bounce"] == sum(
        [rec.names[k] for k in kids[s]].count("wave.bounce") for s in samples)


@pytest.mark.parametrize("engine", ["fused", "composed", "wave"])
def test_tracing_changes_no_bit_and_off_records_nothing(engine):
    run = {"fused": _pool, "composed": lambda: _pool("bruteforce"), "wave": _wave}[engine]
    off = run()
    assert profiler.passes() == []
    with profiler.tracing():
        on = run()
    assert len(profiler.passes()) == 1
    if engine == "wave":
        assert torch.equal(off.image_sum, on.image_sum)
        assert (off.num_samples, off.ray_queries) == (on.num_samples, on.ray_queries)
    else:
        assert torch.equal(off[0], on[0]) and off[2] == on[2]
        assert pool.ray_count(off[1]) == pool.ray_count(on[1])
        assert pool.busy_count(off[1]) == pool.busy_count(on[1])
    assert profiler.span("x") is profiler.span("y")       # one shared no-op context


def test_a_profiler_session_turns_tracing_on_and_shows_the_spans():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, iters = _pool()
    (rec,) = profiler.passes()
    assert rec.profiled
    names = collections.Counter(e.name for e in prof.events())
    assert names["pool.pass"] == 1 and names["pool.iter"] == iters
    assert names["sync.flush_index"] == iters
    _pool()
    assert len(profiler.passes()) == 1           # the session is over: off again


# ---------------------------------------------------------------------------
# The readers, on a synthetic pass (ms on the event clock; the host's clock
# 3 ms behind the trace's, as the card's can be)
# ---------------------------------------------------------------------------

BASE = 1_790_857_026 * 10**9
OFF = 1000.0   # trace clock (s) = event clock (s) + OFF
SKEW = 0.003   # host clock (s) = trace clock (s) + SKEW
NAMES = ["pool.pass", "pool.iter", "pool.rng", "pool.bounce", "bsdf", "sync.flush_index",
         "sync.h2d"]
PARENT = [-1, 0, 1, 1, 1, 1, 0]
EVENTS_MS = [(0, 100), (0.5, 99), (10, 30), (44, 61), (62, 69), (75, 80), (99.2, 99.6)]
LAUNCH_IN, LAUNCH_OUT = [0, 0, 0, 0, 1, 1, 1], [1, 1, 0, 1, 1, 1, 1]
DEVICE = [("rng_op", 12, 28), ("void fused_bounce_kernel<float>(int)", 45, 60),
          ("bsdf_op", 63, 67), ("Memcpy DtoH", 76, 77),
          ("Memcpy HtoD (Pageable -> Device)", 99.3, 99.5), ("late_op", 200, 210)]


def _record(events=True):
    ns = [(BASE + round((OFF + SKEW + a / 1e3) * 1e9), BASE + round((OFF + SKEW + b / 1e3) * 1e9))
          for a, b in EVENTS_MS]
    return types.SimpleNamespace(
        names=NAMES, parents=PARENT, start_ns=[a for a, _ in ns], end_ns=[b for _, b in ns],
        launch_in=LAUNCH_IN, launch_out=LAUNCH_OUT, events=[None] if events else None,
        device_ms=lambda: [tuple(map(float, e)) for e in EVENTS_MS],
        syncs={"sync.flush_index": 1, "sync.pool_exit": 2, "sync.h2d": 1})


def _rec(device=DEVICE):
    events = [dict(ph="X", cat="kernel", name=n, ts=(OFF + a / 1e3) * 1e6,
                   dur=(b - a) * 1e3) for n, a, b in device]
    return {"trace": yardstick.Trace(events, None, 0.3), "traffic": {"trace_passes": 1},
            "trace_samples": 1_000_000}


def _read(name, rec):
    return harness.metric_module(name).read(rec)


def test_readers_give_known_values_on_a_synthetic_pass(monkeypatch):
    # The device-traced pass, then the host-traced one, as a traced run leaves them.
    monkeypatch.setattr(profiler, "passes", lambda: [_record(), _record()])
    rec = _rec()
    want = {"rng.device_share": 100 * 16 / 46.2, "shading.device_share": 100 * 4 / 46.2,
            "host.sync_share": 100 * 5.4 / 100, "device.idle_enqueue_share": 100 * 59.6 / 300,
            "host.syncs_per_msample": 4.0}
    for name, value in want.items():
        assert _read(name, rec) == pytest.approx(value, rel=1e-9), name
    a = rec["spans"]
    # pool.bounce enters 44 ms + SKEW on the host, its kernel starts at 45 ms.
    assert a["base_ns"] == BASE and a["lag_ns"] == -2_000_000
    assert a["device"] == pytest.approx({"pool.rng": 0.016, "pool.bounce": 0.015, "bsdf": 0.004,
                                         "sync.flush_index": 0.001, "sync.h2d": 0.0002,
                                         "outside": 0.010})
    assert sum(a["device"].values()) == pytest.approx(a["device_s"], rel=1e-12)
    assert a["kernels"] == {"fused_bounce_kernel": (1, 1, ["pool.bounce"]),
                            spans.COPY: (1, 1, ["sync.h2d"])}
    assert a["idle"]["sync.flush_index"] == pytest.approx(0.004)
    assert a["idle"]["sync.h2d"] == pytest.approx(0.0002)
    assert any("pool.rng | 1 | 16.000" in line for line in spans.table(a))


@pytest.mark.parametrize("case", ["no trace", "no device op", "no program spans",
                                  "no events", "launches cut"])
def test_readers_give_nothing_where_there_is_nothing_to_read(monkeypatch, case):
    rec = _rec()
    records = [_record(), _record()]
    if case == "no trace":
        rec["trace"] = None
    elif case == "no device op":
        rec = _rec([])
    elif case == "no program spans":
        monkeypatch.delattr(profiler, "passes")
    elif case == "no events":
        records = [_record(events=False), _record(events=False)]
    else:   # the trace lost a kernel the program launched
        rec = _rec([op for op in DEVICE if "fused" not in op[0]])
    if case != "no program spans":
        monkeypatch.setattr(profiler, "passes", lambda: records)
    for name in ("rng.device_share", "shading.device_share", "host.sync_share",
                 "device.idle_enqueue_share", "host.syncs_per_msample"):
        assert _read(name, rec) is None, name


@pytest.mark.parametrize("base_s", [1_790_857_026, 1_700_000_000, 1])
def test_the_base_is_recovered_exactly_from_a_synthetic_offset(base_s):
    base = base_s * spans.SECOND_NS
    starts = [12.5, 12.75, 13.0, 400.25]                      # kernel starts, s from the base
    lags = [3_000, 40_000, 1_250, 250_000_000]                 # launch to start, ns
    pairs = [(base + round(s * 1e9) - lag, s) for s, lag in zip(starts, lags)]
    assert spans.recover_base(pairs) == (base, 1_250)


def test_the_event_clock_offset_is_exact_where_the_bounds_agree():
    # Spans of 1 ms on the event clock, the trace 2.5 s ahead: one kernel
    # starts as its span enters, another ends as its span exits, so the
    # bounds meet at the offset alone.
    kernels = [(1.0, 1.0, 1.0004), (2.0, 2.0003, 2.001)]   # (span entry, kernel start, end)
    anchors = [(x, (b + 2.5) - (x + 0.001), (a + 2.5) - x) for x, a, b in kernels]
    (seg,) = spans.segments(anchors)
    assert seg[0] == 1.0 and seg[1] == pytest.approx(2.5, abs=1e-12)
    assert seg[2] == pytest.approx(0.0, abs=1e-12)
    # Bounds that share no value with the last start a segment of their own.
    assert spans.segments(anchors + [(4.0, 9.0, 9.1)])[1][:2] == (4.0, pytest.approx(9.05))
