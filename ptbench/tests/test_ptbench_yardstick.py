"""The benchmark's arithmetic on synthetic inputs: least times, entered
rows, the trace reduction (busy union, idle share, gaps by host operation)
and a kernel's roofline share."""

from __future__ import annotations

import importlib

import pytest
import torch

from ptbench import harness, roofline, yardstick as ys


def test_least_time_is_the_longer_of_bytes_and_operations():
    assert ys.least_seconds(3.35e9, 0) == pytest.approx(1e-3)
    assert ys.least_seconds(0, 67e9) == pytest.approx(1e-3)
    assert ys.least_seconds(3.35e9, 134e9) == pytest.approx(2e-3)


def test_entered_rows_counts_the_boxes_a_segment_enters():
    boxes = torch.tensor([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0, 0],     # on the ray, t in [2, 3]
                          [0.0, 5.0, 0.0, 1.0, 6.0, 1.0, 0, 0],     # off the ray
                          [0.0, 0.0, 5.0, 1.0, 1.0, 6.0, 0, 0],     # on the ray, t in [7, 8]
                          [1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0, 0]])    # inverted: never entered
    o = torch.tensor([[0.5, 0.5, -2.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    lo = torch.tensor([0.0])
    assert ys.entered_rows(boxes, 128, o, d, lo, torch.tensor([100.0])) == 256
    assert ys.entered_rows(boxes, 128, o, d, lo, torch.tensor([4.0])) == 128
    assert ys.entered_rows(boxes, 128, o, d, lo, torch.tensor([1.0])) == 0


def _events():
    """A window [0, 100] us: device busy [10, 30] and [20, 40] (overlapping)
    and [70, 80]; host op 'aten::nonzero' over [40, 60], nested
    'aten::index' [35, 65] around it; nothing on the host over [80, 100]."""
    x = dict(ph="X", pid=1, tid=7)
    return [
        dict(x, cat="user_annotation", name=harness.TRACE_SPAN, ts=0.0, dur=100.0),
        dict(x, cat="kernel", name="void pt::(anonymous namespace)::bvh_closest_kernel<float, 16>(float*)", ts=10.0,
             dur=20.0, tid=99),
        dict(x, cat="kernel", name="elementwise_add", ts=20.0, dur=20.0, tid=99),
        dict(x, cat="gpu_memcpy", name="Memcpy DtoH", ts=70.0, dur=10.0, tid=99),
        dict(x, cat="cpu_op", name="aten::index", ts=35.0, dur=30.0),
        dict(x, cat="cpu_op", name="aten::nonzero", ts=40.0, dur=20.0),
        dict(x, cat="cpu_op", name="aten::other_thread", ts=0.0, dur=100.0, tid=8),
    ]


def test_trace_busy_union_idle_and_gaps():
    t = ys.Trace(_events(), harness.TRACE_SPAN)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)             # [10, 40] and [70, 80]
    assert t.device_s == pytest.approx(50e-6)           # overlaps counted twice
    gaps = dict(t.idle_gaps())
    assert gaps["aten::nonzero"] == pytest.approx(30e-6)     # [40, 70], midpoint 55
    assert gaps["python (between operations)"] == pytest.approx(30e-6)   # [0, 10], [80, 100]
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)
    secs, n = t.kernel_seconds(r"(?<!\w)bvh_closest_kernel\b")
    assert (secs, n) == (pytest.approx(20e-6), 1)
    assert t.top_ops(1) == [["void pt::(anonymous namespace)::bvh_closest_kernel<float, 16>", pytest.approx(20e-6)]]


def test_trace_metrics_read_the_reduction():
    t = ys.Trace(_events(), harness.TRACE_SPAN)
    rec = {"trace": t, "trace_samples": 2_000_000, "work": {}}
    idle = harness.metric_module("device.idle_share").read(rec)
    assert idle == pytest.approx(60.0)
    assert harness.metric_module("glue.device_ops_per_msample").read(rec) == pytest.approx(1.5)
    share = harness.metric_module("kernels.device_share").read(rec)
    assert share == pytest.approx(40.0)                  # 20 of 50 us


def test_device_share_lists_the_kernels_the_program_defines():
    """The metric names its kernels itself; a kernel renamed, split or added
    in ``csrc/`` shows here, to be listed by an edit of the metric's file."""
    import re
    from pathlib import Path

    csrc = Path(harness.BENCH_DIR).parent / "pathtrace_tpu_torch" / "csrc"
    defined = set()
    for src in csrc.glob("*.cu"):
        defined |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?"
            r"(\w+_kernel)\s*\(", src.read_text()))
    assert set(harness.metric_module("kernels.device_share").KERNELS) == defined


def test_roofline_share_needs_matching_launch_counts():
    t = ys.Trace(_events(), harness.TRACE_SPAN)
    pattern = r"(?<!\w)bvh_closest_kernel\b"
    rec = {"trace": t, "work": {"m": {"launches": 1, "least_s": 5e-6}}}
    assert roofline.share(rec, "m", pattern) == pytest.approx(25.0)
    rec["work"]["m"]["launches"] = 2
    assert roofline.share(rec, "m", pattern) is None
    assert roofline.share({"trace": None, "work": {}}, "m", pattern) is None


@pytest.mark.parametrize("metric", ["combined_closest_small_roofline", "any_hit_roofline"])
def test_counting_wraps_the_launcher_and_restores_it(metric):
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import intersect

    tables = intersect.build_tables(scenes.cornell_box("cpu"))
    o = torch.tensor([[0.0, 0.0, 2.0]]).repeat(4, 1)
    d = torch.nn.functional.normalize(torch.tensor(
        [[0.0, 0.0, -1.0], [0.3, 0.2, -1.0], [-0.2, 0.1, -1.0], [0.0, -0.4, -1.0]]), dim=1)
    mod = harness.metric_module(metric)
    target = importlib.import_module(mod.LAUNCHER[0])
    original = getattr(target, mod.LAUNCHER[1])
    work = {}
    with harness.counting({metric: mod}, work):
        assert getattr(target, mod.LAUNCHER[1]) is not original
        hit = intersect.intersect(tables, o, d, 1e-3, float("inf"))
        intersect.occluded(tables, hit.point, -d, 1e-3, torch.full((4,), 0.5))
    assert getattr(target, mod.LAUNCHER[1]) is original
    assert work[metric]["launches"] == 1 and work[metric]["least_s"] > 0
