"""The benchmark's arithmetic: the H100's published peaks, a kernel's least
time from the work its inputs need, and the reduction of a profiler trace
to device time, idle gaps and operation counts.

The least time of a launch is the larger of its bytes (each input read once,
each output written once) over HBM bandwidth and its float32 operations
over the FP32 peak, where the operations count only the primitive tests
these inputs need (~50 a triangle, ~20 a sphere): for a closest hit every
row of every box that ``[t_min, min(t_max, t)]`` enters (every row where
there are no boxes), for an any hit every entered row of an unoccluded ray
and one test of an occluded one. It is the arithmetic of the repository's
``chip_smoke.py`` (``bound``, ``entered_rows``, ``TRI_OPS``, ``SPH_OPS``),
copied; the slab test of ``entered_rows`` is copied from
``pathtrace_tpu_torch/ops/binned.py :: cluster_entries``.
"""

from __future__ import annotations

import bisect
import collections
import re

import torch

# One H100 SXM (NVIDIA's data sheet), at its full 700 W power limit.
PEAK_FP32 = 67e12        # FLOP/s outside the tensor cores
PEAK_HBM = 3.35e12       # bytes/s
TRI_OPS = 50             # float32 operations of one ray-triangle test
SPH_OPS = 20             # float32 operations of one ray-sphere test
_INF = float("inf")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


def least_seconds(n_bytes: int, n_ops: int) -> float:
    """A launch's least time on the card: bytes over HBM bandwidth or float32
    operations over the FP32 peak, whichever is longer."""
    return max(n_bytes / PEAK_HBM, n_ops / PEAK_FP32)


def box_entries(o, d, t_min, t_max, boxes):
    """Entry distance of each ray's ``[t_min, t_max]`` segment into each box
    (rows ``[min | max | ...]``): ``(N, C)``, inf where it misses the box or
    the box is inverted."""
    inv = 1.0 / torch.where(torch.abs(d) < 1e-20, 1e-20, d)
    lo, hi = boxes[:, 0:3], boxes[:, 3:6]
    a = (lo[None] - o[:, None, :]) * inv[:, None, :]
    b = (hi[None] - o[:, None, :]) * inv[:, None, :]
    tn = torch.maximum(torch.minimum(a, b).amax(dim=-1), t_min[:, None])
    tf = torch.minimum(torch.maximum(a, b).amin(dim=-1), t_max[:, None])
    return torch.where((tn <= tf) & (lo[None, :, 0] <= hi[None, :, 0]), tn, _INF)


def entered_rows(boxes, rows: int, o, d, t_min, t_stop) -> int:
    """Primitive rows in the boxes (``rows`` each) that the segments
    ``[t_min, t_stop]`` enter, summed over rays."""
    n = 0
    step = max(1, (1 << 24) // max(boxes.shape[0], 1))   # ~16M ray-box pairs at once
    for a in range(0, o.shape[0], step):
        b = a + step
        entered = box_entries(o[a:b], d[a:b], t_min[a:b], t_stop[a:b], boxes) < _INF
        n += int(entered.sum()) * rows
    return n


# ---------------------------------------------------------------------------
# Trace reduction (a chrome trace of torch.profiler, CPU and CUDA activity)
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """The device side of a profiled window: device operations (name,
    start, end) in seconds, the window, and the host operations of the
    thread that drove it.

    The window is the host span named ``window_name`` in the trace, or,
    where the host was not traced (``window_name`` None), the span of the
    device operations, with ``window_s`` the host clock's length of it."""

    def __init__(self, events: list, window_name: str | None, window_s: float | None = None):
        w = {}
        if window_name is not None:
            win = [e for e in events if e.get("ph") == "X" and e.get("name") == window_name
                   and e.get("cat") == "user_annotation"]
            if not win:
                raise ValueError(f"no {window_name!r} span in the trace")
            w = win[0]
            self.t0, self.t1 = w["ts"] * 1e-6, (w["ts"] + w["dur"]) * 1e-6
        else:
            dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
            self.t0 = min((e["ts"] * 1e-6 for e in dev), default=0.0)
            self.t1 = max(((e["ts"] + e.get("dur", 0.0)) * 1e-6 for e in dev), default=0.0)
        self.window_s = self.t1 - self.t0 if window_s is None else window_s
        self.device = sorted(
            ((e["name"], e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0.0)) * 1e-6)
             for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
             and self.t0 <= e["ts"] * 1e-6 <= self.t1), key=lambda e: e[1])
        host = sorted(((e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0.0)) * 1e-6, e["name"])
                       for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                       and e.get("tid") == w.get("tid")), key=lambda x: x[0])
        self.host_start = [h[0] for h in host]
        self.host = host

    @property
    def device_s(self) -> float:
        """Device time summed over operations (overlaps counted twice)."""
        return sum(b - a for _, a, b in self.device)

    def busy_intervals(self):
        """The union of device activity, clipped to the window, as merged intervals."""
        merged = []
        for _, a, b in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_seconds(self, pattern: str):
        """``(seconds, launches)`` of the device operations whose name
        matches the regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [b - a for name, a, b in self.device if rx.search(name)]
        return sum(hits), len(hits)

    def top_ops(self, k: int = 10):
        """The ``k`` device operations that took most time: ``[name, seconds]``."""
        by = collections.Counter()
        for name, a, b in self.device:
            by[_short(name)] += b - a
        return [[n, s] for n, s in by.most_common(k)]

    def _host_at(self, t: float) -> str:
        """The innermost host operation running at time ``t``."""
        i = bisect.bisect_right(self.host_start, t) - 1
        for j in range(i, max(i - 64, -1), -1):
            a, b, name = self.host[j]
            if b >= t:
                return name
        return "python (between operations)"

    def idle_gaps(self, k: int = 10):
        """Idle device time in the window, summed by what the host was doing
        in the middle of each gap: the ``k`` largest, ``[host op, seconds]``."""
        by = collections.Counter()
        prev = self.t0
        for a, b in self.busy_intervals() + [[self.t1, self.t1]]:
            if a > prev:
                by[self._host_at((prev + a) / 2)] += a - prev
            prev = max(prev, b)
        return [[n, s] for n, s in by.most_common(k)]


def _short(name: str) -> str:
    """A kernel name without its trailing argument list, at most 120
    characters (``(anonymous namespace)`` inside the name stays)."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:120]
