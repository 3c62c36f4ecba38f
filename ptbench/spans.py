"""The program's spans read against the device trace of the traced passes:
the device time of each phase of the program, what the host was doing while
the device sat idle, and the host syncs.

The program (``pathtrace_tpu_torch.profiler``) keeps a pass record of spans
for each pass that starts while a ``torch.profiler`` session is active. In a
traced run those are the harness's device-traced passes, then its
host-traced ones; the window and the counted replay run with no session. So
the device-traced passes are the first ``trace_passes`` of the last
``2 * trace_passes`` records. A program without ``profiler.passes`` records
no span, and every reader of this module then returns None.

Each span holds its host times (``time.time_ns()``) and, on the card, a CUDA
event at its entry and exit in stream order. The events' clock is put on the
trace's by the hand-written kernels: a pass record counts the hand-written
launches at each span's entry and exit, so each launch has one innermost
span that made it, and its kernel ran between that span's two events. Each
such pair bounds the offset between the clocks; consecutive pairs whose
bounds overlap share one offset (a segment). Each device operation then goes
to the innermost span whose events hold its middle, or to ``outside``, and
so does each stretch of device idle: an idle device has run all that was
queued, so the last event it passed marks where the host is. The host's own
times give its self time by span. The host clock is put on the trace's only
as a check: the trace's base time is a whole number of seconds (the chrome
trace's ``baseTimeNanoseconds``, which the harness does not keep), recovered
as the largest span entry less the start of a kernel it launched, rounded
to the second; what the rounding adds is the least launch lag, which the
card's traces put milliseconds below zero at times.
"""

from __future__ import annotations

import bisect
import collections
import re
import sys
import traceback

from ptbench import harness

OUTSIDE = "outside"
SECOND_NS = 1_000_000_000
COPY = "Memcpy HtoD"   # the device side of a copy from the host (a sync.h2d span)


def _hand_pattern():
    kernels = harness.metric_module("kernels.device_share").KERNELS
    return re.compile(r"(?<!\w)(" + "|".join(kernels) + r")\b")


def traced_records(rec):
    """The program's pass records of the device-traced passes, or None."""
    prof = sys.modules.get("pathtrace_tpu_torch.profiler")
    passes = getattr(prof, "passes", None)
    if passes is None:
        return None
    n = int(rec["traffic"].get("trace_passes", 1))
    recs = passes()[-2 * n:][:n]
    if len(recs) < n or any(not r.events for r in recs):
        return None
    return recs


def analysis(rec):
    """The spans' reading of a traced run (see :func:`attribute`), worked out
    once a run and logged; None where there is nothing to read."""
    if "spans" not in rec:
        rec["spans"] = None
        t = rec.get("trace")
        recs = traced_records(rec) if t is not None and t.device else None
        if recs is not None:
            try:
                rec["spans"] = attribute(
                    t.device, t.busy_intervals(), t.window_s,
                    [(r.names, r.parents, r.start_ns, r.end_ns, r.launch_in, r.launch_out,
                      r.device_ms(), dict(r.syncs)) for r in recs])
            except Exception:   # a reader that fails leaves its metric out
                harness.log(traceback.format_exc())
            if rec["spans"] is not None:
                for line in table(rec["spans"]):
                    harness.log(line)
    return rec["spans"]


def owners(launch_in, launch_out) -> list:
    """The innermost span of each hand-written launch of a pass: the last
    entered of the spans whose launch counts hold it."""
    out = [-1] * (launch_out[0] if launch_out else 0)
    for i, (a, b) in enumerate(zip(launch_in, launch_out)):
        for k in range(a, b):
            out[k] = i
    return out


def segments(anchors) -> list:
    """Offsets (trace clock minus event clock, s) from ``(event_time, lo,
    hi)`` bounds in stream order: ``[(first event_time, offset, width)]``,
    one a run of consecutive bounds that share a value, the offset the
    middle of their common range and the width its length."""
    out, lo, hi, first = [], None, None, None
    for x, a, b in anchors:
        if lo is not None and max(lo, a) <= min(hi, b):
            lo, hi = max(lo, a), min(hi, b)
            continue
        if lo is not None:
            out.append((first, (lo + hi) / 2, hi - lo))
        first, lo, hi = x, a, b
    if lo is not None:
        out.append((first, (lo + hi) / 2, hi - lo))
    return out


def recover_base(pairs) -> tuple:
    """``(base_ns, lag_ns)`` from ``(span entry ns, kernel start s on the
    trace clock)`` pairs: the largest entry less the start, rounded to the
    second; ``lag`` is what the rounding added (the least launch lag)."""
    est = max(entry - round(start * 1e9) for entry, start in pairs)
    base = round(est / SECOND_NS) * SECOND_NS
    return base, base - est


def self_segments(a_s, b_s) -> list:
    """``(start, end, span)`` pieces of the time the spans ``[a_s[i],
    b_s[i]]`` cover (in entry order, nested), each given to the innermost
    span open then."""
    out, stack, cur = [], [], None
    for i in range(len(a_s)):
        while stack and b_s[stack[-1]] <= a_s[i]:
            j = stack.pop()
            out.append((cur, b_s[j], j))
            cur = b_s[j]
        if stack:
            out.append((cur, a_s[i], stack[-1]))
        cur = a_s[i]
        stack.append(i)
    while stack:
        j = stack.pop()
        out.append((cur, b_s[j], j))
        cur = b_s[j]
    return [(a, b, i) for a, b, i in out if b > a]


def attribute(device, busy, window_s, passes) -> dict:
    """Device time, host self time and device idle time by span name.

    ``device``: the trace's device operations ``(name, start s, end s)``
    in time order; ``busy``: their union as ordered disjoint ``[start,
    end]`` intervals; ``window_s``: the traced window's host wall; ``passes``:
    per device-traced pass ``(names, parents, start_ns, end_ns, launch_in,
    launch_out, device_ms, syncs)`` as the program's pass record holds them,
    ``device_ms`` the spans' ``(entry, exit)`` events in ms from the pass's
    first."""
    hand_rx = _hand_pattern()
    hand = [(j, op) for j, op in enumerate(device) if hand_rx.search(op[0])]
    launched = sum(p[5][0] for p in passes)
    if launched != len(hand):
        harness.log(f"[spans] {launched} hand-written launches in the pass records, "
                    f"{len(hand)} in the trace: no attribution")
        return None
    # Each copy from the host runs alone inside its sync.h2d span, between
    # events the host records a few microseconds apart: the tightest anchors,
    # used where the trace holds one copy a span.
    copies = [(j, op) for j, op in enumerate(device) if op[0].startswith(COPY)]
    if len(copies) != sum(p[0].count("sync.h2d") for p in passes):
        copies = []

    spans, pairs, owner, seg_log, pos, cpos = [], [], {}, [], 0, 0
    for names, parents, start_ns, end_ns, l_in, l_out, dev_ms, _ in passes:
        own = owners(l_in, l_out)
        mine = hand[pos:pos + len(own)]
        pos += len(own)
        if copies:
            h2d = [i for i, n in enumerate(names) if n == "sync.h2d"]
            mine, own = mine + copies[cpos:cpos + len(h2d)], own + h2d
            cpos += len(h2d)
        ev = [(a / 1e3, b / 1e3) for a, b in dev_ms]
        anchors = sorted((ev[i][0], b - ev[i][1], a - ev[i][0])
                         for (_, (_, a, b)), i in zip(mine, own))
        segs = segments(anchors)
        if not segs:
            harness.log("[spans] a pass launched no hand-written kernel: no attribution")
            return None
        seg_log.append(segs)
        firsts = [g[0] for g in segs]

        def on_trace(x):
            return x + segs[max(bisect.bisect_right(firsts, x) - 1, 0)][1]

        base_i = len(spans)
        for i, name in enumerate(names):
            spans.append((name, parents[i] + base_i if parents[i] >= 0 else -1,
                          on_trace(ev[i][0]), on_trace(ev[i][1])))
        for (j, op), i in zip(mine, own):
            owner[j] = base_i + i
            if names[i] != "sync.h2d":
                pairs.append((start_ns[i], op[1]))

    # Each device operation to the innermost span whose events hold its middle.
    order = sorted(range(len(spans)), key=lambda i: (spans[i][2], i))
    starts = [spans[i][2] for i in order]
    dev = collections.Counter()
    ops = collections.Counter()
    kernel_hits = collections.defaultdict(lambda: [0, 0, set()])
    for j, (name, a, b) in enumerate(device):
        mid = (a + b) / 2
        k = bisect.bisect_right(starts, mid) - 1
        i = order[k] if k >= 0 else -1
        while i >= 0 and spans[i][3] < mid:
            i = spans[i][1]
        where = spans[i][0] if i >= 0 else OUTSIDE
        dev[where] += b - a
        ops[where] += 1
        if j in owner:
            m = COPY if name.startswith(COPY) else hand_rx.search(name)[1]
            kernel_hits[m][0] += i == owner[j]
            kernel_hits[m][1] += 1
            kernel_hits[m][2].add(spans[owner[j]][0])

    # The host's self time by span, on its own clock.
    host, pass_s = collections.Counter(), 0.0
    for names, _, start_ns, end_ns, *_ in passes:
        pass_s += (end_ns[0] - start_ns[0]) / 1e9
        for a, b, i in self_segments(start_ns, end_ns):
            host[names[i]] += (b - a) / 1e9

    # The device's idle time to the innermost span open at that point of the
    # stream: an idle device has run all that was queued, so the last event
    # it passed marks where the host is (the host clock and the trace's can
    # part by milliseconds; the events and the kernels cannot).
    pieces = sorted((a, b, spans[i][0]) for a, b, i in self_segments(
        [s_[2] for s_ in spans], [s_[3] for s_ in spans]))
    idle = collections.Counter()
    k = 0
    for a, b, name in pieces:
        while k < len(busy) and busy[k][1] <= a:
            k += 1
        cur, m = a, k
        while cur < b:
            if m < len(busy) and busy[m][0] <= cur:
                cur, m = busy[m][1], m + 1
                continue
            nxt = min(busy[m][0], b) if m < len(busy) else b
            idle[name] += nxt - cur
            cur = nxt

    syncs = collections.Counter()
    for p in passes:
        syncs.update(p[7])
    base, lag = recover_base(pairs)
    return {
        "device_s": sum(b - a for _, a, b in device), "window_s": window_s,
        "pass_host_s": pass_s, "device": dict(dev), "ops": dict(ops), "host": dict(host),
        "idle": dict(idle), "syncs": dict(syncs), "base_ns": base, "lag_ns": lag,
        "kernels": {k: (v[0], v[1], sorted(v[2])) for k, v in kernel_hits.items()},
        "segments": [[(round(s[1] * 1e6, 3), round(s[2] * 1e6, 3)) for s in segs]
                     for segs in seg_log],
    }


def share(a: dict, part: str, *names) -> float:
    """Of ``part`` (``"device"``, ``"host"`` or ``"idle"``), the seconds of
    the spans named ``names``, or of the names that start with one that
    ends in ``.``."""
    return sum(v for k, v in a[part].items()
               if any(k == n or (n.endswith(".") and k.startswith(n)) for n in names))


def table(a: dict) -> list:
    """The log lines of a reading: every span's device, host and idle ms,
    the syncs by site and the attribution's own checks."""
    names = sorted(set(a["device"]) | set(a["host"]) | set(a["idle"]),
                   key=lambda n: -a["device"].get(n, 0.0))
    parts = sum(a["device"].values())
    lines = [f"[spans] base {a['base_ns']} ns (least launch lag {a['lag_ns'] / 1e3:.1f} us); "
             f"clock offsets by pass (us, width): {a['segments'][:1]}"
             f"{' ...' if len(a['segments']) > 1 else ''}",
             f"[spans] parts {parts:.6f} s of device time {a['device_s']:.6f} s "
             f"({100 * (parts / a['device_s'] - 1):+.4f}%); window {a['window_s']:.3f} s, "
             f"passes {a['pass_host_s']:.3f} s on the host",
             "[spans] kernel or copy: in the span that made it / all (span)"]
    lines += [f"[spans]   {k}: {v[0]} / {v[1]} ({', '.join(v[2])})"
              for k, v in sorted(a["kernels"].items())]
    lines.append("[spans] span | device ops | device ms | host self ms | device idle ms")
    lines += [f"[spans]   {n} | {a['ops'].get(n, 0)} | {1e3 * a['device'].get(n, 0.0):.3f} | "
              f"{1e3 * a['host'].get(n, 0.0):.3f} | {1e3 * a['idle'].get(n, 0.0):.3f}"
              for n in names]
    lines.append(f"[spans] syncs by site: {dict(sorted(a['syncs'].items()))}")
    return lines
