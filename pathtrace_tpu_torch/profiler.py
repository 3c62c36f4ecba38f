"""Render observability: structured per-render statistics and the program's
spans.

Counterpart of ``pathtrace_tpu/profiler.py``: :func:`profiled_render` runs a
pool render and returns a :class:`RenderStats` record beside the render
state, with the JAX package's fields, names and rounding. The timed window
ends with ``torch.cuda.synchronize()`` on the card (the JAX package's
``block_until_ready``), so it holds the device's work and not only its
enqueue. :func:`device_work` reads the device's side of a call from
``torch.profiler``: device time, device operations, and the time of each
named hand-written kernel.

**Spans.** A span is one phase of a render pass, timed on the host: its
name, its start and end in ``time.time_ns()``, its parent span and its pass.
``time.time_ns()`` is the clock of ``torch.profiler``'s chrome trace, whose
event times are ``baseTimeNanoseconds + ts * 1e3``. A pass is one request:
one ``pool._pool_loop`` call (root span ``pool.pass``), one
``render.render`` call (``wave.pass``) or one frame batch of
``parallel.sharding`` (``frames.pass``, its pools' passes spans of it);
:class:`PassRecord` holds its spans in entry order and its counters: the
entries of each span name (the host syncs of each ``sync.*`` site,
``sync.h2d`` the copies of host constants (:func:`from_host`),
``pool.iter`` iterations, ``wave.bounce`` bounces) and the hand-written
kernel launches by name over the pass: the
intersection and shading kernels' (``shade.LAUNCHES``) and the
random-number draw's (``utils/rng.py``'s ``LAUNCHES``).

Tracing is on for a pass inside :func:`tracing`, or when a
``torch.profiler`` session is active as the pass starts; the test is made
once a pass, never a span. Off, a span site costs one shared no-op context:
no allocation, no clock read, no device call (0.2-0.5 us on an H100 host).
On, a span reads the clock and the intersection and shading kernels'
launch count at entry and exit; on a CUDA device it also records a
``torch.cuda.Event`` at entry and exit (no device operation: the events fix
where the span's device work sits in stream order, read by
:meth:`PassRecord.device_ms`); while a profiler session is active it enters
``torch.profiler.record_function(name)`` too, so profiles show the phases. That is 25-40 us a span on an H100 host, a
few percent of a pool iteration (9 spans fused, ~28 composed).

An operator turns it on and reads the pass records::

    with profiler.tracing():
        pool.render_pool(scene, camera, ...)
    rec = profiler.passes()[-1]
    rec.syncs, rec.counts["pool.iter"], rec.launches    # counters
    rec.names, rec.parents, rec.start_ns, rec.end_ns     # spans, host clock
    rec.device_ms()                                      # spans, device clock

The last :data:`MAX_PASSES` records are kept (:func:`passes`, :func:`clear`).
Spans are recorded by the thread that runs the pass; one pass is open at a
time, and a pass opened inside another is a span of it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import re
import time
from typing import TYPE_CHECKING, Callable, Iterable, Optional

import torch

if TYPE_CHECKING:
    from .models.camera import Camera
    from .models.scene import Scene
    from .render import RenderState

MAX_PASSES = 16

_PASSES: collections.deque = collections.deque(maxlen=MAX_PASSES)
_PASS_IDS = itertools.count()
_NOOP = contextlib.nullcontext()
_active: Optional["PassRecord"] = None   # the open pass, None when tracing is off
_forced = 0                              # depth of open tracing() contexts


class PassRecord:
    """One traced pass: its spans in entry order (span 0 the pass itself)
    as parallel lists, and its counters."""

    def __init__(self, kind: str, device, profiled: bool):
        from .ops import shade
        from .utils import rng

        self.pass_id = next(_PASS_IDS)
        self.kind = kind
        self.device = torch.device(device)
        self.profiled = profiled
        self.names: list = []
        self.parents: list = []      # index of the parent span, -1 for the pass
        self.start_ns: list = []
        self.end_ns: list = []
        self.launch_in: list = []    # shade.LAUNCHES launches of the pass before entry
        self.launch_out: list = []   # ... and before exit
        self.events = [] if self.device.type == "cuda" else None
        self._stream = torch.cuda.current_stream(self.device) if self.events is not None else None
        self.counts: collections.Counter = collections.Counter()
        self.launches: collections.Counter = collections.Counter()
        self._counter = shade.LAUNCHES
        self._before = collections.Counter(shade.LAUNCHES)
        self._base = sum(self._before.values())
        self._draws = rng.LAUNCHES
        self._draws_before = collections.Counter(rng.LAUNCHES)
        self._stack: list = []

    @property
    def syncs(self) -> dict:
        """Host syncs of the pass by site: the entries of each ``sync.*`` span."""
        return {k: v for k, v in self.counts.items() if k.startswith("sync.")}

    def _enter(self, name: str):
        i = len(self.names)
        self.names.append(name)
        self.parents.append(self._stack[-1] if self._stack else -1)
        self.counts[name] += 1
        self.start_ns.append(time.time_ns())
        self.end_ns.append(0)
        rf = None
        if self.profiled:
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        self.launch_in.append(sum(self._counter.values()) - self._base)
        self.launch_out.append(0)
        if self.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self._stream)
            self.events.append([ev, None])
        self._stack.append(i)
        return i, rf

    def _exit(self, i: int, rf) -> None:
        if self.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self._stream)
            self.events[i][1] = ev
        self.launch_out[i] = sum(self._counter.values()) - self._base
        if rf is not None:
            rf.__exit__(None, None, None)
        self.end_ns[i] = time.time_ns()
        self._stack.pop()

    def device_ms(self) -> list | None:
        """``(entry, exit)`` of each span in ms from the pass's entry event,
        by the device's clock (CUDA events in stream order); None off the
        card. Waits for the pass's last event."""
        if not self.events:
            return None
        ref = self.events[0][0]
        self.events[0][1].synchronize()
        return [(ref.elapsed_time(a), ref.elapsed_time(b)) for a, b in self.events]


class _Span:
    __slots__ = ("_rec", "_name", "_i", "_rf")

    def __init__(self, rec: PassRecord, name: str):
        self._rec, self._name = rec, name

    def __enter__(self):
        self._i, self._rf = self._rec._enter(self._name)

    def __exit__(self, *exc):
        self._rec._exit(self._i, self._rf)
        return False


class _Pass:
    def __init__(self, kind: str, device, profiled: bool):
        self._args = (kind, device, profiled)

    def __enter__(self):
        global _active
        self._rec = PassRecord(*self._args)
        self._i, self._rf = self._rec._enter(f"{self._rec.kind}.pass")
        _active = self._rec

    def __exit__(self, *exc):
        global _active
        rec, _active = self._rec, None
        rec._exit(self._i, self._rf)
        rec.launches = ((collections.Counter(rec._counter) - rec._before)
                        + (collections.Counter(rec._draws) - rec._draws_before))
        _PASSES.append(rec)
        return False


def span(name: str):
    """A context that records the span ``name`` in the open pass; the shared
    no-op context when tracing is off."""
    rec = _active
    if rec is None:
        return _NOOP
    return _Span(rec, name)


def from_host(like: torch.Tensor, data, dtype=None) -> torch.Tensor:
    """``like.new_tensor(data, dtype=dtype)``: a copy from the host, which on
    the card waits for the stream's queued work (a host sync), recorded as a
    ``sync.h2d`` span."""
    with span("sync.h2d"):
        return like.new_tensor(data, dtype=dtype)


def _profiler_active() -> bool:
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled", False)
                or torch.autograd._profiler_enabled())


def traced_pass(kind: str, device):
    """The context of one pass (``"pool"``, ``"wave"`` or ``"frames"``) on ``device``:
    records a :class:`PassRecord` when :func:`tracing` is open or a
    ``torch.profiler`` session is active; inside an open pass, a span of it."""
    if _active is not None:
        return _Span(_active, f"{kind}.pass")
    profiled = _profiler_active()
    if not (_forced or profiled):
        return _NOOP
    return _Pass(kind, device, profiled)


@contextlib.contextmanager
def tracing():
    """Record every pass that starts inside this context."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def passes() -> list:
    """The last :data:`MAX_PASSES` pass records, oldest first."""
    return list(_PASSES)


def clear() -> None:
    """Forget every pass record."""
    _PASSES.clear()


@dataclasses.dataclass
class RenderStats:
    width: int
    height: int
    spp: int
    integrator: str
    traced_rays: int
    pool_iterations: int
    wall_s: float
    mrays_per_s: float
    spp_per_s: float
    platform: str   # "cuda" or "cpu": the device the render ran on

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def profiled_render(
    scene: Scene,
    camera: Camera,
    *,
    width: int,
    height: int,
    spp: int,
    integrator: str = "mis",
    max_bounces: int = 64,
    num_slots: int = 32768,
    seed: int = 0,
    sample_offset: int = 0,
    state: Optional[RenderState] = None,
):
    """Pool render on ``scene.device`` returning ``(RenderState, RenderStats)``;
    ``state``, when given, is the progressive state this render adds to.

    The wall includes building the CUDA kernels on a process's first launch;
    render once before (or pre-warm) for steady-state numbers.
    """
    from .pool import ray_count, render_pool
    from .render import RenderState

    t0 = time.perf_counter()
    image_sum, rays, iters = render_pool(
        scene,
        camera,
        width=width,
        height=height,
        spp=spp,
        integrator=integrator,
        max_bounces=max_bounces,
        num_slots=num_slots,
        seed=seed,
        sample_offset=sample_offset,
    )
    if image_sum.is_cuda:
        torch.cuda.synchronize(image_sum.device)
    wall = time.perf_counter() - t0

    traced = ray_count(rays)
    image = image_sum.reshape(height, width, 3)
    if state is not None:
        image = state.image_sum + image
        spp_total, queries = state.num_samples + spp, state.ray_queries + traced
    else:
        spp_total, queries = spp, traced

    stats = RenderStats(
        width=width,
        height=height,
        spp=spp,
        integrator=integrator,
        traced_rays=traced,
        pool_iterations=int(iters),
        wall_s=round(wall, 4),
        mrays_per_s=round(traced / wall / 1e6, 3),
        spp_per_s=round(spp / wall, 4),
        platform=scene.device.type,
    )
    return RenderState(image, spp_total, queries), stats


def device_work(fn: Callable[[], object], kernel_names: Iterable[str]
                ) -> tuple[float | None, int, dict]:
    """``(ms, ops, kernel_ms)`` of one call of ``fn`` on the card, from
    ``torch.profiler`` with CUDA activity only: the device time, the number
    of device operations (kernels, copies, fills), and the device ms of each
    kernel of ``kernel_names`` that ran (the hand-written kernels are
    ``<name>_kernel`` in ``csrc/``). ``ms`` is None when the profiler saw no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    pattern = re.compile(r"(?<!\w)(" + "|".join(kernel_names) + r")_kernel\b")
    first = next(_PASS_IDS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # The spans of the passes fn ran are annotations, not device operations.
    spans = {n for r in _PASSES if r.pass_id > first for n in r.names}
    us, ops, kernel_us = 0.0, 0, {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if t > 0 and e.key not in spans:
            us += t
            ops += e.count
            match = pattern.search(e.key)
            if match:
                kernel_us[match[1]] = kernel_us.get(match[1], 0.0) + t
    return (us / 1e3 if us > 0 else None), ops, {k: v / 1e3 for k, v in kernel_us.items()}
