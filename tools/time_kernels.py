"""Time a redesigned kernel pair of one checkout of the repository on the GPU.

    python3 tools/time_kernels.py ROOT pool|bvh|cluster|binned|frames
    python3 tools/time_kernels.py ROOT resident|flat [NAME=V,V,... ...]

Imports ``chip_smoke`` and ``pathtrace_tpu_torch`` from the checkout at
ROOT, builds its kernels, and times raw launches with CUDA events
(``chip_smoke.cuda_ms``: median of 20 runs of 10 launches) at the host's
setting and, where the checkout's binding takes the knob, at each of its
values:

- ``pool``: ``fused_bounce`` and ``shadow_any_hit`` on the lane states of
  ``chip_smoke.py``'s phase 3 (S = 16,384 lanes of Cornell, many_spheres
  and the ON/PBR scene), at every split of their sweeps (``SPLITS``); where
  the checkout's launcher takes ``raygen`` and ``fuse_shadow``, also
  ``fused_bounce``'s opt-in modes on phase 3i's lanes of Cornell and
  many_spheres in float32 and float64 (this tree's
  ``chip_smoke.raygen_lanes`` and ``mode_times``): each mode's instance at
  every split, and in turns (old, new, new, old) at every split the fused
  shadow against the split pair it replaces and the raygen mode against
  the split path's glue + ``fused_bounce``, by events and queued;
- ``bvh``: ``bvh_closest`` and ``bvh_anyhit`` on the lanes of phase 3b
  (S = 65,536 camera and bounce rays of the 70k-triangle mesh scene, capped
  by the sphere hits, and their NEE shadow rays), at every team size
  (``TEAMS``);
- ``cluster``: the clustered ``sphere_closest`` and ``any_hit`` (sphere and
  triangle boxes) on the lanes of phase 3e (camera and bounce rays of the
  1,940-sphere field and their NEE shadow rays) at 16,384 and 65,536 lanes,
  and the flat ``any_hit`` on the 65,536 shadow lanes of
  ``mesh_scene(2000)`` with its triangle boxes, at every team size where
  the checkout's launchers take ``team``; and the one-tile modes on the
  lanes of phase 3b (3 spheres) at the host's team;
- ``binned``: the binned round pair (``binned_round_closest``,
  ``binned_round_anyhit``) on the waves of phase 3d: every round's sorted
  wave of one call of each binned driver on the 65,536 lanes of phase 3b,
  captured by this tree's ``chip_smoke.capture_rounds`` (``ops/binned.py``
  is the same in the checkouts compared), timed on the first round's wave
  alone and summed over the call's waves (one event pair around all of
  them; ``chip_smoke.queued_ms`` of this tree, so the host's launch
  overhead between the small tail waves is not counted), at every team size
  where the checkout's launchers take ``team``; and config 4 at 1 spp under
  ``method="binned"`` (phase 5d's frame), each hand-written kernel's device
  ms an iteration from ``torch.profiler`` (``chip_smoke.device_work`` of
  this tree), at the host's teams;
- ``resident``: ``resident_closest`` and ``resident_anyhit`` on the lanes
  of phase 3b (as ``bvh``, on the resident route's tables), at every team
  size where the checkout's launchers take ``team``, and at each
  combination of the values ``NAME=V,V,...`` gives the other integer
  keywords the checkout's launchers take (a launch that refuses a setting
  counts as null; a keyword a launcher lacks is left out); and config 4 at
  1 spp under ``method="resident"`` as for ``binned``, at the host's teams
  and, where the checkout has ``RESIDENT_TEAM``, with both kernels at each
  team of ``frame=K,K,...``;
- ``flat``: ``combined_closest_small`` on phase 3c's 65,536 lanes of
  Cornell and many_spheres, ``triangle_closest`` on its 65,536 lanes of
  ``mesh_scene(2000)`` and on the first 16,384 lanes of the 1,940-sphere
  field (capped by the sphere hits as ``intersect`` caps them), at the
  host's team and at every team size where the checkout's launchers take
  ``team``, each combined with the values of ``NAME=V,V,...`` (as for
  ``resident``), timed both as for the other pairs and with the launches
  queued behind a spin kernel (``chip_smoke.queued_ms`` of this tree: the
  kernels alone, which on these small launches the host's launch gaps
  hide); and the field's 1-spp pool frame (phase 5e's frame at 1
  spp), its device ms and each hand-written kernel's device ms an
  iteration (``chip_smoke.device_work`` of this tree);
- ``frames``: whole fused-pool frames through the checkout's
  ``render_pool`` (``FRAMES``: many_spheres and the ON/PBR scene at
  1920x1080, 1 spp, 32 bounces, 16,384 slots, and the Cornell box at
  128x128, 1 spp, 16 bounces, 4,096 slots, each in float32 and float64),
  each rendered once to warm up and then ``FRAME_RUNS`` times, timed on
  the host's clock to a forced read of the image: walls, rays, iterations
  and the image's sum, so two checkouts' frames can be held equal.

Prints one JSON line: the card, ROOT, and the milliseconds (kernels per
setting; per scene for ``pool``, per lane set for ``cluster`` and ``flat``,
per wave set for ``binned``, with its rounds and ray-rounds; per team and
setting for ``resident``; seconds per frame and dtype for ``frames``). To compare
two versions on one card, run it in turns in one command (old, new, new,
old), each checkout in its own process.
"""

from __future__ import annotations

import inspect
import json
import os
import sys
from pathlib import Path

import torch


def pair_ms(cs, knob, values, *fns, timer=None):
    """``{setting: (ms of fn(**kw) for each of fns)}`` at the host's setting
    ("host", no keyword) and at each of ``values`` as ``knob=value``;
    ``timer`` (default ``cs.cuda_ms``) times one function."""
    timer = timer or cs.cuda_ms
    times = {}
    for value in (None,) + tuple(values):
        kw = {} if value is None else {knob: value}
        times["host" if value is None else str(value)] = tuple(
            timer(lambda: fn(**kw)) for fn in fns)
    return times


def pool_ms(cs, binding, dev):
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade

    ms = {}
    for name, scene, camera in (
        ("cornell", scenes.cornell_box(dev), scenes.cornell_camera(128, 128, dev)),
        ("many_spheres", scenes.many_spheres(device=dev),
         scenes.many_spheres_camera(1920, 1080, dev)),
        ("on_pbr", cs.on_pbr_scene(dev), scenes.default_spheres_camera(1920, 1080, dev)),
    ):
        tables = shade.build_tables(scene)
        batch = cs.lane_states(scene, camera, tables, cs.SLICE_S)
        kw = cs.bounce_kwargs(scene, "mis", 16)
        ref = shade.fused_bounce_reference(tables, *batch, **kw)
        so, sd, st = ref.next_o, ref.shadow_d, ref.shadow_tmax
        out = shade.BounceResult(*(torch.empty_like(x) for x in ref))
        occ = torch.empty(st.shape, dtype=torch.bool, device=dev)
        launch = dict(num_tris=kw["num_tris"], num_lights=kw["num_lights"],
                      max_bounces=kw["max_bounces"], eps=shade.EPS,
                      **shade.kernel_flags("mis", scene.has_tri_lights, scene.has_sph_lights,
                                           scene.has_oren_nayar, scene.has_pbr))
        ms[name] = pair_ms(
            cs, "split", getattr(binding, "SPLITS", ()),
            lambda **x: binding.launch_fused_bounce(tables, *batch, out, **launch, **x),
            lambda **x: binding.launch_shadow_any_hit(tables, so, sd, st, occ, eps=shade.EPS,
                                                      **x))
    if "fuse_shadow" in inspect.signature(binding.launch_fused_bounce).parameters:
        ms["modes"] = modes_ms(_this_tree_smoke(), cs, dev)
    return ms


def modes_ms(here, cs, dev):
    """``fused_bounce``'s opt-in modes, by dtype and scene: this tree's
    ``chip_smoke.mode_times`` on phase 3i's lanes at every split."""
    from pathtrace_tpu_torch.kernels import binding
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import shade
    from pathtrace_tpu_torch.render import cast_floats

    ms = {}
    for dtype in (torch.float32, torch.float64):
        for name, scene, camera in (
            ("cornell", scenes.cornell_box(dev), scenes.cornell_camera(128, 128, dev)),
            ("many_spheres", scenes.many_spheres(device=dev),
             scenes.many_spheres_camera(1920, 1080, dev)),
        ):
            scene, camera = cast_floats(scene, dtype), cast_floats(camera, dtype)
            tables = shade.build_tables(scene)
            batch = cs.lane_states(scene, camera, tables, cs.SLICE_S)
            pre, raygen, merged = here.raygen_lanes(camera, batch)
            by_split, turns = here.mode_times(tables, pre, raygen, merged,
                                              cs.bounce_kwargs(scene, "mis", 16), camera,
                                              turn_splits=binding.SPLITS)
            ms[f"{name}_{str(dtype).removeprefix('torch.')}"] = {"by_split": by_split,
                                                                  "turns": turns}
    return ms


def bvh_ms(cs, binding, dev):
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import intersect, shade

    scene = scenes.mesh_scene(device=dev)
    camera = scenes.mesh_scene_camera(1920, 1080, dev)
    tables = intersect.build_tables(scene)
    (o, d), (so, sd, st) = cs.lane_rays(scene, camera, tables, cs.MESH_S)
    S = o.shape[0]
    lo = torch.full((S,), shade.EPS, device=dev)
    hi = torch.full((S,), float("inf"), device=dev)
    hi_t = torch.minimum(hi, intersect.sphere_closest_reference(tables.sph, o, d, lo, hi)[0])
    out = (torch.empty(S, device=dev), torch.empty(S, dtype=torch.int32, device=dev),
           torch.empty((S, 3), device=dev), torch.empty(S, dtype=torch.int32, device=dev))
    occ = torch.empty(S, dtype=torch.bool, device=dev)
    return pair_ms(
        cs, "team", getattr(binding, "TEAMS", ()),
        lambda **x: binding.launch_bvh_closest(tables, o, d, lo, hi_t, *out, **x),
        lambda **x: binding.launch_bvh_anyhit(tables, so, sd, lo, st, occ, **x))


def cluster_ms(cs, binding, dev):
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import intersect, shade

    def lanes(scene, camera):
        tables = intersect.build_tables(scene)
        (o, d), (so, sd, st) = cs.lane_rays(scene, camera, tables, cs.WAVE_S)
        return tables, o, d, so, sd, st

    S = cs.WAVE_S
    lo = torch.full((S,), shade.EPS, device=dev)
    hi = torch.full((S,), float("inf"), device=dev)
    out = (torch.empty(S, device=dev), torch.empty(S, dtype=torch.int32, device=dev),
           torch.empty((S, 3), device=dev), torch.empty(S, dtype=torch.int32, device=dev))
    occ = torch.empty(S, dtype=torch.bool, device=dev)
    teams = (binding.TEAMS if "team" in inspect.signature(binding.launch_sphere_closest).parameters
             else ())
    t, o, d, so, sd, st = lanes(cs.sphere_field(dev), scenes.many_spheres_camera(1920, 1080, dev))
    tri = t.tri[:t.tri_rows]
    ms = {}
    for m in (cs.SLICE_S, S):
        ms[str(m)] = pair_ms(
            cs, "team", teams,
            lambda **x: binding.launch_sphere_closest(t.sph, o[:m], d[:m], lo[:m], hi[:m],
                                                      *(y[:m] for y in out), box=t.sph_box, **x),
            lambda **x: binding.launch_any_hit(t.sph, tri, so[:m], sd[:m], lo[:m], st[:m],
                                               occ[:m], sph_box=t.sph_box, tri_box=t.leaf, **x))
    t, _, _, so, sd, st = lanes(scenes.mesh_scene(cs.FLAT_TRIS, device=dev),
                                scenes.mesh_scene_camera(1920, 1080, dev))
    tri = t.tri[:t.tri_rows]
    ms[f"mesh_{cs.FLAT_TRIS}"] = pair_ms(
        cs, "team", teams,
        lambda **x: binding.launch_any_hit(t.sph, tri, so, sd, lo, st, occ, tri_box=t.leaf, **x))
    t, o, d, so, sd, st = lanes(scenes.mesh_scene(device=dev),
                                scenes.mesh_scene_camera(1920, 1080, dev))
    ms["one_tile"] = pair_ms(   # phase 3b's config-4 lanes, 3 spheres, at the host's team
        cs, "team", (),
        lambda: binding.launch_sphere_closest(t.sph, o, d, lo, hi, *out),
        lambda: binding.launch_any_hit(t.sph, t.tri[:0], so, sd, lo, st, occ))
    return ms


def binned_ms(cs, binding, dev):
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import binned, intersect, shade

    capture = _this_tree_smoke()
    scene = scenes.mesh_scene(device=dev)
    camera = scenes.mesh_scene_camera(1920, 1080, dev)
    tables = intersect.build_tables(scene)
    (o, d), (so, sd, st) = cs.lane_rays(scene, camera, tables, cs.MESH_S)
    S = o.shape[0]
    lo = torch.full((S,), shade.EPS, device=dev)
    hi = torch.full((S,), float("inf"), device=dev)
    hi_t = torch.minimum(hi, intersect.sphere_closest_reference(tables.sph, o, d, lo, hi)[0])
    tb = intersect.build_tables(scene, "binned")
    _, waves_c = capture.capture_rounds(binned.triangle_closest_binned, tb, o, d, lo, hi_t)
    _, waves_a = capture.capture_rounds(binned.triangle_anyhit_binned, tb, so, sd, lo, st)
    outs_c = [(torch.empty(n, device=dev), torch.empty(n, dtype=torch.int32, device=dev),
               torch.empty((n, 3), device=dev), torch.empty(n, dtype=torch.int32, device=dev))
              for n in (w[4].shape[0] for w in waves_c)]
    occs_a = [torch.empty(w[4].shape[0], dtype=torch.bool, device=dev) for w in waves_a]
    teams = (binding.TEAMS if "team" in inspect.signature(
        binding.launch_binned_round_closest).parameters else ())

    def closest(j, **x):
        binding.launch_binned_round_closest(tb, *waves_c[j], *outs_c[j], **x)

    def anyhit(j, **x):
        binding.launch_binned_round_anyhit(tb, *waves_a[j], occs_a[j], **x)

    return {
        "frame": _frame(capture, cs, scene, camera, "binned"),
        "first_round": pair_ms(cs, "team", teams, lambda **x: closest(0, **x),
                               lambda **x: anyhit(0, **x)),
        "driver_call": pair_ms(cs, "team", teams,
                               lambda **x: [closest(j, **x) for j in range(len(waves_c))],
                               lambda **x: [anyhit(j, **x) for j in range(len(waves_a))],
                               timer=capture.queued_ms),
        "rounds": (len(waves_c), len(waves_a)),
        "ray_rounds": (sum(w[4].shape[0] for w in waves_c), sum(w[4].shape[0] for w in waves_a)),
    }


def knob_ms(cs, binding, name, fn, knobs, timer=None):
    """``{"host": ms, setting: ms}`` of ``fn(**kw)``, the raw launches of
    ``binding.launch_<name>``: at the host's setting, and at every team
    (where that launcher takes ``team``) combined with each value of the
    other keywords of ``knobs`` it takes (``{name: (int, ...)}``; a setting
    the launcher refuses counts as null, a keyword it lacks is left out);
    ``timer`` (default ``cs.cuda_ms``) times one function."""
    import itertools

    timer = timer or cs.cuda_ms

    takes = inspect.signature(getattr(binding, "launch_" + name)).parameters
    names = [k for k in ("team", *knobs) if k in takes]
    values = [binding.TEAMS if k == "team" else knobs[k] for k in names]
    ms = {"host": timer(fn)}
    for combo in (itertools.product(*values) if names else ()):
        kw = dict(zip(names, combo))
        try:
            fn(**kw)
        except (ValueError, RuntimeError):
            ms[json.dumps(kw)] = None      # a setting the launcher refuses
            continue
        ms[json.dumps(kw)] = timer(lambda: fn(**kw))
    return ms


def flat_ms(cs, binding, dev, knobs):
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import intersect, shade
    from pathtrace_tpu_torch.pool import render_pool

    here = _this_tree_smoke()
    S = cs.WAVE_S
    out = (torch.empty(S, device=dev), torch.empty(S, dtype=torch.int32, device=dev),
           torch.empty((S, 3), device=dev), torch.empty(S, dtype=torch.int32, device=dev))

    def lane_ms(scene, camera, m):
        """The scene's kernel on the first ``m`` of phase 3c's lanes: CUDA
        events around back-to-back launches (``events``) and launches queued
        behind a spin kernel (``queued``: the kernel alone, no host launch
        gaps)."""
        tables = intersect.build_tables(scene)
        (o, d), _ = cs.lane_rays(scene, camera, tables, S)
        o, d, res = o[:m], d[:m], tuple(x[:m] for x in out)
        lo = torch.full((m,), shade.EPS, device=dev)
        hi = torch.full((m,), float("inf"), device=dev)
        if tables.route == "small":
            name = "combined_closest_small"
        else:
            name = "triangle_closest"
            hi = torch.minimum(hi, intersect.sphere_closest_reference(
                tables.sph, o, d, lo, hi)[0])
        launch = getattr(binding, "launch_" + name)

        def fn(**x):
            launch(tables, o, d, lo, hi, *res, **x)

        return name, {"events": knob_ms(cs, binding, name, fn, knobs),
                      "queued": knob_ms(cs, binding, name, fn, knobs, timer=here.queued_ms)}

    ms = {}
    for name, scene, camera, m in (
        ("cornell", scenes.cornell_box(dev), scenes.cornell_camera(400, 400, dev), S),
        ("many_spheres", scenes.many_spheres(device=dev),
         scenes.many_spheres_camera(1920, 1080, dev), S),
        (f"mesh_{cs.FLAT_TRIS}", scenes.mesh_scene(cs.FLAT_TRIS, device=dev),
         scenes.mesh_scene_camera(1920, 1080, dev), S),
        ("field", cs.sphere_field(dev), scenes.many_spheres_camera(1920, 1080, dev), cs.SLICE_S),
    ):
        kernel, times = lane_ms(scene, camera, m)
        ms[f"{kernel} {name} {m}"] = times
    # The field's 1-spp pool frame (phase 5e's at 1 spp): device ms, and each
    # hand-written kernel's device ms an iteration.
    scene, res = cs.sphere_field(dev), []
    camera = scenes.many_spheres_camera(cs.CLUSTER_FRAME["width"], cs.CLUSTER_FRAME["height"], dev)
    one = dict(cs.CLUSTER_FRAME, spp=1)
    render_pool(scene, camera, **one)                # warm-up
    dev_ms, _, kernel_ms = here.device_work(lambda: res.append(render_pool(scene, camera, **one)))
    iters = res[0][2]
    ms["field_frame_1spp"] = {"device_ms": dev_ms, "iters": iters,
                              "kernel_device_ms_per_iter": {k: v / iters
                                                            for k, v in kernel_ms.items()}}
    return ms


def resident_ms(cs, binding, dev, knobs):
    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.ops import intersect, shade

    here = _this_tree_smoke()
    scene = scenes.mesh_scene(device=dev)
    camera = scenes.mesh_scene_camera(1920, 1080, dev)
    (o, d), (so, sd, st) = cs.lane_rays(scene, camera, intersect.build_tables(scene), cs.MESH_S)
    S = o.shape[0]
    lo = torch.full((S,), shade.EPS, device=dev)
    hi = torch.full((S,), float("inf"), device=dev)
    tr = intersect.build_tables(scene, "resident")
    hi_t = torch.minimum(hi, intersect.sphere_closest_reference(tr.sph, o, d, lo, hi)[0])
    out = (torch.empty(S, device=dev), torch.empty(S, dtype=torch.int32, device=dev),
           torch.empty((S, 3), device=dev), torch.empty(S, dtype=torch.int32, device=dev))
    occ = torch.empty(S, dtype=torch.bool, device=dev)
    launch = {"resident_closest": lambda **x: binding.launch_resident_closest(
                  tr, o, d, lo, hi_t, *out, **x),
              "resident_anyhit": lambda **x: binding.launch_resident_anyhit(
                  tr, so, sd, lo, st, occ, **x)}
    frame_teams = knobs.pop("frame", ())
    ms = {name: knob_ms(cs, binding, name, fn, knobs) for name, fn in launch.items()}
    frames = {"host": _frame(here, cs, scene, camera, "resident")}
    if hasattr(binding, "RESIDENT_TEAM"):
        host = dict(binding.RESIDENT_TEAM)
        for team in frame_teams:
            binding.RESIDENT_TEAM.update({k: team for k in host})
            try:
                frames[str(team)] = _frame(here, cs, scene, camera, "resident")
            finally:
                binding.RESIDENT_TEAM.update(host)
    return {"lanes": ms, "frame": frames}


FRAME_RUNS = 3
# (name, render_pool arguments) of ``frames``; each runs in both dtypes.
FRAMES = (
    ("many_spheres", dict(width=1920, height=1080, spp=1, integrator="mis", max_bounces=32,
                          num_slots=16384, seed=0)),
    ("on_pbr", dict(width=1920, height=1080, spp=1, integrator="mis", max_bounces=32,
                    num_slots=16384, seed=0)),
    ("cornell", dict(width=128, height=128, spp=1, integrator="mis", max_bounces=16,
                     num_slots=4096, seed=0)),
)


def frames_ms(cs, binding, dev):
    """``frames``: each frame of ``FRAMES`` in float32 and float64."""
    import time

    from pathtrace_tpu_torch.models import scenes
    from pathtrace_tpu_torch.pool import ray_count, render_pool

    out = {}
    for name, run in FRAMES:
        W, H = run["width"], run["height"]
        scene, camera = {
            "many_spheres": lambda: (scenes.many_spheres(device=dev),
                                     scenes.many_spheres_camera(W, H, dev)),
            "on_pbr": lambda: (cs.on_pbr_scene(dev), scenes.default_spheres_camera(W, H, dev)),
            "cornell": lambda: (scenes.cornell_box(dev), scenes.cornell_camera(W, H, dev)),
        }[name]()
        for dtype in (torch.float32, torch.float64):
            walls = []
            for _ in range(1 + FRAME_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img, counters, iters = render_pool(scene, camera, dtype=dtype, **run)
                checksum = float(img.double().sum().item())     # forces completion
                walls.append(time.perf_counter() - t0)
            out[f"{name}_{str(dtype).removeprefix('torch.')}"] = {
                "wall_s": walls[1:], "warm_up_s": walls[0], "rays": ray_count(counters),
                "iters": iters, "checksum": checksum}
    return out


def _this_tree_smoke():
    """This tree's ``chip_smoke`` module, whatever ROOT is."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frame(here, cs, scene, camera, method):
    """Config 4 at 1 spp under ``method`` (phase 5d's frame): device ms, and
    each hand-written kernel's device ms an iteration."""
    from pathtrace_tpu_torch.pool import render_pool

    res = []
    dev_ms, _, kernel_ms = here.device_work(lambda: res.append(
        render_pool(scene, camera, method=method, **dict(cs.CONFIG4, spp=1))))
    iters = res[0][2]
    return {"device_ms": dev_ms, "iters": iters,
            "kernel_device_ms_per_iter": {k: v / iters for k, v in kernel_ms.items()}}


def _knobs(args):
    """``{name: (int, ...)}`` from ``NAME=V,V,...`` arguments."""
    knobs = {}
    for arg in args:
        name, _, vals = arg.partition("=")
        knobs[name] = tuple(int(v) for v in vals.split(","))
    return knobs


def main() -> int:
    pairs = ("pool", "bvh", "cluster", "binned", "resident", "flat", "frames")
    if len(sys.argv) < 3 or sys.argv[2] not in pairs or (
            len(sys.argv) > 3 and sys.argv[2] not in ("resident", "flat")):
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import chip_smoke as cs
    from pathtrace_tpu_torch.kernels import binding, build

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    build.build()
    if sys.argv[2] in ("resident", "flat"):
        fn = resident_ms if sys.argv[2] == "resident" else flat_ms
        ms = fn(cs, binding, dev, _knobs(sys.argv[3:]))
    else:
        ms = {"pool": pool_ms, "bvh": bvh_ms, "cluster": cluster_ms,
              "binned": binned_ms, "frames": frames_ms}[sys.argv[2]](cs, binding, dev)
    print(json.dumps({"card": cs.nvidia_smi_line(), "root": root, "pair": sys.argv[2],
                      "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
