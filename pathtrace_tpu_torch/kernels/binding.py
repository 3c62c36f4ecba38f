"""ctypes binding of the CUDA kernels (built by :mod:`.build` at first use).

Each ``launch_*`` takes contiguous CUDA tensors, already checked by the
wrappers in ``ops/shade.py``, ``ops/intersect.py`` and ``ops/binned.py``,
passes their raw pointers and PyTorch's current stream, and raises if the
launch was refused. The kernels allocate nothing
and do not synchronise.

The pool's two kernels (``pt_fused_bounce``, ``pt_shadow_any_hit``) split
each lane's sweep over ``split`` threads; :func:`sweep_split` picks it from
the scene's row count and :func:`launch_shape` gives the block shape. The
BVH kernels (``pt_bvh_closest``, ``pt_bvh_anyhit``) walk each ray with a
team of ``team`` threads (:data:`BVH_TEAM`), and the binned round kernels
(``pt_binned_round_closest``, ``pt_binned_round_anyhit``) split each sorted
ray's cluster sweep over a team (:data:`BINNED_TEAM`), and the resident
kernels (``pt_resident_closest``, ``pt_resident_anyhit``) walk each ray's
128-row clusters with a team (:data:`RESIDENT_TEAM`; the closest hit keeps
each ray's cluster entries in shared memory where they fit,
:func:`resident_cached`). The sphere pair of
``csrc/intersect.cu`` (``pt_sphere_closest``, ``pt_any_hit``) walks each
ray's clusters with a team too, chosen by the same rule as a split: the
fewest threads of :data:`TEAMS` that leave each at most
``ROWS_PER_THREAD[kernel]`` rows of one cluster's sweep (256 rows in the
clustered mode, the table's rows in one tile, so one thread on the small
tables; :func:`cluster_team`). The flat route's ``pt_triangle_closest``
walks each ray's 256-row clusters nearest-first with a team too, its sweep
stopped at the table's real rows (:func:`flat_team`, from the longest
cluster's real rows), and ``pt_combined_closest_small`` splits each ray's
triangle and sphere sweeps over a team (:func:`small_team`). Every split
and every team gives the same bits and counts.

Every entry point also has a float64 instance, its name ending in
``_f64`` (``pt_fused_bounce_f64`` ... ``pt_resident_anyhit_f64``): the
launchers pick the instance from the tensors' dtype (:func:`_instance`),
pass ``eps`` as a double, and size the shared memory by the element size
(:func:`shared_bytes`, :func:`resident_cached`). The teams are the same in
both types but for ``triangle_closest``'s (:data:`ROWS_PER_THREAD_F64`),
``bvh_closest``'s (:data:`BVH_TEAM_F64`) and ``binned_round_closest``'s
(:data:`BINNED_TEAM_F64`). Nothing falls back from one instance to the
other.

The random-number draw has kernels too (``csrc/rng.cu``; its plain-torch
twin is ``utils/rng.py``, which the CPU takes): ``pt_rng_pool_uniforms``
(the pool's (9, S) uniforms from the base key, pixel, sample and bounce in
one launch), ``pt_rng_bounce_uniforms`` (the wave's from per-lane keys and
one bounce) and ``pt_rng_fold`` (the key folds of ``pixel_sample_keys`` and
``light_sample_keys``); the two draws have ``_f64`` instances. Every call
gives the twin's bits: integers only.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.scene import CLUSTER_SIZE
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_L = ctypes.c_longlong

_lib: ctypes.CDLL | None = None

# The launch-counter suffix of each float instance (``LAUNCHES`` of
# ``ops/shade.py`` and ``utils/rng.py``): a float64 instance counts under its
# name with ``_f64`` appended.
SUFFIX = {torch.float32: "", torch.float64: "_f64"}


def check(name, x, dtype, shape):
    """Raises unless ``x`` is a contiguous ``dtype`` tensor of ``shape``:
    what a kernel reads, checked by the wrappers before either route."""
    if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {shape}, got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )


def device_kind(x: torch.Tensor) -> str:
    """The route of a wrapper call: ``"cpu"`` (the torch twin) or ``"cuda"``
    (the kernel); raises on any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type

SPLITS = (1, 2, 4, 8, 16)      # threads a lane's sweep can take
SHARED_LIMIT = 48 * 1024       # dynamic shared memory without an opt-in attribute
_SPH_USE, _TRI_USE, _LGT_COLS = 4, 9, 18   # staged values a sphere, triangle, light row
_SHADOW_USE = 7                # staged values of a lane's shadow ray: origin, direction, t_max


# Rows a thread sweeps at most, by kernel, as measured on an H100 (PERF.md,
# the time at each split or team):
# the vertex kernel's one-thread-per-lane shading sets a floor that larger
# blocks (fewer resident at once) only raise, while the any hit gains down to
# ~32 rows a thread. The cluster walk of csrc/intersect.cu on the 1,940-sphere
# field's 256-row clusters, 65,536 lanes: the closest hit is fastest at 8
# threads (32 rows each; 0.097 ms against 0.105 at 16 and 0.107 at 4), the
# any hit, which only votes, at 32 (8 rows each; 0.061 ms against 0.064 at
# 16); 12 rows keeps one thread on the small one-tile tables (the Cornell
# wave's 11 triangles). Device times, launches queued (tools/time_kernels.py
# flat): the flat walk of csrc/triangle_closest.cu on mesh_scene(2000)'s
# 256-row clusters, 65,536 lanes, is fastest at 8 threads (32 rows each;
# 0.191 ms against 0.196 at 16 and 0.207 at 4), on the sphere field's 2 rows
# at 1 (0.0046 ms against 0.0049 at 2); the split of
# csrc/combined_closest_small.cu on many_spheres' 490 rows at 4 (0.040 ms
# against 0.042 at 2 and 0.044 at 8), on Cornell's 13 rows at 1 (0.0069 ms
# against 0.0074 at 2). fused_bounce's fused-shadow instance (the vertex,
# then the lane's shadow sweep by the same threads) on many_spheres' 496
# rows, 16,384 lanes, is fastest at 8 (62 rows a thread; 0.0469 ms queued
# against 0.0531 at 4 and 0.0513 at 16, tools/time_kernels.py pool), where
# the vertex alone keeps 4.
ROWS_PER_THREAD = {"fused_bounce": 128, "fused_bounce_shadow": 64, "shadow_any_hit": 32,
                   "sphere_closest": 32, "any_hit": 12,
                   "triangle_closest": 32, "combined_closest_small": 128}
# The float64 instances' rows a thread where their times differ (PERF.md
# row 6f): csrc/triangle_closest.cu in double on mesh_scene(2000)'s
# 65,536 lanes is fastest at 4 threads (64 rows each; 0.467 ms against
# 0.655 at 8 and 0.478 at 2; 0.458 against 0.645 and 0.472 in a second
# call). The other float64 instances keep their float32 teams but for the
# BVH closest hit (BVH_TEAM_F64).
ROWS_PER_THREAD_F64 = {"triangle_closest": 64}

TEAMS = (1, 2, 4, 8, 16, 32)   # threads one ray's BVH or cluster walk can take
# Threads sharing one ray's walk in csrc/bvh.cu, by kernel: the fastest of
# TEAMS in chip_smoke.py's times on the 65,536 config-4 lanes of an H100
# (PERF.md): the closest hit 0.165 ms at 16 (0.175 at 8, 0.20 at 32), the
# any hit, which only votes, 0.085 ms at 32 (0.097 at 16).
BVH_TEAM = {"bvh_closest": 16, "bvh_anyhit": 32}
# The float64 instances' teams where their times differ (PERF.md row 7f):
# the closest hit in double is fastest at 8 in two calls (0.451 and 0.456 ms
# against 0.475 and 0.481 at 16); the any hit stays fastest at 32.
BVH_TEAM_F64 = {"bvh_closest": 8}
# Threads sharing one sorted ray's 256-row cluster sweep in csrc/binned.cu,
# by kernel: the fastest of TEAMS in the sum over all 21 (20) rounds of one
# closest (any-hit) driver call on chip_smoke.py's 65,536 config-4 lanes of
# an H100, kernels only (PERF.md): closest 0.302 ms at 16 (0.316 at 32,
# 0.360 at 8), any hit 0.160 ms at 32 (0.197 at 16). Config 4's 1-spp
# binned frame agrees (profiler, per iteration): closest 0.336 ms at 16 and
# 0.333 at 32, any hit 0.184 at 32 and 0.223 at 16. The two ~55,000-ray
# waves of a closest call are fastest at 2 (0.047 ms against 0.079 at 16),
# the 19 tail waves of a few thousand rays or fewer at 16-32.
BINNED_TEAM = {"binned_round_closest": 16, "binned_round_anyhit": 32}
# The float64 instances' teams where their times differ (PERF.md row 9f):
# the closest round in double, summed over a driver call's 21 waves, is
# fastest at 4 (0.751 ms against 0.843 at 16 and 0.862 at 8); its first
# ~55,000-ray wave at 2 (0.080 ms against 0.284 at 16). The any hit stays
# fastest at 32.
BINNED_TEAM_F64 = {"binned_round_closest": 4}
# Threads sharing one ray's walk of the resident route's 128-row clusters in
# csrc/resident.cu, by kernel: the fastest of TEAMS in tools/time_kernels.py's
# times on the 65,536 config-4 lanes of an H100 (PERF.md): the closest hit,
# its entries cached, 0.256 ms at 16 (0.284 at 8, 0.354 at 32); the any hit,
# in id order, 0.107 ms at 32 (0.119 at 16). Config 4's 1-spp resident frame
# agrees (profiler, per iteration): closest 0.266 ms at 16 (0.312 at 8, 0.367
# at 32), any hit 0.150 at 32 and 0.148 at 16.
RESIDENT_TEAM = {"resident_closest": 16, "resident_anyhit": 32}


def sweep_split(rows: int, kernel: str, choices=SPLITS, dtype=torch.float32) -> int:
    """Threads sharing one sweep over ``rows`` rows (the pool's kernels: a
    lane's sphere and triangle rows, the tables' padded row counts): the
    fewest of ``choices`` that leave each thread at most
    ``ROWS_PER_THREAD[kernel]`` rows (one for a small scene, where a split
    only adds shuffles); for the float64 instance (``dtype``) the rows of
    :data:`ROWS_PER_THREAD_F64` where it has them."""
    per = ROWS_PER_THREAD[kernel]
    if dtype == torch.float64:
        per = ROWS_PER_THREAD_F64.get(kernel, per)
    split = 1
    while split < choices[-1] and rows > split * per:
        split *= 2
    return split


def cluster_team(kernel: str, *tables) -> int:
    """The team of :data:`TEAMS` that ``kernel`` (``"sphere_closest"``,
    ``"any_hit"`` or ``"triangle_closest"``) takes on ``tables``, ``(rows,
    boxes)`` pairs of row tables and their cluster boxes (None or no rows:
    one tile): the :func:`sweep_split` of the longest sweep, at most a
    cluster's 256 rows or a whole one-tile table, in the rows' dtype."""
    rows = max(min(t.shape[0], CLUSTER_SIZE) if b is not None and b.shape[0] else t.shape[0]
               for t, b in tables)
    return sweep_split(rows, kernel, TEAMS, tables[0][0].dtype)


def flat_team(tables) -> int:
    """The team of :data:`TEAMS` that ``triangle_closest`` takes on the flat
    route's ``tables``: the :func:`cluster_team` of its real rows, so the
    :func:`sweep_split` of ``min(tri_rows, 256)`` (one thread on the sphere
    field's 2 ground triangles; 8 on 256 rows in float32, 4 in float64)."""
    return cluster_team("triangle_closest", (tables.tri[:tables.tri_rows], tables.leaf))


def small_team(tables) -> int:
    """The team of :data:`TEAMS` that ``combined_closest_small`` takes on the
    small route's ``tables``: the :func:`sweep_split` of its triangle and
    sphere rows."""
    return sweep_split(tables.tri.shape[0] + tables.sph.shape[0], "combined_closest_small",
                       TEAMS)


def launch_shape(split: int) -> tuple[int, int]:
    """``(lanes, threads)`` of a block at ``split`` threads a lane: 128 lanes
    at split 1, 64 at 2, 32 from 4 up, so the lanes that shade fill whole
    warps."""
    if split not in SPLITS:
        raise ValueError(f"split {split} not in {SPLITS}")
    lanes = max(32, 128 // split)
    return lanes, lanes * split


def shared_bytes(n_sph: int, n_tri: int, n_lgt: int = 0, lanes: int = 0,
                 itemsize: int = 4, fuse_shadow: bool = False) -> int:
    """Dynamic shared memory of a block: the sweep's sphere and triangle
    columns, plus (``pt_fused_bounce``) the light table and, for each lane,
    the group winners' two t and two rows, and with ``fuse_shadow`` its
    shadow ray (origin, direction, t_max) and verdict; ``pt_shadow_any_hit``
    stages the first two only (``n_lgt = lanes = 0``). ``itemsize``: 4
    (float32) or 8 (float64; the rows and verdicts are int32 in both)."""
    floats, ints = (2 + _SHADOW_USE, 3) if fuse_shadow else (2, 2)   # a lane's, F and int32
    return (itemsize * (n_sph * _SPH_USE + n_tri * _TRI_USE + n_lgt * _LGT_COLS + lanes * floats)
            + 4 * lanes * ints)


def _shape(tables, split, kernel: str) -> tuple[int, int]:
    """``(split, lanes)`` of a launch of ``kernel`` on ``tables`` (``split``
    None: :func:`sweep_split`); raises past the shared-memory limit.
    ``kernel``: ``"fused_bounce"``, its fused-shadow instance
    ``"fused_bounce_shadow"`` or ``"shadow_any_hit"``."""
    n_sph, n_tri = tables.sph.shape[0], tables.tri.shape[0]
    split = sweep_split(n_sph + n_tri, kernel) if split is None else split
    lanes, _ = launch_shape(split)
    size = tables.sph.element_size()
    if kernel.startswith("fused_bounce"):
        smem = shared_bytes(n_sph, n_tri, tables.lgt.shape[0], lanes, size,
                            fuse_shadow=kernel == "fused_bounce_shadow")
    else:
        smem = shared_bytes(n_sph, n_tri, itemsize=size)
    if smem > SHARED_LIMIT:
        raise ValueError(f"{smem} bytes of shared memory exceed {SHARED_LIMIT}")
    return split, lanes


def library() -> ctypes.CDLL:
    """Load (building first if needed) the kernel library, once per process."""
    global _lib
    if _lib is None:
        path, _ = build.build()
        lib = ctypes.CDLL(str(path))
        for name, real in (("pt_fused_bounce", _F), ("pt_fused_bounce_f64", _D)):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 12 + [_P, _I, _P, _I, _P, _I] + [_P] * 11 + \
                [_I] * 12 + [real, _I, _I, _P]
            fn.restype = _I
        for name, real in (("pt_shadow_any_hit", _F), ("pt_shadow_any_hit_f64", _D)):
            fn = getattr(lib, name)
            fn.argtypes = [_P, _I, _P, _I, _P, _P, _P, _P, _I, real, _I, _I, _P]
            fn.restype = _I
        for name in ("pt_sphere_closest", "pt_sphere_closest_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [_P, _I, _P, _I, _I] + [_P] * 8 + [_I, _P]
            fn.restype = _I
        for name in ("pt_any_hit", "pt_any_hit_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [_P, _I] * 4 + [_I] + [_P] * 5 + [_I, _P]
            fn.restype = _I
        for suffix in ("", "_f64"):
            fn = getattr(lib, "pt_bvh_closest" + suffix)
            fn.argtypes = [_P] * 3 + [_I] * 2 + [_P] * 10 + [_I, _P]
            fn.restype = _I
            fn = getattr(lib, "pt_bvh_anyhit" + suffix)
            fn.argtypes = [_P] * 3 + [_I] * 2 + [_P] * 7 + [_I, _P]
            fn.restype = _I
        for name in ("pt_combined_closest_small", "pt_combined_closest_small_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [_P, _I, _P, _I, _I, _I] + [_P] * 8 + [_I, _P]
            fn.restype = _I
        for name in ("pt_triangle_closest", "pt_triangle_closest_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [_P, _P, _I, _I, _I] + [_P] * 8 + [_I, _P]
            fn.restype = _I
        for suffix in ("", "_f64"):
            fn = getattr(lib, "pt_binned_round_closest" + suffix)
            fn.argtypes = [_P, _I, _I] + [_P] * 9 + [_I, _P]
            fn.restype = _I
            fn = getattr(lib, "pt_binned_round_anyhit" + suffix)
            fn.argtypes = [_P, _I, _I] + [_P] * 6 + [_I, _P]
            fn.restype = _I
            fn = getattr(lib, "pt_resident_closest" + suffix)
            fn.argtypes = [_P, _P, _I, _I, _I] + [_P] * 8 + [_I, _P]
            fn.restype = _I
            fn = getattr(lib, "pt_resident_anyhit" + suffix)
            fn.argtypes = [_P, _P, _I, _I] + [_P] * 5 + [_I, _P]
            fn.restype = _I
            fn = getattr(lib, "pt_rng_pool_uniforms" + suffix)
            fn.argtypes = [_P] * 6 + [_I, _P]
            fn.restype = _I
            fn = getattr(lib, "pt_rng_bounce_uniforms" + suffix)
            fn.argtypes = [_P, _P, _L, _P, _I, _P]
            fn.restype = _I
        lib.pt_rng_fold.argtypes = [_P, _P, _I, _P, _L, _P, _P, _I, _P]
        lib.pt_rng_fold.restype = _I
        _lib = lib
    return _lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {code}")


def _instance(lib, name: str, x: torch.Tensor):
    """The entry point ``name`` (float32) or ``name + "_f64"`` for the dtype
    of ``x``; raises on any other dtype."""
    if x.dtype == torch.float32:
        return getattr(lib, name)
    if x.dtype == torch.float64:
        return getattr(lib, name + "_f64")
    raise ValueError(f"{name}: no instance for {x.dtype}")


def launch_fused_bounce(tables, busy, bounce, ray_o, ray_d, eta, pdf_prev, prefix, u, out, *,
                        num_tris, num_lights, max_bounces, eps,
                        use_mis, use_nee, has_tri_l, has_sph_l, has_on, has_pbr,
                        raygen=None, fuse_shadow=False, split=None) -> None:
    """``out`` is a ``BounceResult`` of preallocated outputs; the flags are
    ``ops.shade.kernel_flags``; ``raygen`` (``(started, px, py, cam_row)``)
    and ``fuse_shadow`` pick the kernel's instance for those modes;
    ``split``: threads a lane (default :func:`sweep_split`, the fused-shadow
    instance by its own rows a thread)."""
    split, lanes = _shape(tables, split, "fused_bounce_shadow" if fuse_shadow else "fused_bounce")
    fn = _instance(library(), "pt_fused_bounce", ray_o)
    rg = (None,) * 4 if raygen is None else tuple(x.data_ptr() for x in raygen)
    with torch.cuda.device(busy.device):   # launch on the inputs' card
        code = fn(
            busy.data_ptr(), bounce.data_ptr(), ray_o.data_ptr(), ray_d.data_ptr(),
            eta.data_ptr(), pdf_prev.data_ptr(), prefix.data_ptr(), u.data_ptr(), *rg,
            tables.sph.data_ptr(), tables.sph.shape[0],
            tables.tri.data_ptr(), tables.tri.shape[0],
            tables.lgt.data_ptr(), tables.lgt.shape[0],
            out.rad_delta.data_ptr(), out.next_o.data_ptr(), out.next_d.data_ptr(),
            out.next_eta.data_ptr(), out.next_pdf.data_ptr(), out.next_prefix.data_ptr(),
            out.live.data_ptr(), out.shade.data_ptr(), out.nee_gain.data_ptr(),
            out.shadow_d.data_ptr(), out.shadow_tmax.data_ptr(),
            busy.shape[0], num_tris, num_lights, max_bounces,
            int(use_mis), int(use_nee), int(has_tri_l), int(has_sph_l), int(has_on),
            int(has_pbr), int(raygen is not None), int(bool(fuse_shadow)), eps, split, lanes,
            _stream(busy.device),
        )
    _raise_on(code, "fused_bounce")


def launch_shadow_any_hit(tables, o, d, t_max, occ, *, eps, split=None) -> None:
    split, lanes = _shape(tables, split, "shadow_any_hit")
    fn = _instance(library(), "pt_shadow_any_hit", t_max)
    with torch.cuda.device(t_max.device):
        code = fn(
            tables.sph.data_ptr(), tables.sph.shape[0],
            tables.tri.data_ptr(), tables.tri.shape[0],
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), occ.data_ptr(),
            t_max.shape[0], eps, split, lanes, _stream(t_max.device),
        )
    _raise_on(code, "shadow_any_hit")


def _boxes(box) -> tuple:
    """Pointer and row count of an optional cluster box table (none: 0, 0)."""
    return (None, 0) if box is None or box.shape[0] == 0 else (box.data_ptr(), box.shape[0])


def _team(team, default, *tables) -> int:
    """``team`` (None: ``default``); raises on a team size the kernels lack,
    or on a row table the float4 row loads cannot read."""
    team = default if team is None else team
    if team not in TEAMS:
        raise ValueError(f"team {team} not in {TEAMS}")
    for name, tab in tables:
        if tab.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return team


def launch_sphere_closest(sph, o, d, t_min, t_max, t, idx, n, m, box=None, team=None) -> None:
    """``box``: ``Tables.sph_box`` for the clustered mode, else one tile;
    ``team``: threads a ray (default :func:`cluster_team`)."""
    team = _team(team, cluster_team("sphere_closest", (sph, box)), ("sph", sph))
    fn = _instance(library(), "pt_sphere_closest", t_min)
    with torch.cuda.device(t_min.device):
        code = fn(
            sph.data_ptr(), sph.shape[0], *_boxes(box), team, o.data_ptr(), d.data_ptr(),
            t_min.data_ptr(), t_max.data_ptr(), t.data_ptr(), idx.data_ptr(),
            n.data_ptr(), m.data_ptr(), t_min.shape[0], _stream(t_min.device),
        )
    _raise_on(code, "sphere_closest")


def launch_any_hit(sph, tri, o, d, t_min, t_max, occ, sph_box=None, tri_box=None,
                   team=None) -> None:
    """``sph_box``/``tri_box``: cluster boxes of 256 rows each, or one tile;
    ``team``: threads a ray (default :func:`cluster_team`)."""
    team = _team(team, cluster_team("any_hit", (sph, sph_box), (tri, tri_box)),
                 ("sph", sph), ("tri", tri))
    fn = _instance(library(), "pt_any_hit", t_min)
    with torch.cuda.device(t_min.device):
        code = fn(
            sph.data_ptr(), sph.shape[0], *_boxes(sph_box), tri.data_ptr(), tri.shape[0],
            *_boxes(tri_box), team,
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            occ.data_ptr(), t_min.shape[0], _stream(t_min.device),
        )
    _raise_on(code, "any_hit")


def _host_team(tables, team, kernel: str, teams: dict, teams_f64: dict) -> int:
    """``team``, or (None) the host's team for ``kernel``: ``teams``, for
    float64 tables ``teams_f64`` where it has the kernel; raises on a team
    size the kernels lack, or on a table the row loads cannot read."""
    default = teams[kernel]
    if tables.tri.dtype == torch.float64:
        default = teams_f64.get(kernel, default)
    return _team(team, default, ("tables.tri", tables.tri))


def _bvh_team(tables, team, kernel: str) -> int:
    """Team size of a ``csrc/bvh.cu`` launch (None: :data:`BVH_TEAM` and
    :data:`BVH_TEAM_F64`)."""
    return _host_team(tables, team, kernel, BVH_TEAM, BVH_TEAM_F64)


def _binned_team(tables, team, kernel: str) -> int:
    """Team size of a ``csrc/binned.cu`` launch (None: :data:`BINNED_TEAM`
    and :data:`BINNED_TEAM_F64`)."""
    return _host_team(tables, team, kernel, BINNED_TEAM, BINNED_TEAM_F64)


def _counts(counts) -> tuple:
    """Pointers of the optional per-ray ``(groups visited, leaves swept)``
    int32 outputs (none: null, the kernel without counters)."""
    return (None, None) if counts is None else tuple(c.data_ptr() for c in counts)


def launch_bvh_closest(tables, o, d, t_min, t_max, t, idx, n, m, counts=None,
                       team=None) -> None:
    """``tables`` is an ``ops.intersect.Tables``; ``counts``: two int32
    ``(N,)`` outputs for the per-ray groups visited and leaves swept, or
    None; ``team``: threads a ray (default :func:`_bvh_team`)."""
    team = _bvh_team(tables, team, "bvh_closest")
    fn = _instance(library(), "pt_bvh_closest", t_min)
    with torch.cuda.device(t_min.device):
        code = fn(
            tables.tri.data_ptr(), tables.leaf.data_ptr(), tables.group.data_ptr(),
            tables.n_groups, team, o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
            t_max.data_ptr(), t.data_ptr(), idx.data_ptr(), n.data_ptr(), m.data_ptr(),
            *_counts(counts), t_min.shape[0], _stream(t_min.device),
        )
    _raise_on(code, "bvh_closest")


def launch_bvh_anyhit(tables, o, d, t_min, t_max, occ, counts=None, team=None) -> None:
    """As :func:`launch_bvh_closest`; the counts stop at the leaf of the
    first hit."""
    team = _bvh_team(tables, team, "bvh_anyhit")
    fn = _instance(library(), "pt_bvh_anyhit", t_min)
    with torch.cuda.device(t_min.device):
        code = fn(
            tables.tri.data_ptr(), tables.leaf.data_ptr(), tables.group.data_ptr(),
            tables.n_groups, team, o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
            t_max.data_ptr(), occ.data_ptr(), *_counts(counts), t_min.shape[0],
            _stream(t_min.device),
        )
    _raise_on(code, "bvh_anyhit")


def launch_combined_closest_small(tables, o, d, t_min, t_max, t, prim, n, m,
                                  team=None) -> None:
    """``tables`` is an ``ops.intersect.Tables`` of the small route; ``team``:
    threads a ray (default :func:`small_team`)."""
    team = _team(team, small_team(tables), ("tables.tri", tables.tri),
                 ("tables.sph", tables.sph))
    fn = _instance(library(), "pt_combined_closest_small", t_min)
    with torch.cuda.device(t_min.device):
        code = fn(
            tables.sph.data_ptr(), tables.sph.shape[0], tables.tri.data_ptr(),
            tables.tri.shape[0], tables.tri_rows, team, o.data_ptr(), d.data_ptr(),
            t_min.data_ptr(), t_max.data_ptr(), t.data_ptr(), prim.data_ptr(), n.data_ptr(),
            m.data_ptr(), t_min.shape[0], _stream(t_min.device),
        )
    _raise_on(code, "combined_closest_small")


def launch_triangle_closest(tables, o, d, t_min, t_max, t, idx, n, m, team=None) -> None:
    """``tables`` is an ``ops.intersect.Tables`` of the flat route; the sweep
    stops at its ``tri_rows`` real rows; ``team``: threads a ray (default
    :func:`flat_team`)."""
    team = _team(team, flat_team(tables), ("tables.tri", tables.tri))
    fn = _instance(library(), "pt_triangle_closest", t_min)
    with torch.cuda.device(t_min.device):
        code = fn(
            tables.tri.data_ptr(), tables.leaf.data_ptr(), tables.leaf.shape[0],
            tables.tri_rows, team, o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
            t_max.data_ptr(), t.data_ptr(), idx.data_ptr(), n.data_ptr(), m.data_ptr(),
            t_min.shape[0], _stream(t_min.device),
        )
    _raise_on(code, "triangle_closest")


def launch_binned_round_closest(tables, o, d, t_min, t_up, key, t, idx, n, m,
                                team=None) -> None:
    """``tables`` is an ``ops.intersect.Tables`` of the binned route; the
    wave is sorted by ``key``; ``team``: threads a ray (default
    :func:`_binned_team`)."""
    team = _binned_team(tables, team, "binned_round_closest")
    fn = _instance(library(), "pt_binned_round_closest", t_min)
    with torch.cuda.device(t_min.device):
        code = fn(
            tables.tri.data_ptr(), tables.leaf.shape[0], team, o.data_ptr(), d.data_ptr(),
            t_min.data_ptr(), t_up.data_ptr(), key.data_ptr(), t.data_ptr(), idx.data_ptr(),
            n.data_ptr(), m.data_ptr(), t_min.shape[0], _stream(t_min.device),
        )
    _raise_on(code, "binned_round_closest")


def launch_binned_round_anyhit(tables, o, d, t_min, t_max, key, occ, team=None) -> None:
    team = _binned_team(tables, team, "binned_round_anyhit")
    fn = _instance(library(), "pt_binned_round_anyhit", t_min)
    with torch.cuda.device(t_min.device):
        code = fn(
            tables.tri.data_ptr(), tables.leaf.shape[0], team, o.data_ptr(), d.data_ptr(),
            t_min.data_ptr(), t_max.data_ptr(), key.data_ptr(), occ.data_ptr(),
            t_min.shape[0], _stream(t_min.device),
        )
    _raise_on(code, "binned_round_anyhit")


def resident_cached(n_boxes: int, team: int, itemsize: int = 4) -> bool:
    """Do the cluster entries of a block's rays fit in shared memory (the
    closest kernel's cached mode, ``csrc/resident.cu``)? 128 threads a
    block, ``ceil(n_boxes / team)`` entries each of ``itemsize`` bytes (4:
    float32, 8: float64), at most :data:`SHARED_LIMIT`: at K = 16, up to
    1,536 clusters in float32, 768 in float64."""
    return 128 * (-(-n_boxes // team)) * itemsize <= SHARED_LIMIT


def launch_resident_closest(tables, o, d, t_min, t_max, t, idx, n, m, team=None,
                            cached=None) -> None:
    """``tables`` is an ``ops.intersect.Tables`` of the resident route;
    ``team``: threads a ray (default :data:`RESIDENT_TEAM`); ``cached``: keep
    each ray's cluster entries in shared memory (default: where they fit,
    :func:`resident_cached`; raises where they do not)."""
    team = _team(team, RESIDENT_TEAM["resident_closest"], ("tables.tri", tables.tri))
    n_boxes = tables.leaf.shape[0]
    fits = resident_cached(n_boxes, team, tables.leaf.element_size())
    cached = fits if cached is None else bool(cached)
    if cached and not fits:
        raise ValueError(f"the entries of {n_boxes} clusters at team {team} do not fit in "
                         f"{SHARED_LIMIT} bytes of shared memory")
    fn = _instance(library(), "pt_resident_closest", t_min)
    with torch.cuda.device(t_min.device):
        code = fn(
            tables.tri.data_ptr(), tables.leaf.data_ptr(), n_boxes, team, int(cached),
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), t.data_ptr(),
            idx.data_ptr(), n.data_ptr(), m.data_ptr(), t_min.shape[0], _stream(t_min.device),
        )
    _raise_on(code, "resident_closest")


def launch_resident_anyhit(tables, o, d, t_min, t_max, occ, team=None) -> None:
    """As :func:`launch_resident_closest`; the any hit walks the clusters in
    id order and caches nothing."""
    team = _team(team, RESIDENT_TEAM["resident_anyhit"], ("tables.tri", tables.tri))
    fn = _instance(library(), "pt_resident_anyhit", t_min)
    with torch.cuda.device(t_min.device):
        code = fn(
            tables.tri.data_ptr(), tables.leaf.data_ptr(), tables.leaf.shape[0], team,
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), occ.data_ptr(),
            t_min.shape[0], _stream(t_min.device),
        )
    _raise_on(code, "resident_anyhit")


def launch_rng_pool_uniforms(key, pixel, sample, bounce, u) -> None:
    """``u`` ``(9, S)`` float32 or float64 <- the draw of every lane under
    the base ``key`` (two int64 words on the card), ``pixel``/``sample``
    int64 ``(S,)`` and ``bounce`` int32 ``(S,)``; checked by
    ``utils/rng.py :: pool_uniforms``."""
    fn = _instance(library(), "pt_rng_pool_uniforms", u)
    with torch.cuda.device(u.device):
        code = fn(key[0].data_ptr(), key[1].data_ptr(), pixel.data_ptr(), sample.data_ptr(),
                  bounce.data_ptr(), u.data_ptr(), u.shape[1], _stream(u.device))
    _raise_on(code, "rng_pool_uniforms")


def launch_rng_bounce_uniforms(keys, bounce: int, u) -> None:
    """``u`` ``(9, N)`` float32 or float64 <- the draw of ``bounce`` under
    the per-lane ``keys`` (two int64 ``(N,)`` words)."""
    fn = _instance(library(), "pt_rng_bounce_uniforms", u)
    with torch.cuda.device(u.device):
        code = fn(keys[0].data_ptr(), keys[1].data_ptr(), bounce, u.data_ptr(), u.shape[1],
                  _stream(u.device))
    _raise_on(code, "rng_bounce_uniforms")


def launch_rng_fold(key, key_stride: int, data0, value0: int, data1, out) -> None:
    """``out`` int64 ``(2, N)`` <- ``key`` (two int64 words, one for every
    lane at ``key_stride`` 0, a word a lane at 1) folded with ``data0`` (int64
    ``(N,)``; None: ``value0`` for every lane), then with ``data1`` (None:
    no second fold)."""
    lib = library()
    with torch.cuda.device(out.device):
        code = lib.pt_rng_fold(
            key[0].data_ptr(), key[1].data_ptr(), key_stride,
            None if data0 is None else data0.data_ptr(), value0,
            None if data1 is None else data1.data_ptr(), out.data_ptr(), out.shape[1],
            _stream(out.device))
    _raise_on(code, "rng_fold")
