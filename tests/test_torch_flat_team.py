"""The flat and small closest-hit kernels' teams (``csrc/triangle_closest.cu``,
``csrc/combined_closest_small.cu``), held on the CPU.

``triangle_closest`` walks each ray's entered 256-row clusters in ascending
(entry, id) order under an ``entry <= min(best_t, t_max)`` gate, a team of k
threads a ray splitting each cluster's sweep, which stops at the table's
real rows (``Tables.tri_rows``); ``combined_closest_small`` splits each ray's
triangle sweep over its team, combines it, caps the sphere sweep at the
triangle's t and splits that too. A CUDA kernel cannot run here, so:

* both are modelled at k = 1-32 on a 32-lane warp (``tests/teamutil.py``:
  ``team_successor``, ``team_sweep``, ``warp_group_min``) and held
  **exactly** against their twins, ``triangle_closest_reference`` (on
  ``mesh_scene(2000)`` lanes aimed at its clusters, the sphere field's 2
  triangles beside its clustered spheres, edge lanes with ``t_max`` NaN,
  -1, 0, ``t_min`` and inf, and the cross-cluster tie of
  ``chip_smoke.tie_tables`` on flat tables) and
  ``combined_closest_small_reference`` (Cornell and many_spheres lanes, edge
  lanes, and ``chip_smoke.small_tie_tables``: a triangle/sphere equal t the
  triangle wins, and equal t in two triangles or two spheres);
* both models against the JAX ``triangle_closest``/``combined_closest_small``
  in interpret mode, with the tolerances of
  ``tests/test_torch_intersect.py :: test_route_twins_match_jax_interpret``:
  rows and prim ids equal but for 2 rays in 1,000 on the flat route (the
  JAX kernel keeps the first cluster's row on an equal-t tie across
  clusters; measured: none on these lanes), triangle t within 32 ulps
  (measured: 11 on ``mesh_scene(2000)``, 0 elsewhere), sphere t to rtol 1e-4 / atol 1e-4 (XLA contracts
  multiply-adds in the interpreted kernel, and the ``|o|^2 - 2 o.c + k``
  sum cancels near the origin of a ray: measured 2.3e-5 absolute at
  t = 0.032 on many_spheres); on the tie case the JAX kernel returns the
  higher row, the model the lower;
* the host's team rules (``kernels/binding.py :: flat_team``,
  ``small_team``) and the launchers' arguments (``n_rows``, ``team``)
  through a mock of the kernel library against the C signatures.
"""

import contextlib
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.models import scenes as jax_scenes  # noqa: E402
from pathtrace_tpu.ops import pallas_intersect as jax_pi  # noqa: E402
from pathtrace_tpu_torch.convert import scene_from_arrays, split_fields  # noqa: E402
from pathtrace_tpu_torch.kernels import binding  # noqa: E402
from pathtrace_tpu_torch.ops import intersect, shade  # noqa: E402
from pathtrace_tpu_torch.ops.binned import cluster_entries  # noqa: E402

from .teamutil import NONE, team_successor, team_sweep  # noqa: E402
from .test_torch_binned_team import _Lib  # noqa: E402

INF = float("inf")
TEAMS = (1, 2, 4, 8, 16, 32)
CLUSTER = 256
N = 96
EDGE = (math.nan, -1.0, 0.0, shade.EPS, INF)      # t_max of the first lanes
SCENES = {
    "mesh_2000": lambda: jax_scenes.mesh_scene(2000),
    "field": lambda: jax_scenes.many_spheres(n_per_side=12),
    "cornell": jax_scenes.cornell_box,
    "many_spheres": jax_scenes.many_spheres,
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    jsc = SCENES[request.param]()
    tables = intersect.build_tables(scene_from_arrays(*split_fields(jsc), device="cpu"))
    return request.param, jsc, tables


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _lanes(jsc, tables, n, seed):
    """``n`` rays made with numpy: half from points 3 to 6 away aimed at
    points inside the triangles' cluster boxes (the whole scene's bounds on
    the small route), half from random points inside those bounds in random
    directions; unit directions. ``t_min`` is the pool's epsilon, ``t_max``
    inf but on the first lanes (:data:`EDGE`); on the flat route ``t_max`` is
    capped by the sphere hits, as ``intersect`` caps it."""
    g = np.random.default_rng(seed)
    lo = np.asarray(jsc.tri_cluster_min).min(0)
    hi = np.asarray(jsc.tri_cluster_max).max(0)
    lo, hi = np.maximum(lo, -6.0), np.maximum(np.minimum(hi, 6.0), lo + 1.0)
    if tables.route == "flat":           # inside the object's clusters, not the floor's
        boxes = tables.leaf[:, 0:6].numpy()
        size = boxes[:, 3:6] - boxes[:, 0:3]
        boxes = boxes[(size >= 0).all(1) & ((size < 10.0).all(1) | (tables.tri_rows < 8))]
        pick = boxes[g.integers(0, boxes.shape[0], n)]
        aim = pick[:, 0:3] + g.random((n, 3)) * (pick[:, 3:6] - pick[:, 0:3])
    else:
        aim = g.uniform(lo, hi, (n, 3))
    v = g.normal(size=(n, 3))
    o = aim + v / np.linalg.norm(v, axis=1, keepdims=True) * g.uniform(3, 6, (n, 1))
    d = aim - o
    half = n // 2
    o[half:] = g.uniform(lo, hi, (n - half, 3))
    d[half:] = g.normal(size=(n - half, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = _t(o), _t(d)
    t_min = torch.full((n,), shade.EPS)
    t_max = torch.full((n,), INF)
    t_max[:len(EDGE)] = torch.tensor(EDGE)
    if tables.route == "flat":
        t_max = torch.minimum(t_max, intersect.sphere_closest_reference(
            tables.sph, o, d, t_min, t_max)[0])
    return o, d, t_min, t_max


def _clamp_max(x, hi):
    """``csrc/geom.cuh :: clamp_max``: NaN ``x`` stays NaN."""
    return hi if x > hi else x


# ---- The models ----

def _team_flat(tables, o, d, lo, hi, k):
    """``triangle_closest``'s walk for the 32 / k teams of each warp: the team
    successor scan over each ray's cluster entries, the ``<=`` gate, the
    split sweep of each cluster's real rows (up to ``tri_rows``) under the
    bound and the lexicographic combine. Returns per ray ``(t, row)`` (row
    NONE on a miss) and the rows each ray's team tested."""
    n = o.shape[0]
    entries = cluster_entries(o, d, lo, hi, tables.leaf).tolist()
    got, tested = [], [0] * n
    for first in range(0, n, 32 // k):                   # each warp holds 32 / k teams
        rays = [first + m for m in range(32 // k)]
        best = [(INF, NONE)] * len(rays)
        last = [(-INF, -1)] * len(rays)
        live = [r < n for r in rays]                     # teams past the end: no ray
        while any(live):
            nxt = team_successor([entries[r] if r < n else [] for r in rays], last, k)
            ts_lanes = []
            for m, r in enumerate(rays):
                e, c = nxt[m * k]
                assert all(x == (e, c) for x in nxt[m * k:(m + 1) * k])   # the team agrees
                bound = _clamp_max(float(hi[r]), best[m][0]) if live[m] else INF
                live[m] = live[m] and c != NONE and e <= bound
                last[m] = (e, c)
                if not live[m]:
                    ts_lanes.append([])
                    continue
                rows = tables.tri[c * CLUSTER:min((c + 1) * CLUSTER, tables.tri_rows)]
                tested[r] += rows.shape[0]
                ts_lanes.append(intersect._tri_ts(rows, o[r:r + 1], d[r:r + 1], lo[r],
                                                  bound)[:, 0].tolist())
            res = team_sweep(ts_lanes, 0, k)
            for m in range(len(rays)):
                if live[m]:
                    lt, lr = res[m * k]
                    lr = lr + last[m][1] * CLUSTER if lr != NONE else NONE
                    if lt < best[m][0] or (lt == best[m][0] and lr < best[m][1]):
                        best[m] = (lt, lr)
        got += best[:n - first]
    return got, tested


def _team_small(tables, o, d, lo, hi, k):
    """``combined_closest_small``'s split for the 32 / k teams of each warp:
    the team sweep of the triangle rows, combined; every thread caps its
    sphere rows at ``min(t_max, tri_t)``, the team sweep, combined; the
    sphere wins only when strictly nearer. Returns per ray ``(t, global prim
    id)`` (-1 on a miss)."""
    n = o.shape[0]
    tri_ts = intersect._tri_ts(tables.tri, o, d, lo, hi).T.tolist()
    tri = []
    for first in range(0, n, 32 // k):
        lanes = [tri_ts[r] if r < n else [] for r in range(first, first + 32 // k)]
        res = team_sweep(lanes, 0, k)
        for m in range(len(lanes)):
            assert all(x == res[m * k] for x in res[m * k:(m + 1) * k])     # the team agrees
        tri += res[::k][:n - first]
    cap = torch.tensor([_clamp_max(float(h), t) for h, (t, _) in zip(hi, tri)])
    sph_ts = intersect._sph_ts(tables.sph, o, d, lo, cap).T.tolist()
    got = []
    for first in range(0, n, 32 // k):
        lanes = [sph_ts[r] if r < n else [] for r in range(first, first + 32 // k)]
        res = team_sweep(lanes, 0, k)
        for m, (st, sr) in enumerate(res[::k][:n - first]):
            tt, tr = tri[first + m]
            if st < tt:
                got.append((st, tables.tri_rows + sr))
            else:
                got.append((tt, tr if tr != NONE else -1))
    return got


def _pairs(t, row, miss=NONE):
    return [(float(a), int(b)) if b >= 0 else (INF, miss) for a, b in zip(t, row)]


# ---- The models against the twins ----

@pytest.mark.parametrize("k", TEAMS)
def test_team_models_are_the_twins_first_minimum(scene, k):
    """Each model gives its twin's (t, row) on every lane, edge lanes
    included; the flat walk tests no row past the table's real rows and,
    on hit lanes, sweeps the cluster that holds the hit."""
    name, jsc, tables = scene
    o, d, lo, hi = _lanes(jsc, tables, N, seed=k)
    if tables.route == "flat":
        ref_t, ref_i, *_ = intersect.triangle_closest_reference(tables, o, d, lo, hi)
        assert (ref_i >= 0).float().mean() > (0.05 if name == "field" else 0.3)
        got, tested = _team_flat(tables, o, d, lo, hi, k)
        assert got == _pairs(ref_t, ref_i)
        assert not any(tested[:3])                       # NaN, -1, 0: the gate stops the walk
        per_cluster = [min(CLUSTER, tables.tri_rows - c * CLUSTER)
                       for c in range(tables.leaf.shape[0])]
        assert all(t <= sum(per_cluster) for t in tested)
        hit = ref_i >= 0
        assert all(tested[r] >= per_cluster[int(ref_i[r]) // CLUSTER]
                   for r in range(N) if hit[r])
        if name == "field":                              # 2 real rows in one cluster
            assert tables.tri_rows == 2 and set(tested) <= {0, 2}
    else:
        ref_t, ref_p, *_ = intersect.combined_closest_small_reference(tables, o, d, lo, hi)
        assert (ref_p >= 0).float().mean() > 0.3
        assert (ref_p >= tables.tri_rows).any() and ((ref_p >= 0) & (ref_p < tables.tri_rows)).any()
        assert _team_small(tables, o, d, lo, hi, k) == _pairs(ref_t, ref_p, -1)


@pytest.mark.parametrize("k", TEAMS)
@pytest.mark.parametrize("upper", [1, 7], ids=["next_cluster", "cluster_7"])
def test_flat_cross_cluster_tie_goes_to_row_0(upper, k):
    """Equal t in two clusters, the higher-row cluster entered first (and cut
    to two real rows): the twin and the walk give row 0."""
    tables, b = chip_smoke.tie_tables("cpu", upper, route="flat")
    assert tables.route == "flat" and tables.tri_rows == b + 2
    o, d, lo, hi, _ = chip_smoke.tie_rays("cpu")
    e = cluster_entries(o, d, lo, hi, tables.leaf)
    assert (e[:, upper] == 4.0).all() and (e[:, 0] == 5.0).all()     # B's cluster first
    want = intersect.triangle_closest_reference(tables, o, d, lo, hi)
    assert (want[0] == 5.0).all() and (want[1] == 0).all()
    got, tested = _team_flat(tables, o, d, lo, hi, k)
    assert got == [(5.0, 0)] * o.shape[0]
    assert tested == [CLUSTER + 2] * o.shape[0]            # both clusters, 2 rows of B's


@pytest.mark.parametrize("k", TEAMS)
def test_small_ties_go_to_the_triangle_and_the_lower_row(k):
    tables, want = chip_smoke.small_tie_tables("cpu")
    m = len(chip_smoke.SMALL_TIE_RAYS)
    o = torch.tensor([[x, y, 5.0] for x, y in chip_smoke.SMALL_TIE_RAYS])
    d = torch.tensor([[0.0, 0.0, -1.0]] * m)
    lo, hi = torch.full((m,), shade.EPS), torch.full((m,), INF)
    ref_t, ref_p, *_ = intersect.combined_closest_small_reference(tables, o, d, lo, hi)
    assert [int(p) for p in ref_p] == [p for _, p in want]
    assert all(t is None or float(r) == t for (t, _), r in zip(want, ref_t))
    ts = intersect._sph_ts(tables.sph, o, d, lo, hi)
    assert (ts[[3, 12, 25, 33], range(4)] == 5.0).all()     # the spheres tie the triangle
    assert _team_small(tables, o, d, lo, hi, k) == _pairs(ref_t, ref_p, -1)


# ---- The models against the JAX kernels in interpret mode ----

def test_models_match_jax_interpret(scene):
    name, jsc, tables = scene
    o, d, lo, hi = _lanes(jsc, tables, 512, seed=40)
    lo, hi = lo[len(EDGE):], hi[len(EDGE):]                # the JAX kernels take t_max >= 0
    o, d = o[len(EDGE):], d[len(EDGE):]
    args = [jnp.asarray(x.numpy()) for x in (o, d, lo, hi)]
    k = binding.flat_team(tables) if tables.route == "flat" else binding.small_team(tables)
    if tables.route == "flat":
        want = jax_pi.triangle_closest(*args, jsc.tri_v0, jsc.tri_e1, jsc.tri_e2,
                                       jsc.tri_normal, jsc.tri_mat, jsc.tri_cluster_min,
                                       jsc.tri_cluster_max, interpret=True, ray_tile=256)
        got, _ = _team_flat(tables, o, d, lo, hi, k)
    else:
        want = jax_pi.combined_closest_small(*args, jsc.sph_center, jsc.sph_radius, jsc.sph_mat,
                                             jsc.tri_v0, jsc.tri_e1, jsc.tri_e2, jsc.tri_normal,
                                             jsc.tri_mat, tables.tri_rows, interpret=True,
                                             ray_tile=256)
        got = _team_small(tables, o, d, lo, hi, k)
    row = np.array([r if r not in (NONE, -1) else -1 for _, r in got])
    t = np.array([x for x, _ in got], dtype=np.float32)
    wrow, wt = np.asarray(want[1]), np.asarray(want[0])
    same = row == wrow
    assert (~same).sum() <= (1 if tables.route == "flat" else 0), np.nonzero(~same)
    hit = same & (row >= 0)
    assert hit.mean() > (0.05 if name == "field" else 0.3)
    tri = hit & (row < tables.tri_rows)
    sph = hit & (row >= tables.tri_rows)
    assert tri.any()
    ulps = np.abs(t[tri].view(np.int32).astype(np.int64) - wt[tri].view(np.int32).astype(np.int64))
    assert ulps.max() <= 32
    np.testing.assert_allclose(t[sph], wt[sph], rtol=1e-4, atol=1e-4)
    assert np.isinf(wt[row < 0]).all()


def test_jax_flat_kernel_keeps_the_first_clusters_row_on_the_tie():
    """What the JAX kernel returns on the cross-cluster tie: B, the row of
    the cluster it entered first (the port, the twin and the model: row 0)."""
    tables, b = chip_smoke.tie_tables("cpu", 1, route="flat")
    o, d, lo, hi, _ = chip_smoke.tie_rays("cpu")
    rows = tables.tri[:tables.tri_rows]
    box = tables.leaf
    got = jax_pi.triangle_closest(*(jnp.asarray(x.numpy()) for x in (o, d, lo, hi)),
                                  *(jnp.asarray(rows[:, c:c + 3].numpy()) for c in (0, 3, 6)),
                                  jnp.asarray(rows[:, 9:12].numpy()),
                                  jnp.asarray(rows[:, 12].numpy().astype(np.int32)),
                                  jnp.asarray(box[:, 0:3].numpy()), jnp.asarray(box[:, 3:6].numpy()),
                                  interpret=True, ray_tile=128)
    np.testing.assert_array_equal(np.asarray(got[0]), 5.0)
    np.testing.assert_array_equal(np.asarray(got[1]), b)
    assert _team_flat(tables, o, d, lo, hi, 1)[0] == [(5.0, 0)] * o.shape[0]


# ---- The host ----

def test_host_teams(scene):
    """The flat team follows the longest cluster's real rows, ``min(tri_rows,
    256)``, not the padded table: one thread on the field's 2 rows; the small
    team follows the tables' triangle and sphere rows."""
    name, _, tables = scene
    assert binding.TEAMS == TEAMS
    if tables.route == "flat":
        rows = min(tables.tri_rows, CLUSTER)
        assert binding.flat_team(tables) == binding.sweep_split(rows, "triangle_closest", TEAMS)
        assert binding.flat_team(tables) in TEAMS
        if name == "field":
            assert tables.tri.shape[0] == CLUSTER and binding.flat_team(tables) == 1
        assert binding.flat_team(tables._replace(tri_rows=2)) == 1
    else:
        rows = tables.tri.shape[0] + tables.sph.shape[0]
        assert binding.small_team(tables) == binding.sweep_split(rows, "combined_closest_small",
                                                                 TEAMS)
        assert binding.small_team(tables) in TEAMS


def _c_params(src, name):
    """ctypes types of the parameters of ``extern "C" int name(...)`` in
    ``csrc/<src>``: ``int`` as ``c_int``, pointers as ``c_void_p``."""
    text = (Path(binding.__file__).parent.parent / "csrc" / src).read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)[1].split(",")
    return [binding._P if "*" in p else binding._I for p in params]


def test_launchers_pass_the_rows_and_team_to_the_kernels(scene, monkeypatch):
    """The launchers, through a mock kernel library: the argument types the
    binding declares match the C signatures, the arguments match them in
    number, ``triangle_closest`` gets the table's real rows and ``team``
    (None: the host's rule) reaches the entry points; a team the kernels
    lack or a misaligned table raises before a launch."""
    name, _, tables = scene
    lib = _Lib()
    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding.build, "build", lambda: ("mock.so", 0.0))
    monkeypatch.setattr(binding.ctypes, "CDLL", lambda path: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(binding, "_stream", lambda dev: 0)
    n = 40
    o, d = torch.zeros((n, 3)), torch.zeros((n, 3))
    lo, hi = torch.zeros(n), torch.ones(n)
    out = (torch.empty(n), torch.empty(n, dtype=torch.int32), torch.empty((n, 3)),
           torch.empty(n, dtype=torch.int32))
    flat = tables.route == "flat"
    kernel = "triangle_closest" if flat else "combined_closest_small"
    src = kernel + ".cu"
    launch = getattr(binding, "launch_" + kernel)
    host = binding.flat_team(tables) if flat else binding.small_team(tables)
    for team in (None,) + TEAMS:
        launch(tables, o, d, lo, hi, *out, team=team)
    entry = lib.fns["pt_" + kernel]
    assert entry.argtypes == _c_params(src, "pt_" + kernel)
    assert len(entry.calls) == 1 + len(TEAMS)
    assert all(len(args) == len(entry.argtypes) for args in entry.calls)
    assert all(args[-2] == n and args[-3] == out[3].data_ptr() for args in entry.calls)
    if flat:
        assert {args[:4] for args in entry.calls} == {
            (tables.tri.data_ptr(), tables.leaf.data_ptr(), tables.leaf.shape[0],
             tables.tri_rows)}
        assert [args[4] for args in entry.calls] == [host, *TEAMS]
        assert entry.calls[0][5] == o.data_ptr()
    else:
        assert {args[:5] for args in entry.calls} == {
            (tables.sph.data_ptr(), tables.sph.shape[0], tables.tri.data_ptr(),
             tables.tri.shape[0], tables.tri_rows)}
        assert [args[5] for args in entry.calls] == [host, *TEAMS]
    with pytest.raises(ValueError, match="team"):
        launch(tables, o, d, lo, hi, *out, team=3)
    shifted = tables._replace(tri=tables.tri.view(-1)[1:1 + tables.tri.numel() - 16]
                              .view(-1, 16))
    with pytest.raises(ValueError, match="aligned"):
        launch(shifted, o, d, lo, hi, *out)
    assert len(entry.calls) == 1 + len(TEAMS)


def test_wrappers_run_the_twins_on_the_cpu(scene):
    """``triangle_closest``/``combined_closest_small`` on CPU tensors: the
    twins, no launch; equal to the host team's model."""
    _, jsc, tables = scene
    o, d, lo, hi = _lanes(jsc, tables, 64, seed=5)
    shade.LAUNCHES.clear()
    if tables.route == "flat":
        got = intersect.triangle_closest(tables, o, d, lo, hi)
        model, _ = _team_flat(tables, o, d, lo, hi, binding.flat_team(tables))
        ref = intersect.triangle_closest_reference(tables, o, d, lo, hi)
        assert model == _pairs(got[0], got[1])
    else:
        got = intersect.combined_closest_small(tables, o, d, lo, hi)
        model = _team_small(tables, o, d, lo, hi, binding.small_team(tables))
        ref = intersect.combined_closest_small_reference(tables, o, d, lo, hi)
        assert model == _pairs(got[0], got[1], -1)
    assert not shade.LAUNCHES
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
