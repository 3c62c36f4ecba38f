"""The resident pair's team walk (``csrc/resident.cu``), held on the CPU.

The closest kernel walks each ray's entered 128-row clusters in ascending
(entry, id) order under an ``entry <= min(best_t, t_max)`` gate, a team of k
threads a ray splitting each cluster's sweep, the entries computed once
(cached in shared memory) or at every scan; the any-hit kernel sweeps the
entered clusters in id order, k boxes a ballot, up to the first hit. A CUDA
kernel cannot run here, so:

* ``intersect.resident_walk_reference`` follows both walks step for step;
  it is held **exactly** against the brute-force twins (t, row, normal,
  material; occlusion) on ``mesh_scene(2500)`` rays with edge ranges, and
  against the JAX ``triangle_closest_resident``/``triangle_anyhit_resident``
  in interpret mode with the tolerances of ``tests/test_torch_traversals.py``
  (prim ids and occlusion agree on >= 99.9% of rays, measured: all; where
  the prim agrees, t to rtol 1e-4 / atol 2e-5, the normal to atol 1e-4: the
  JAX interpreted kernels contract multiply-adds);
* the team's successor scan and split sweep, and the any hit's ballot and
  vote, are modelled at k = 1-32 on a 32-lane warp (``tests/teamutil.py``)
  and held against the twins' first-minimum argmin and ``any``, exactly;
* the cross-cluster tie (``chip_smoke.tie_tables`` on resident tables):
  equal t in two clusters, the higher-row cluster entered first, goes to
  the lower row;
* the host's ``RESIDENT_TEAM`` and cached-entry rule, and the launchers'
  arguments through a mock of the kernel library against the C entry
  points' signatures.
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

from pathtrace_tpu.ops import resident_intersect as jax_rs  # noqa: E402
from pathtrace_tpu_torch.kernels import binding  # noqa: E402
from pathtrace_tpu_torch.ops import intersect, shade  # noqa: E402
from pathtrace_tpu_torch.ops.binned import cluster_entries  # noqa: E402

from .teamutil import NONE, team_in_order, team_successor, team_sweep  # noqa: E402
from .test_torch_binned_team import _Lib  # noqa: E402
from .test_torch_traversals import _rays, _t, mesh2500  # noqa: E402, F401

INF = float("inf")
TEAMS = (1, 2, 4, 8, 16, 32)
CLUSTER = 128
AGREE = 0.999


@pytest.fixture(scope="module")
def resident(mesh2500):
    jsc, tsc = mesh2500
    return jsc, intersect.build_tables(tsc, "resident")


def _same(a, b):
    """Bitwise equality of float tensors, equality else."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _ranges(n):
    return torch.full((n,), shade.EPS), torch.full((n,), INF)


# ---- The model against brute force and against the JAX kernels ----

@pytest.mark.parametrize("seed", [0, 1])
def test_walk_is_the_bruteforce_twin(resident, seed):
    jsc, tables = resident
    n = 1024
    o, d = (_t(a) for a in _rays(jsc, n, seed))
    lo, hi = _ranges(n)
    hi[:5] = torch.tensor([math.nan, -1.0, 0.0, shade.EPS, 2.0])     # edge ranges
    want = intersect.triangle_closest_reference(tables, o, d, lo, hi)
    got = intersect.resident_walk_reference(tables, o, d, lo, hi, chunk=300)
    assert all(_same(a, b) for a, b in zip(want, got[:4]))
    assert (want[1] >= 0).float().mean() > 0.3 and got[1][:3].eq(-1).all()
    visited, tested = got[4:]
    assert not visited[:3].any()                  # NaN, empty and 0: the gate stops the walk
    assert (visited[want[1] >= 0] >= 1).all() and (visited <= tables.leaf.shape[0]).all()
    assert torch.equal(tested, CLUSTER * visited)

    st = torch.tensor(np.random.default_rng(seed).uniform(0.1, 4.0, n), dtype=torch.float32)
    st[:5] = torch.tensor([math.nan, -1.0, 0.0, shade.EPS, INF])
    occ = intersect.bvh_anyhit_reference(tables, o, d, lo, st)
    m_occ, a_visited, a_tested = intersect.resident_walk_reference(tables, o, d, lo, st,
                                                                   anyhit=True, chunk=300)
    assert torch.equal(occ, m_occ) and 0.05 < occ.float().mean() < 0.95
    assert (a_visited[occ] >= 1).all() and not a_visited[:3].any()
    assert torch.equal(a_tested, CLUSTER * a_visited)


def test_walk_matches_jax_resident_kernels(resident):
    """The JAX resident kernels in interpret mode (128-row clusters, one
    256-lane span per 256-ray tile) against the walk on 512 rays."""
    jsc, tables = resident
    n = 512
    o, d = _rays(jsc, n, 7)
    tri = (jsc.tri_v0, jsc.tri_e1, jsc.tri_e2)
    kw = dict(interpret=True, prim_tile=CLUSTER, sub_w=256, ray_tile=256)
    want = jax_rs.triangle_closest_resident(jnp.asarray(o), jnp.asarray(d), shade.EPS, jnp.inf,
                                            *tri, jsc.tri_normal, jsc.tri_mat, **kw)
    lo, hi = _ranges(n)
    got = intersect.resident_walk_reference(tables, _t(o), _t(d), lo, hi)
    row, wrow = got[1].numpy(), np.asarray(want[1])
    same = row == wrow
    assert same.mean() >= AGREE, np.nonzero(~same)
    hit = same & (row >= 0)
    assert hit.mean() > 0.3
    np.testing.assert_allclose(got[0].numpy()[hit], np.asarray(want[0])[hit], rtol=1e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got[2].numpy()[hit], np.asarray(want[2])[hit], atol=1e-4)
    np.testing.assert_array_equal(got[3].numpy()[hit], np.asarray(want[3])[hit])

    t_max = np.random.default_rng(3).uniform(0.1, 4.0, n).astype(np.float32)
    want_occ = np.asarray(jax_rs.triangle_anyhit_resident(
        jnp.asarray(o), jnp.asarray(d), shade.EPS, jnp.asarray(t_max), *tri, **kw))
    got_occ = intersect.resident_walk_reference(tables, _t(o), _t(d), lo, _t(t_max),
                                                anyhit=True)[0].numpy()
    assert (got_occ == want_occ).mean() >= AGREE
    assert 0.05 < want_occ.mean() < 0.95


# ---- The team's successor scan, split sweep and id-order vote ----

def _cluster_rays(tables, n, seed):
    """Rays from points 3 to 6 away aimed at points inside the boxes of the
    mesh object's clusters (not the floor's, the boxes wider than 10), so
    that most hit the object after entering several clusters; made with
    numpy."""
    g = np.random.default_rng(seed)
    boxes = tables.leaf[:, 0:6].numpy()
    size = boxes[:, 3:6] - boxes[:, 0:3]
    boxes = boxes[(size >= 0).all(1) & (size < 10.0).all(1)]         # no padding, no floor
    pick = boxes[g.integers(0, boxes.shape[0], n)]
    aim = pick[:, 0:3] + g.random((n, 3)) * (pick[:, 3:6] - pick[:, 0:3])
    v = g.normal(size=(n, 3))
    o = aim + v / np.linalg.norm(v, axis=1, keepdims=True) * g.uniform(3, 6, (n, 1))
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return _t(o.astype(np.float32)), _t(d.astype(np.float32))


def _team_lanes(tables, seed):
    """64 rays aimed at the mesh object (:func:`_cluster_rays`), and the
    tables with rows 120-127 of each cluster that holds a ray's hit replaced
    by copies of its rows 0-7 (equal t in one cluster; the copies lie in the
    cluster's box)."""
    o, d = _cluster_rays(tables, 64, seed)
    lo, hi = _ranges(64)
    row = intersect.triangle_closest_reference(tables, o, d, lo, hi)[1]
    tri = tables.tri.clone()
    for c in torch.unique(row[row >= 0] // CLUSTER).tolist():
        tri[c * CLUSTER + 120:(c + 1) * CLUSTER] = tri[c * CLUSTER:c * CLUSTER + 8]
    return tables._replace(tri=tri), o, d


def _team_closest(tables, o, d, lo, hi, k):
    """The closest kernel's walk for the 32 / k teams of each warp: the team
    successor scan over each ray's cluster entries, the ``<=`` gate, the
    split sweep of each cluster's screened rows under the bound and the
    lexicographic combine. Returns per ray ``(t, row)`` (row NONE on a
    miss) and the clusters swept."""
    n = o.shape[0]
    entries = cluster_entries(o, d, lo, hi, tables.leaf).tolist()
    got, swept = [], 0
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
                if not live[m]:
                    ts_lanes.append([])
                    continue
                bound = min(float(hi[r]), best[m][0])
                live[m] = live[m] and c != NONE and e <= bound
                last[m] = (e, c)
                rows = tables.tri[c * CLUSTER:(c + 1) * CLUSTER] if live[m] else tables.tri[:0]
                ts_lanes.append(intersect._tri_ts(rows, o[r:r + 1], d[r:r + 1], lo[r],
                                                  bound)[:, 0].tolist())
            res = team_sweep(ts_lanes, 0, k)
            for m in range(len(rays)):
                if not live[m]:
                    continue
                swept += 1
                lt, lr = res[m * k]
                lr = lr + last[m][1] * CLUSTER if lr != NONE else NONE
                if lt < best[m][0] or (lt == best[m][0] and lr < best[m][1]):
                    best[m] = (lt, lr)
        got += best[:n - first]
    return got, swept


@pytest.mark.parametrize("k", TEAMS)
def test_team_walk_is_the_twins_first_minimum(resident, k):
    """The closest kernel's walk gives the twin's (t, row) on every lane, on
    tables with equal-t rows in one cluster."""
    _, tables = resident
    tables, o, d = _team_lanes(tables, seed=k)
    lo, hi = _ranges(o.shape[0])
    ref_t, ref_i, *_ = intersect.triangle_closest_reference(tables, o, d, lo, hi)
    assert (ref_i >= 0).float().mean() > 0.5 and (ref_i % CLUSTER < 8).any()
    ts = intersect._tri_ts(tables.tri, o, d, lo, hi)
    assert (((ts == ref_t) & (ref_i >= 0)).sum(0) > 1).any()           # equal-t rows
    got, swept = _team_closest(tables, o, d, lo, hi, k)
    want = [(float(t), int(i)) if i >= 0 else (INF, NONE) for t, i in zip(ref_t, ref_i)]
    assert got == want
    model = intersect.resident_walk_reference(tables, o, d, lo, hi)
    assert swept == int(model[4].sum()) >= o.shape[0] // 2


@pytest.mark.parametrize("k", TEAMS)
def test_team_in_order_vote_is_the_twins_any(resident, k):
    """The any hit's id-order walk: each team's ballot over k boxes at a
    time, its vote over each entered cluster's rows, gives the twin's
    ``any``, sweeping the clusters the walk model counts, all their rows
    unless the vote stops at a hit."""
    _, tables = resident
    o, d = _cluster_rays(tables, 64, 20 + k)
    lo = torch.full((64,), shade.EPS)
    st = torch.where(torch.arange(64) % 2 == 0, 3.0, 6.0)
    want, visited, _ = intersect.resident_walk_reference(tables, o, d, lo, st, anyhit=True)
    assert want.any() and not want.all()
    entered = cluster_entries(o, d, lo, st, tables.leaf) < INF
    hits = (intersect._tri_ts(tables.tri, o, d, lo, st) < INF).T.reshape(64, -1, CLUSTER)
    for first in range(0, 64, 32 // k):
        rays = range(first, first + 32 // k)
        res = team_in_order([entered[r].tolist() for r in rays], [hits[r].tolist() for r in rays],
                            k)
        for r, (hit, swept, tested) in zip(rays, res):
            assert hit == bool(want[r]) and swept == int(visited[r]), (k, r)
            assert tested <= CLUSTER * swept and (hit or tested == CLUSTER * swept)


# ---- The cross-cluster tie ----

@pytest.mark.parametrize("k", TEAMS)
@pytest.mark.parametrize("upper", [1, 16], ids=["next_cluster", "cluster_16"])
def test_cross_cluster_tie_goes_to_row_0(upper, k):
    tables, b = chip_smoke.tie_tables("cpu", upper, route="resident")
    assert tables.route == "resident" and tables.leaf.shape[0] % 8 == 0
    n = len(chip_smoke.TIE_RAYS)
    o = torch.tensor([[x, y, 5.0] for x, y in chip_smoke.TIE_RAYS])
    d = torch.tensor([[0.0, 0.0, -1.0]] * n)
    lo, hi = _ranges(n)
    e = cluster_entries(o, d, lo, hi, tables.leaf)
    assert (e[:, upper] == 4.0).all() and (e[:, 0] == 5.0).all()     # B's cluster first
    want = intersect.triangle_closest_reference(tables, o, d, lo, hi)
    assert (want[0] == 5.0).all() and (want[1] == 0).all()
    t, row, _, _, visited, tested = intersect.resident_walk_reference(tables, o, d, lo, hi)
    assert torch.equal(t, want[0]) and (row == 0).all()
    assert (visited == 2).all() and (tested == 2 * CLUSTER).all()
    got, swept = _team_closest(tables, o, d, lo, hi, k)
    assert got == [(5.0, 0)] * n and swept == 2 * n
    st = torch.tensor([5.0, 4.5] * (n // 2))                # the hit at t_max, or short
    occ = intersect.resident_walk_reference(tables, o, d, lo, st, anyhit=True)[0]
    assert torch.equal(occ, st == 5.0)
    assert b == upper * CLUSTER


# ---- The host ----

def test_host_resident_team():
    assert set(binding.RESIDENT_TEAM) == {"resident_closest", "resident_anyhit"}
    assert all(v in binding.TEAMS for v in binding.RESIDENT_TEAM.values())
    assert binding.TEAMS == TEAMS
    # config 4's 552 clusters: cached from 8 threads a ray up; 1,536 at 16.
    assert [binding.resident_cached(552, k) for k in TEAMS] == [False] * 3 + [True] * 3
    assert binding.resident_cached(1536, 16) and not binding.resident_cached(1544, 16)
    assert binding.resident_cached(1544, 32)


def _c_params(name):
    """ctypes types of the parameters of ``extern "C" int name(...)`` in
    ``csrc/resident.cu``: ``int`` as ``c_int``, pointers as ``c_void_p``."""
    src = (Path(binding.__file__).parent.parent / "csrc" / "resident.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)[1].split(",")
    return [binding._P if "*" in p else binding._I for p in params]


def test_launchers_pass_the_team_and_mode_to_the_kernels(resident, monkeypatch):
    """The launchers, through a mock kernel library: the argument types the
    binding declares match the C signatures, the arguments match them in
    number, ``team`` (None: ``RESIDENT_TEAM``) and the closest hit's
    ``cached`` (None: where the entries fit) reach the entry points, and a
    team the kernels lack, cached entries that do not fit or a misaligned
    table raise before a launch."""
    _, tables = resident
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
    occ = torch.empty(n, dtype=torch.bool)
    closest = lambda **kw: binding.launch_resident_closest(tables, o, d, lo, hi, *out, **kw)  # noqa: E731
    anyhit = lambda **kw: binding.launch_resident_anyhit(tables, o, d, lo, hi, occ, **kw)  # noqa: E731
    c = tables.leaf.shape[0]
    for team in (None,) + TEAMS:
        closest(team=team)
        closest(team=team, cached=False)
        anyhit(team=team)
    ec, ea = lib.fns["pt_resident_closest"], lib.fns["pt_resident_anyhit"]
    for entry, name in ((ec, "pt_resident_closest"), (ea, "pt_resident_anyhit")):
        assert entry.argtypes == _c_params(name)
        assert all(len(args) == len(entry.argtypes) for args in entry.calls)
        assert {(args[0], args[1], args[2], args[-2]) for args in entry.calls} == \
            {(tables.tri.data_ptr(), tables.leaf.data_ptr(), c, n)}
    host_c, host_a = binding.RESIDENT_TEAM["resident_closest"], binding.RESIDENT_TEAM[
        "resident_anyhit"]
    assert [args[3] for args in ec.calls] == [t for t in (host_c,) + TEAMS for _ in range(2)]
    assert [args[4] for args in ec.calls] == [
        m for t in (host_c,) + TEAMS for m in (int(binding.resident_cached(c, t)), 0)]
    assert [args[3] for args in ea.calls] == [host_a, *TEAMS]
    assert ec.calls[1][5] == o.data_ptr() and ea.calls[0][4] == o.data_ptr()
    big = tables._replace(leaf=tables.leaf.new_zeros((1544, 8)))
    with pytest.raises(ValueError, match="shared memory"):
        binding.launch_resident_closest(big, o, d, lo, hi, *out, team=16, cached=True)
    for fn in (closest, anyhit):
        with pytest.raises(ValueError, match="team"):
            fn(team=3)
    shifted = tables._replace(tri=tables.tri.view(-1)[1:1 + tables.tri.numel() - 16]
                              .view(-1, 16))
    with pytest.raises(ValueError, match="aligned"):
        binding.launch_resident_anyhit(shifted, o, d, lo, hi, occ)
    assert len(ec.calls) == 2 * (1 + len(TEAMS)) and len(ea.calls) == 1 + len(TEAMS)


def test_wrappers_run_the_twins_on_the_cpu(resident):
    """``resident_closest``/``resident_anyhit`` on CPU tensors: the twins, no
    launch; equal to the walk model."""
    jsc, tables = resident
    o, d = (_t(a) for a in _rays(jsc, 256, 5))
    lo, hi = _ranges(256)
    st = torch.full((256,), 2.0)
    shade.LAUNCHES.clear()
    got = intersect.resident_closest(tables, o, d, lo, hi)
    occ = intersect.resident_anyhit(tables, o, d, lo, st)
    assert not shade.LAUNCHES
    model = intersect.resident_walk_reference(tables, o, d, lo, hi)
    assert all(_same(a, b) for a, b in zip(got, model[:4]))
    assert torch.equal(occ, intersect.resident_walk_reference(tables, o, d, lo, st,
                                                              anyhit=True)[0])
