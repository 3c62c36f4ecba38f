"""The clustered sphere pair's team walk (``csrc/intersect.cu``), held on the
CPU.

The kernels walk each ray's entered 256-row clusters in ascending (entry,
id) order under an ``entry <= min(best_t, t_max)`` gate (``t_max`` for the
any hit), sphere boxes widened by the ray's root-error pad, a team of k
threads a ray splitting each cluster's sweep. A CUDA kernel cannot run here,
so:

* ``intersect.cluster_walk_reference`` follows the walk step for step; it is
  held bitwise against the brute-force twins (t, row, normal, material;
  occlusion) on the two fields of ``tests/test_torch_clustered.py`` and on
  grazing rays of its pad test's kind, so the ordered gate with the widened
  entries never skips the twin's hit;
* the team's successor scan and split sweep over 256-row clusters (NaN
  padding rows, equal-t rows, misses), and the any hit's vote, are modelled
  at k = 1-32 on a 32-lane warp (``tests/teamutil.py``) and held against the
  twins' first-minimum argmin and ``any``;
* the cross-cluster tie (``chip_smoke.sphere_tie_tables``): equal t in two
  clusters, the higher-row cluster entered first, goes to the lower row;
* the host's team rule (``kernels/binding.py :: cluster_team``).
"""

import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.ops import pallas_intersect as jax_pi  # noqa: E402
from pathtrace_tpu_torch.convert import scene_from_arrays, split_fields  # noqa: E402
from pathtrace_tpu_torch.kernels import binding  # noqa: E402
from pathtrace_tpu_torch.ops import intersect, shade  # noqa: E402
from pathtrace_tpu_torch.ops.binned import cluster_entries  # noqa: E402

from .teamutil import NONE, team_successor, team_sweep, team_vote  # noqa: E402
from .test_torch_clustered import SCENES, _rays  # noqa: E402

INF = float("inf")
N = 1024
TEAMS = (1, 2, 4, 8, 16, 32)
CLUSTER = 256


@pytest.fixture(scope="module", params=sorted(SCENES))
def field(request):
    build, eye = SCENES[request.param]
    jsc = build()
    return jsc, intersect.build_tables(scene_from_arrays(*split_fields(jsc), device="cpu")), eye


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(a, b):
    """Bitwise equality of float tensors, equality else."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _ranges(n):
    return torch.full((n,), shade.EPS), torch.full((n,), INF)


# ---- The model against brute force ----

@pytest.mark.parametrize("seed", [0, 1])
def test_walk_is_the_bruteforce_twin(field, seed):
    jsc, tables, eye = field
    o, d, st = (_t(a) for a in _rays(jsc, eye, N, seed))
    lo, hi = _ranges(N)
    hi[:5] = torch.tensor([math.nan, -1.0, 0.0, shade.EPS, 2.0])     # edge ranges
    st[:5] = torch.tensor([math.nan, -1.0, 0.0, shade.EPS, INF])
    box, n_box = tables.sph_box, tables.sph_box.shape[0]
    want = intersect.sphere_closest_reference(tables.sph, o, d, lo, hi)
    got = intersect.cluster_walk_reference(tables.sph, o, d, lo, hi, box, chunk=300)
    assert all(_same(a, b) for a, b in zip(want, got[:4]))
    assert (want[1] >= 0).float().mean() > 0.1 and got[1][:3].eq(-1).all()
    visited, tested = got[4:]
    assert not visited[:2].any() and not tested[:2].any()     # NaN and empty: no walk
    assert (visited[want[1] >= 0] >= 1).all() and (visited <= n_box).all()
    assert (tested <= CLUSTER * visited).all() and (tested >= visited).all()

    tri = tables.tri[:tables.tri_rows]
    for t, tb in ((tri, tables.leaf), (tri[:0], None)):       # as occluded() passes them
        occ = intersect.any_hit_reference(tables.sph, t, o, d, lo, st)
        m_occ, a_visited, a_tested = intersect.cluster_walk_reference(
            tables.sph, o, d, lo, st, box, t, tb, anyhit=True, chunk=300)
        assert torch.equal(occ, m_occ) and 0.05 < occ.float().mean() < 0.95
        assert (a_visited[occ] >= 1).all() and not a_visited[:3].any()
        assert (a_tested <= CLUSTER * a_visited).all()


def _grazing_table(seed, n_sph=700):
    """Spheres with centers up to 60 from the origin and radii 0.02 to 30 in
    256-row clusters, their boxes built as ``sphere_cluster_boxes`` builds
    them, and rays aimed at their silhouettes from up to ~170 away, a third
    of the directions up to 1e-3 off unit length (the cases of
    ``test_torch_clustered.test_sphere_pad_covers_the_root_error``)."""
    g = np.random.default_rng(seed)
    center = torch.tensor(g.uniform(-60, 60, (n_sph, 3)), dtype=torch.float32)
    radius = torch.tensor(np.exp(g.uniform(np.log(0.02), np.log(30.0), n_sph)),
                          dtype=torch.float32)
    n_pad = -(-n_sph // CLUSTER) * CLUSTER
    center = torch.cat([center, torch.full((n_pad - n_sph, 3), 1e9)])
    radius = torch.cat([radius, torch.zeros(n_pad - n_sph)])
    real = radius > 0
    lo = torch.where(real[:, None], center - radius[:, None], INF).view(-1, CLUSTER, 3).amin(1)
    hi = torch.where(real[:, None], center + radius[:, None], -INF).view(-1, CLUSTER, 3).amax(1)
    box = intersect.sphere_cluster_boxes(types.SimpleNamespace(
        sph_cluster_min=lo, sph_cluster_max=hi, sph_center=center, sph_radius=radius))
    c2 = center * center
    k = torch.where(real, c2[:, 0] + c2[:, 1] + c2[:, 2] - radius * radius, math.nan)
    inv_r = torch.where(real, 1.0 / torch.where(real, radius, 1.0), 0.0)
    sph = torch.cat([center, k[:, None], inv_r[:, None], torch.ones(n_pad, 1),
                     torch.zeros(n_pad, 2)], dim=1).contiguous()
    pick = torch.tensor(g.integers(0, n_sph, N))
    v = torch.tensor(g.normal(size=(N, 3)), dtype=torch.float32)
    v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    aim = center[pick] + v * (radius[pick] * torch.tensor(1 + g.uniform(-1e-3, 1e-3, N),
                                                          dtype=torch.float32))[:, None]
    o = torch.tensor(g.uniform(-100, 100, (N, 3)), dtype=torch.float32)
    d = aim - o
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    off = torch.where(torch.tensor(g.random(N) < 0.3), torch.tensor(
        1 + g.uniform(-1e-3, 1e-3, N), dtype=torch.float32), 1.0)
    return sph, box, o, (d * off[:, None]).contiguous()


@pytest.mark.parametrize("seed", [0, 1])
def test_walk_never_skips_a_grazing_hit(seed):
    sph, box, o, d = _grazing_table(seed)
    lo, hi = _ranges(N)
    want = intersect.sphere_closest_reference(sph, o, d, lo, hi)
    got = intersect.cluster_walk_reference(sph, o, d, lo, hi, box)
    assert all(_same(a, b) for a, b in zip(want, got[:4]))
    assert (want[1] >= 0).float().mean() > 0.3
    st = torch.where(want[1] >= 0, want[0], 50.0)          # a shadow range ending at the hit
    occ = intersect.any_hit_reference(sph, sph[:0, :0].new_zeros((0, 16)), o, d, lo, st)
    m_occ = intersect.cluster_walk_reference(sph, o, d, lo, st, box, anyhit=True)[0]
    assert torch.equal(occ, m_occ) and occ.float().mean() > 0.3


# ---- The team's successor scan, split sweep and vote ----

def _cluster_lanes(field, seed):
    """32 rays aimed at the spheres of the field's last sphere cluster, with
    ten of its rows repeated in later rows (equal t) and a quarter of the
    rays turned away (misses). Returns the sphere rows with NaN padding rows
    (k = NaN) filling the last cluster, the boxes, the rays and the last
    cluster's ``(first row, real rows)``."""
    _, tables, _ = field
    n = tables.sph.shape[0]
    last = (n - 1) // CLUSTER
    r0 = last * CLUSTER
    nan_row = torch.tensor([1e9, 1e9, 1e9, math.nan, 0.0, 0.0, 0.0, 0.0])
    sph = torch.cat([tables.sph, nan_row.expand(r0 + CLUSTER - n, 8)]).contiguous()
    real = n - r0
    assert 10 < real < CLUSTER - 10
    sph[r0 + real - 10:r0 + real] = sph[r0:r0 + 10]
    g = np.random.default_rng(seed)
    pick = torch.tensor(g.integers(r0, r0 + real, 32))
    target = sph[pick, 0:3] + torch.tensor(g.uniform(-0.05, 0.05, (32, 3)), dtype=torch.float32)
    o = target + torch.tensor(g.normal(size=(32, 3)) * 4.0, dtype=torch.float32)
    d = target - o
    d[::4] = -d[::4]
    d = (d / torch.linalg.vector_norm(d, dim=1, keepdim=True)).contiguous()
    return sph, tables.sph_box, o, d, (r0, real)


@pytest.mark.parametrize("k", TEAMS)
def test_team_walk_is_the_twins_first_minimum(field, k):
    """The closest kernel's walk for the 32 / k teams of a warp: the team
    successor scan over the ray's sphere entries, the ``<=`` gate, the split
    sweep of each cluster's screened rows under the bound and the
    lexicographic combine give the twin's (t, row) on every lane."""
    sph, box, o, d, _ = _cluster_lanes(field, seed=k)
    lo, hi = _ranges(32)
    ref_t, ref_i, *_ = intersect.sphere_closest_reference(sph, o, d, lo, hi)
    assert (ref_i >= 0).any() and (ref_i < 0).any()
    ts = intersect._sph_ts(sph, o, d, lo, hi)
    assert (((ts == ref_t) & (ref_i >= 0)).sum(0) > 1).any()          # equal-t rows
    entries = intersect.sphere_cluster_entries(o, d, lo, hi, box)
    n_cl = box.shape[0]
    swept = 0
    for first in range(0, 32, 32 // k):               # each warp holds 32 / k teams
        rays = [first + m for m in range(32 // k)]
        best = [(INF, NONE)] * len(rays)
        last = [(-INF, -1)] * len(rays)
        live = [True] * len(rays)
        while any(live):
            nxt = team_successor([entries[r].tolist() for r in rays], last, k)
            ts_lanes = []
            for m, r in enumerate(rays):
                e, c = nxt[m * k]
                assert all(x == (e, c) for x in nxt[m * k:(m + 1) * k])   # the team agrees
                bound = min(float(hi[r]), best[m][0])
                live[m] = live[m] and c != NONE and e <= bound
                last[m] = (e, c)
                rows = sph[c * CLUSTER:(c + 1) * CLUSTER] if live[m] else sph[:0]
                ts = intersect._sph_ts(rows, o[r:r + 1], d[r:r + 1], lo[r], bound)[:, 0]
                ts_lanes.append(ts.tolist())
            got = team_sweep(ts_lanes, 0, k)
            for m, r in enumerate(rays):
                if not live[m]:
                    continue
                swept += 1
                lt, lr = got[m * k]
                lr = lr + last[m][1] * CLUSTER if lr != NONE else NONE
                bt, bi = best[m]
                if lt < bt or (lt == bt and lr < bi):
                    best[m] = (lt, lr)
        for m, r in enumerate(rays):
            want = (float(ref_t[r]), int(ref_i[r])) if ref_i[r] >= 0 else (INF, NONE)
            assert best[m] == want, (k, r)
    assert swept >= 24 and n_cl == box.shape[0]


@pytest.mark.parametrize("k", TEAMS)
def test_team_vote_is_the_twins_any(field, k):
    """The any hit's split sweep: a full 256-row cluster, the last one with
    its NaN padding rows, and the same without them (a table ending inside
    a cluster: rows past its end are not tested), each thread's ``kCheck``
    rows between two votes of its team, give the twin's ``any`` over the
    cluster's rows; an occluded lane stops at the first vote."""
    sph, _, o, d, (last, real) = _cluster_lanes(field, seed=40 + k)
    lo, st = torch.full((32,), shade.EPS), torch.full((32,), 6.0)
    for r0, r1 in ((0, CLUSTER), (last, last + CLUSTER), (last, last + real)):
        ts = intersect._sph_ts(sph[r0:r1], o, d, lo, st)              # (rows, 32)
        want = (ts < INF).any(dim=0)
        for first in range(0, 32, 32 // k):
            teams = [(ts[:, first + m] < INF).tolist() for m in range(32 // k)]
            for m, (hit, tested) in enumerate(team_vote(teams, k)):
                assert hit == bool(want[first + m]), (k, r0, first + m)
                assert tested <= r1 - r0 and (hit or tested == r1 - r0)


# ---- The cross-cluster tie ----

@pytest.mark.parametrize("upper", [1, 2], ids=["next_cluster", "cluster_after"])
def test_cross_cluster_tie_goes_to_row_0(upper):
    sph, box, b = chip_smoke.sphere_tie_tables("cpu", upper)
    n = len(chip_smoke.SPHERE_TIE_RAYS)
    o = torch.tensor([[x, y, 5.0] for x, y in chip_smoke.SPHERE_TIE_RAYS])
    d = torch.tensor([[0.0, 0.0, -1.0]] * n)
    lo, hi = _ranges(n)
    e = intersect.sphere_cluster_entries(o, d, lo, hi, box)
    assert (e[:, upper] < e[:, 0]).all() and (e[:, 0] < 5.0).all()   # B's cluster first
    want = intersect.sphere_closest_reference(sph, o, d, lo, hi)
    assert (want[1] == 0).all() and (want[3] == 1).all() and (want[0] >= 5.0).all()
    t, row, _, mat, visited, tested = intersect.cluster_walk_reference(sph, o, d, lo, hi, box)
    assert torch.equal(t, want[0]) and (row == 0).all() and (mat == 1).all()
    assert (visited == 2).all() and (tested == 2 * CLUSTER).all()
    occ = intersect.cluster_walk_reference(sph, o, d, lo, want[0], box, anyhit=True)[0]
    assert occ.all()
    # The JAX kernel visits clusters nearest-first with a strict < and keeps
    # the first cluster's row on equal t: B.
    center, radius = sph[:, 0:3], 1.0 / sph[:, 4]
    cmin = (center - radius[:, None]).view(-1, CLUSTER, 3).amin(dim=1)
    cmax = (center + radius[:, None]).view(-1, CLUSTER, 3).amax(dim=1)
    got = jax_pi.sphere_closest(*(jnp.asarray(x.numpy()) for x in (o, d, lo, hi, center, radius)),
                                jnp.asarray(sph[:, 5].numpy().astype(np.int32)),
                                jnp.asarray(cmin.numpy()), jnp.asarray(cmax.numpy()),
                                interpret=True, ray_tile=128)
    np.testing.assert_array_equal(np.asarray(got[0]), want[0].numpy())
    np.testing.assert_array_equal(np.asarray(got[1]), b)


# ---- The host's team ----

def test_host_cluster_team(field):
    _, tables, _ = field
    tri = tables.tri[:tables.tri_rows]
    rule = {k: binding.sweep_split(CLUSTER, k, binding.TEAMS) for k in ("sphere_closest",
                                                                       "any_hit")}
    assert all(v in TEAMS for v in rule.values())
    # Clustered: a cluster's 256 rows, whatever the table's length.
    assert binding.cluster_team("sphere_closest", (tables.sph, tables.sph_box)) == \
        rule["sphere_closest"]
    assert binding.cluster_team("any_hit", (tables.sph, tables.sph_box), (tri, tables.leaf)) == \
        rule["any_hit"]
    assert binding.cluster_team("any_hit", (tables.sph, tables.sph_box), (tri[:0], None)) == \
        rule["any_hit"]
    # One tile: the table's rows, so one thread on small tables (config 4's
    # 3 spheres; the Cornell wave's 1 sphere and 11 triangles).
    few = tables.sph[:3]
    assert binding.cluster_team("sphere_closest", (few, None)) == 1
    assert binding.cluster_team("any_hit", (tables.sph[:1], None), (tri[:11], None)) == 1
    assert binding.cluster_team("sphere_closest", (tables.sph[:512], tables.sph_box[:0])) == \
        binding.sweep_split(512, "sphere_closest", binding.TEAMS)
    assert binding._team(None, 4) == 4 and binding._team(32, 4) == 32
    with pytest.raises(ValueError, match="team"):
        binding._team(3, 4)
    shifted = tables.sph.view(-1)[1:801].view(100, 8)          # 4 bytes past a row start
    with pytest.raises(ValueError, match="aligned"):
        binding._team(None, 1, ("sph", shifted))
    binding._team(None, 1, ("sph", tables.sph), ("tri", tri[:0]))


def test_wrappers_run_the_twins_on_the_cpu(field):
    """``sphere_closest``/``any_hit`` with boxes on CPU tensors: the twins,
    no launch; equal to the walk model."""
    jsc, tables, eye = field
    o, d, st = (_t(a) for a in _rays(jsc, eye, 256, 5))
    lo, hi = _ranges(256)
    shade.LAUNCHES.clear()
    got = intersect.sphere_closest(tables.sph, o, d, lo, hi, box=tables.sph_box)
    tri = tables.tri[:tables.tri_rows]
    occ = intersect.any_hit(tables.sph, tri, o, d, lo, st, sph_box=tables.sph_box,
                            tri_box=tables.leaf)
    assert not shade.LAUNCHES
    model = intersect.cluster_walk_reference(tables.sph, o, d, lo, hi, tables.sph_box)
    assert all(_same(a, b) for a, b in zip(got, model[:4]))
    assert torch.equal(occ, intersect.cluster_walk_reference(
        tables.sph, o, d, lo, st, tables.sph_box, tri, tables.leaf, anyhit=True)[0])
    ent = cluster_entries(o, d, lo, st, tables.leaf)
    assert ent.shape == (256, tables.leaf.shape[0])
