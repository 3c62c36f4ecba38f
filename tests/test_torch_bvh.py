"""The BVH route's team traversal (``csrc/bvh.cu``), held on the CPU.

The kernels walk each ray's entered groups, then each group's entered
leaves, in ascending (entry, id) order under an ``entry <= min(best_t,
t_max)`` gate, a team of k threads a ray splitting each leaf's 128-row sweep.
A CUDA kernel cannot run here, so:

* ``intersect.bvh_traversal_reference`` follows the walk step for step; it
  is held bitwise against the brute-force twins (t, row, normal, material;
  occlusion), and its counts against a scalar walk written out below;
* the team's split sweep, its successor search and its masked combine are
  modelled at k = 1-32 on a 32-lane warp holding 32 / k teams, and held
  against ``torch.min``'s first minimum;
* the tie case: equal t in two leaves, the higher-row leaf entered first and
  the lower-row leaf entered exactly at that t, goes to the lower row, which
  a strict gate would miss;
* ``bvh_closest(counters=True)`` gives the JAX tuple's length and shapes.

The port's wrappers run the twins on CPU tensors; against the JAX kernels in
interpret mode (a 256-lane ray tile, which keeps their compile short) at
the tolerances of ``tests/test_torch_intersect.py``'s route tests: prim ids
and normals equal but for a budget of 2 rays (equal-t ties the JAX kernel
may resolve to another row), triangle t within 32 ulps, occlusion on all
but 2 rays.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu.models import scenes as jax_scenes  # noqa: E402
from pathtrace_tpu.ops import bvh_intersect as jax_bvh  # noqa: E402
from pathtrace_tpu_torch.convert import scene_from_arrays, split_fields  # noqa: E402
from pathtrace_tpu_torch.ops import intersect, shade  # noqa: E402
from pathtrace_tpu_torch.ops.binned import cluster_entries  # noqa: E402

from .teamutil import NONE, team_successor, team_sweep  # noqa: E402

INF = float("inf")
N = 1024
TEAMS = (1, 2, 4, 8, 16, 32)


@pytest.fixture(scope="module")
def mesh():
    """mesh_scene(4200): 4,182 triangles in 33 leaves (the last with 42 zero
    padding rows) under 3 groups, 15 inverted padding leaves."""
    jsc = jax_scenes.mesh_scene(4200)
    tables = intersect.build_tables(scene_from_arrays(*split_fields(jsc), device="cpu"))
    assert tables.route == "bvh" and tables.n_groups == 3 and tables.tri_rows == 4182
    return jsc, tables


def _rays(seed, n=N):
    """Half rays from points inside the knot's bounds in random directions,
    half from outside toward points inside (``test_torch_intersect``'s
    ``_scene_rays``), and random shadow ranges; unit directions."""
    g = np.random.default_rng(seed)
    lo, hi = np.array([-2.0, -1.2, -2.0]), np.array([2.0, 1.6, 2.0])
    inside = g.uniform(lo, hi, (n, 3))
    o = np.concatenate([inside[: n // 2], g.uniform(lo - 3.0, hi + 3.0, (n - n // 2, 3))])
    d = np.concatenate([g.normal(size=(n // 2, 3)), inside[n // 2:] - o[n // 2:]])
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32),
            torch.tensor(g.uniform(0.05, 6.0, n), dtype=torch.float32))


def _ranges(n):
    return torch.full((n,), shade.EPS), torch.full((n,), INF)


def _same(a, b):
    """Bitwise equality of float tensors (NaN never occurs here), equality else."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


# ---- The model against brute force, and against a scalar walk ----

@pytest.mark.parametrize("seed", [0, 1])
def test_traversal_reference_is_the_bruteforce_twin(mesh, seed):
    _, tables = mesh
    o, d, st = _rays(seed)
    # Edge rays: NaN, negative and empty ranges.
    st[:8] = torch.tensor([math.nan, -1.0, 0.0, shade.EPS, INF, math.nan, 1e-4, 2.0])
    lo, hi = _ranges(N)
    hi[:4] = torch.tensor([math.nan, -1.0, INF, 0.5])
    want = intersect.bvh_closest_reference(tables, o, d, lo, hi)
    got = intersect.bvh_traversal_reference(tables, o, d, lo, hi, chunk=300)
    assert all(_same(a, b) for a, b in zip(want, got[:4]))
    assert (want[1] >= 0).float().mean() > 0.4 and got[1][:2].eq(-1).all()
    visited, swept = got[4:]
    assert not visited[:2].any() and not swept[:2].any()   # NaN and empty: no walk
    assert (swept[want[1] >= 0] >= 1).all()
    assert (visited <= tables.n_groups).all() and (swept <= 16 * visited).all()

    occ = intersect.bvh_anyhit_reference(tables, o, d, lo, st)
    m_occ, a_visited, a_swept = intersect.bvh_traversal_reference(tables, o, d, lo, st,
                                                                  anyhit=True)
    assert torch.equal(occ, m_occ) and 0.05 < occ.float().mean() < 0.95
    assert (a_swept[occ] >= 1).all() and not a_visited[:3].any()
    assert (a_visited <= tables.n_groups).all() and (a_swept <= 16 * a_visited).all()


def _leaf_min(tables, leaf, o, d, t_min, cap):
    """The least (t, row) of one leaf's rows with t in [t_min, cap] for one
    ray: the twin's first minimum (inf, NONE on none)."""
    rows = tables.tri[leaf * intersect.LEAF:(leaf + 1) * intersect.LEAF]
    ts = intersect._tri_ts(rows, o[None], d[None], t_min, cap)[:, 0]
    t, arg = torch.min(ts, dim=0)
    return (float(t), leaf * intersect.LEAF + int(arg)) if t < INF else (INF, NONE)


def scalar_walk(tables, o, d, t_min, t_max, gate="<="):
    """One ray's walk written out: ``(t, row, groups visited, leaves
    swept)``; ``gate`` ``"<"`` is the strict gate of the JAX kernels."""
    ok = (lambda e, b: e <= b) if gate == "<=" else (lambda e, b: e < b)
    one = (o[None], d[None], t_min[None], t_max[None])
    ge = cluster_entries(*one, tables.group[:tables.n_groups])[0].tolist()
    le = cluster_entries(*one, tables.leaf)[0].tolist()
    best_t, best_i, visited, swept = INF, -1, 0, 0

    def order(entries, ids):
        return sorted((e, i) for e, i in zip(entries, ids) if e < INF)

    for e, g in order(ge, range(len(ge))):
        if not ok(e, min(float(t_max), best_t)):
            break
        visited += 1
        ids = range(g * intersect.GROUP, (g + 1) * intersect.GROUP)
        for el, leaf in order([le[i] for i in ids], ids):
            bound = min(float(t_max), best_t)
            if not ok(el, bound):
                break
            swept += 1
            t, row = _leaf_min(tables, leaf, o, d, t_min, bound)
            if t < best_t or (t == best_t and row < best_i):
                best_t, best_i = t, row
    return best_t, best_i, visited, swept


def test_model_counts_equal_the_scalar_walk(mesh):
    _, tables = mesh
    o, d, _ = _rays(5, 64)
    lo, hi = _ranges(64)
    t, row, _, _, visited, swept = intersect.bvh_traversal_reference(tables, o, d, lo, hi)
    for i in range(64):
        want = scalar_walk(tables, o[i], d[i], lo[i], hi[i])
        assert (float(t[i]), int(row[i]), int(visited[i]), int(swept[i])) == \
            (want[0], want[1] if want[1] >= 0 else -1, want[2], want[3]), i
    assert swept.sum() > 64


# ---- The team's split sweep, successor search and masked combine ----

def _leaf_lanes(mesh, seed):
    """Screened t of the last real leaf's rows (86 triangles, 42 zero padding
    rows) with ten rows repeated (equal t), for 32 rays aimed at its
    triangles, a quarter of them turned away (misses); caps inf and 2.0."""
    _, tables = mesh
    leaf = tables.tri_rows // intersect.LEAF
    rows = tables.tri[leaf * intersect.LEAF:(leaf + 1) * intersect.LEAF].clone()
    rows[50:60] = rows[0:10]
    assert not rows[86:].any()
    g = np.random.default_rng(seed)
    v0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    pick = torch.tensor(g.integers(0, 60, 32))
    target = v0[pick] + 0.3 * e1[pick] + 0.3 * e2[pick]
    o = target + torch.tensor(g.normal(size=(32, 3)) * 2.0, dtype=torch.float32)
    d = target - o
    d[::4] = -d[::4]
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    return leaf, rows, o, d


@pytest.mark.parametrize("k", TEAMS)
def test_team_sweep_is_the_twins_first_minimum(mesh, k):
    leaf, rows, o, d = _leaf_lanes(mesh, seed=1)
    base = leaf * intersect.LEAF
    for cap in (INF, 2.0):
        ts = intersect._tri_ts(rows, o, d, shade.EPS, cap)              # (128, 32)
        ref_t, ref_arg = torch.min(ts, dim=0)
        ties = ((ts == ref_t) & torch.isfinite(ref_t)).sum(0) > 1
        assert torch.isinf(ref_t).any() and torch.isfinite(ref_t).any()
        assert ties.any() or cap < INF
        for first in range(0, 32, 32 // k):          # each warp holds 32 / k teams
            teams = [ts[:, first + m].tolist() for m in range(32 // k)]
            got = team_sweep(teams, base, k)
            for lane, (t, row) in enumerate(got):
                ray = first + lane // k
                want_t = float(ref_t[ray])
                want = (want_t, base + int(ref_arg[ray])) if want_t < INF else (INF, NONE)
                assert (t, row) == want, (k, cap, ray, lane)


@pytest.mark.parametrize("k", TEAMS)
def test_team_successor_is_the_models(mesh, k):
    """The team's successor search over 35 and 16 boxes with equal entries
    and boxes not entered, step by step, against ``_successor``."""
    g = np.random.default_rng(10 + k)
    for n_boxes in (35, 16):
        entries = torch.tensor(g.choice([0.5, 1.0, 1.5, 2.0, INF], (32 // k, n_boxes)),
                               dtype=torch.float32)
        last = [(-INF, -1)] * (32 // k)
        steps = 0
        while True:
            got = team_successor([e.tolist() for e in entries], last, k)
            e_ref, c_ref = intersect._successor(
                entries, torch.tensor([x[0] for x in last]), torch.tensor([x[1] for x in last]))
            for lane, (e, c) in enumerate(got):
                m = lane // k
                want = (float(e_ref[m]), int(c_ref[m])) if e_ref[m] < INF else (INF, NONE)
                assert (e, c) == want, (k, n_boxes, steps, lane)
            if all(x[1] == NONE for x in got):
                break
            last = [got[m * k] for m in range(32 // k)]
            last = [x if x[1] != NONE else (INF, n_boxes) for x in last]
            steps += 1
        assert steps == int((entries < INF).sum(1).max())


# ---- The tie case ----



@pytest.mark.parametrize("upper_leaf", [1, 16], ids=["same_group", "next_group"])
def test_tie_goes_to_the_lower_row(upper_leaf):
    tables, b = chip_smoke.tie_tables("cpu", upper_leaf)
    n = len(chip_smoke.TIE_RAYS)
    o = torch.tensor([[x, y, 5.0] for x, y in chip_smoke.TIE_RAYS])
    d = torch.tensor([[0.0, 0.0, -1.0]] * n)
    lo, hi = _ranges(n)
    le = cluster_entries(o, d, lo, hi, tables.leaf)
    assert (le[:, 0] == 5.0).all() and (le[:, upper_leaf] == 4.0).all()
    t, row, _, _, visited, swept = intersect.bvh_traversal_reference(tables, o, d, lo, hi)
    assert (t == 5.0).all() and (row == 0).all()                # the lower row
    assert (swept == 2).all() and (visited == 1 + (upper_leaf >= 16)).all()
    want = intersect.bvh_closest_reference(tables, o, d, lo, hi)
    assert (want[1] == 0).all()
    for i in range(n):
        assert scalar_walk(tables, o[i], d[i], lo[i], hi[i])[:2] == (5.0, 0)
        assert scalar_walk(tables, o[i], d[i], lo[i], hi[i], gate="<")[:2] == (5.0, b)
    # The JAX kernel (strict gate, leaves of a group in row order, groups
    # nearest-first): the lower row within one group, the upper row when A's
    # group is entered exactly at the best t after B's.
    r = tables.tri_rows
    got = jax_bvh.triangle_closest_bvh(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(lo.numpy()),
        jnp.asarray(hi.numpy()), *(jnp.asarray(tables.tri[:r, c:c + 3].numpy())
                                   for c in (0, 3, 6, 9)),
        jnp.asarray(tables.tri[:r, 12].numpy().astype(np.int32)), interpret=True, ray_tile=256)
    np.testing.assert_array_equal(np.asarray(got[0]), 5.0)
    np.testing.assert_array_equal(np.asarray(got[1]), 0 if upper_leaf < 16 else b)


# ---- Against the JAX kernels, and the counters' contract ----

def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_bvh_matches_jax_interpret_with_counters(mesh):
    """bvh_closest and bvh_anyhit (CPU: the twins) against the JAX kernels
    in interpret mode; with counters=True both return the six-tuple with
    (N_pad / 256,) int32 diagnostics."""
    jsc, tables = mesh
    o, d, st = _rays(3)
    lo, hi = _ranges(N)
    arrays = [jnp.asarray(x.numpy()) for x in (o, d, lo, hi)]
    want = jax_bvh.triangle_closest_bvh(*arrays, jsc.tri_v0, jsc.tri_e1, jsc.tri_e2,
                                        jsc.tri_normal, jsc.tri_mat, interpret=True,
                                        ray_tile=256, counters=True)
    got = intersect.bvh_closest(tables, o, d, lo, hi, counters=True)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and str(g.dtype)[6:] == str(w.dtype)
    n_pad = -(-N // jax_bvh.RAY_TILE) * jax_bvh.RAY_TILE   # the JAX defaults' padding
    assert got[4].shape == got[5].shape == (n_pad // jax_bvh.SUB_W,)
    prim, wprim = got[1].numpy(), np.asarray(want[1])
    same = prim == wprim
    assert (~same).sum() <= 2, np.nonzero(~same)
    hit = same & (prim >= 0)
    assert hit.mean() > 0.3
    assert _ulps(got[0].numpy()[hit], np.asarray(want[0])[hit]).max() <= 32
    np.testing.assert_array_equal(got[2].numpy()[hit], np.asarray(want[2])[hit])
    np.testing.assert_array_equal(got[3].numpy()[same], np.asarray(want[3])[same])

    occ = jax_bvh.triangle_anyhit_bvh(*arrays[:3], jnp.asarray(st.numpy()), jsc.tri_v0,
                                      jsc.tri_e1, jsc.tri_e2, interpret=True, ray_tile=256)
    got_occ = intersect.bvh_anyhit(tables, o, d, lo, st).numpy()
    assert (got_occ != np.asarray(occ)).sum() <= 2 and 0.05 < got_occ.mean() < 0.95


@pytest.mark.parametrize("n", [700, 1024, 1500])
def test_counters_contract(mesh, n):
    _, tables = mesh
    o, d, _ = _rays(7, n)
    lo, hi = _ranges(n)
    plain = intersect.bvh_closest(tables, o, d, lo, hi)
    got = intersect.bvh_closest(tables, o, d, lo, hi, counters=True)
    assert all(_same(a, b) for a, b in zip(plain, got[:4]))
    spans = -(-n // 1024) * 4
    for c in got[4:]:
        assert c.dtype == torch.int32 and c.shape == (spans,)
    *_, visited, swept = intersect.bvh_traversal_reference(tables, o, d, lo, hi)
    assert torch.equal(got[4], intersect.bvh_span_sums(visited, n))
    assert torch.equal(got[5], intersect.bvh_span_sums(swept, n))
    assert int(got[4].sum()) == int(visited.sum()) and int(got[5].sum()) == int(swept.sum())
    used = -(-n // 256)                      # spans holding rays; the rest is padding
    assert not got[4][used:].any() and not got[5][used:].any()
    assert (got[5][:used] >= got[4][:used]).all()
    assert (visited <= tables.n_groups).all() and (swept <= tables.leaf.shape[0]).all()
    assert (swept[plain[1] >= 0] >= 1).all()


# ---- The host's team size ----

def test_host_team(mesh):
    from pathtrace_tpu_torch.kernels import binding

    _, tables = mesh
    assert binding.TEAMS == TEAMS
    for kernel in ("bvh_closest", "bvh_anyhit"):
        assert binding.BVH_TEAM[kernel] in TEAMS
        assert binding._bvh_team(tables, None, kernel) == binding.BVH_TEAM[kernel]
        assert binding._bvh_team(tables, 4, kernel) == 4
    with pytest.raises(ValueError, match="team"):
        binding._bvh_team(tables, 3, "bvh_closest")
    with pytest.raises(ValueError, match="aligned"):
        shifted = tables.tri.view(-1)[1:16001].view(1000, 16)     # 4 bytes past a row start
        binding._bvh_team(tables._replace(tri=shifted), None, "bvh_closest")
