"""The binned round pair's team sweep (``csrc/binned.cu``), held on the CPU.

Each round kernel gives one sorted ray to a team of k threads (1-32), thread
j testing rows j, j + k, ... of the ray's 256-row cluster. A CUDA kernel
cannot run here, so its rules are modelled on a 32-lane warp holding 32 / k
teams (``tests/teamutil.py``) and held against the round twins
(``ops/binned.py :: round_closest_reference`` / ``round_anyhit_reference``),
exactly:

* the closest kernel's strict first minimum per thread and its
  lexicographic (t, row) combine over the screened row values the twin
  computes (``shade._tri_hits``) give the twin's (t, row);
* the any-hit kernel's vote gives the twin's ``any``;
* on a sorted first-round wave of ``mesh_scene(2500)``, a tail wave of a
  driver call on the round twins, an edge wave (sentinel keys, ``t_up``
  NaN, -1, 0, inf, ``t_min`` at the hit's t: ``chip_smoke.binned_edge_wave``)
  and the tie case (``chip_smoke.binned_tie_tables``: two rows of one
  cluster hit at equal t go to the lower row at every k);
* the host's ``BINNED_TEAM``, and the launchers' arguments (``team``
  included) through a mock of the kernel library against the C entry
  points' signatures.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402

from pathtrace_tpu_torch.kernels import binding  # noqa: E402
from pathtrace_tpu_torch.ops import binned, intersect, shade  # noqa: E402

from .teamutil import INF, NONE, team_sweep, team_vote  # noqa: E402
from .test_torch_traversals import _t, mesh2500  # noqa: E402, F401

TEAMS = (1, 2, 4, 8, 16, 32)
CLUSTER = 256
N = 384


def _object_rays(tables, n, seed):
    """Rays from points 3 to 6 away from the mesh object (the clusters' boxes
    but the floor's, the largest) aimed at points inside its box, so that a
    ray enters several clusters; made with numpy."""
    g = np.random.default_rng(seed)
    boxes = tables.leaf[:, 0:6].numpy()
    boxes = np.delete(boxes, np.argmax(boxes[:, 3] - boxes[:, 0]), axis=0)
    lo, hi = boxes[:, 0:3].min(0), boxes[:, 3:6].max(0)
    aim = g.random((n, 3)) * (hi - lo) + lo
    v = g.normal(size=(n, 3))
    o = (lo + hi) / 2 + v / np.linalg.norm(v, axis=1, keepdims=True) * g.uniform(3, 6, (n, 1))
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return _t(o.astype(np.float32)), _t(d.astype(np.float32))


@pytest.fixture(scope="module")
def waves(mesh2500):
    """Binned tables and closest/any-hit waves of one driver call on the
    round twins each: the sorted first round, the largest tail wave, and
    the edge waves built from the first rounds."""
    _, tsc = mesh2500
    tables = intersect.build_tables(tsc, "binned")
    o, d = _object_rays(tables, N, 11)
    lo, hi = torch.full((N,), shade.EPS), torch.full((N,), INF)
    st = torch.where(torch.arange(N) % 2 == 0, 3.0, 6.0)          # shadow ranges
    _, rounds = chip_smoke.capture_rounds(binned.triangle_closest_binned, tables, o, d, lo, hi)
    _, rounds_a = chip_smoke.capture_rounds(binned.triangle_anyhit_binned, tables, o, d, lo, st)
    assert len(rounds) >= 3 and len(rounds_a) >= 2
    first, first_a = rounds[0], rounds_a[0]
    assert first[4].shape[0] == N and torch.equal(first[4], first[4].sort()[0])   # sorted
    t_first = binned.round_closest_reference(tables, *first)[0]
    t_first_a = binned.round_closest_reference(tables, *first_a)[0]
    c = tables.leaf.shape[0]
    closest = {"first": first, "tail": max(rounds[1:], key=lambda w: w[4].shape[0]),
               "edge": chip_smoke.binned_edge_wave(first, t_first, c, n=256)}
    anyhit = {"first": first_a, "tail": max(rounds_a[1:], key=lambda w: w[4].shape[0]),
              "edge": chip_smoke.binned_edge_wave(first_a, t_first_a, c, n=256)}
    return tables, closest, anyhit


def _screened(tables, wave):
    """``(rows (256, n) of screened t, inf where the twin rejects the row;
    live)``, as ``round_closest_reference`` computes them."""
    o, d, lo, hi, key = wave
    n = key.shape[0]
    live, _, rows = binned._cluster_rows(tables, key, 0, n)
    ok, ts = shade._tri_hits(rows, binned._split(o, 0, n), binned._split(d, 0, n), hi, lo)
    return torch.where(ok, ts, INF)[:, 0, :], live


def _warps(n, k):
    """The rays of each warp of a launch at team k: 32 / k rays a warp."""
    per = 32 // k
    return [list(range(a, min(a + per, n))) for a in range(0, n, per)]


def _team_closest(ts, live, key, k):
    """The closest kernel's (t, row) per ray: a sentinel key's team sweeps
    nothing; the others sweep their cluster's screened rows (``team_sweep``)
    and part 0 writes the row (-1 on a miss)."""
    got = []
    for rays in _warps(ts.shape[1], k):
        lanes = [ts[:, r].tolist() if live[r] else [] for r in rays]
        lanes += [[]] * (32 // k - len(rays))                      # teams past the end
        res = team_sweep(lanes, 0, k)
        for m, r in enumerate(rays):
            assert all(x == res[m * k] for x in res[m * k:(m + 1) * k])   # the team agrees
            t, row = res[m * k]
            got.append((t, -1 if row == NONE else int(key[r]) * CLUSTER + row))
    return got


@pytest.mark.parametrize("k", TEAMS)
@pytest.mark.parametrize("which", ["first", "tail", "edge"])
def test_team_sweep_is_the_round_twin(waves, which, k):
    tables, closest, _ = waves
    wave = closest[which]
    ref_t, ref_i, ref_n, ref_m = binned.round_closest_reference(tables, *wave)
    ts, live = _screened(tables, wave)
    got = _team_closest(ts, live, wave[4], k)
    assert got == list(zip(ref_t.tolist(), ref_i.tolist()))
    assert (ref_i >= 0).any()
    dead = ~live
    if which == "edge":                          # sentinel keys: (inf, -1, 0, 0)
        assert dead.sum() == 3 * 256 // 16
        assert torch.isinf(ref_t[dead]).all() and (ref_i[dead] == -1).all()
        assert not ref_n[dead].any() and not ref_m[dead].any()
        assert (ref_i[~dead] < 0).any()          # NaN, -1 and 0 t_up: misses
    assert ((ref_i < 0) | (ref_i // CLUSTER == wave[4])).all()


@pytest.mark.parametrize("k", TEAMS)
@pytest.mark.parametrize("which", ["first", "tail", "edge"])
def test_team_vote_is_the_round_twin(waves, which, k):
    tables, _, anyhit = waves
    wave = anyhit[which]
    want = binned.round_anyhit_reference(tables, *wave)
    ts, live = _screened(tables, wave)
    hits = (ts < INF) & live[None, :]
    got = []
    for rays in _warps(ts.shape[1], k):
        teams = [hits[:, r].tolist() if live[r] else [] for r in rays]
        teams += [[]] * (32 // k - len(rays))
        for r, (hit, tested) in zip(rays, team_vote(teams, k)):
            assert tested <= CLUSTER and (hit or tested == (CLUSTER if live[r] else 0))
            got.append(hit)
    assert got == want.tolist()
    assert want.any() and not want.all()
    if which == "edge":
        assert not want[~live].any()             # sentinel keys: false


@pytest.mark.parametrize("k", TEAMS)
def test_equal_t_rows_go_to_the_lower_row(k):
    """``chip_smoke.binned_tie_tables``: A and its copy B in a higher row of
    the same cluster, hit at the same t; in cluster 0 B's thread is below
    A's at every k >= 2, in cluster 1 one thread tests both."""
    tables, o, d, key = chip_smoke.binned_tie_tables("cpu")
    m = o.shape[0]
    lo, hi = torch.full((m,), shade.EPS), torch.full((m,), INF)
    wave = (o, d, lo, hi, key)
    t, row, _, mat = binned.round_closest_reference(tables, *wave)
    lower = [a for a, _ in chip_smoke.BINNED_TIE_PAIRS]
    assert (t == 5.0).all() and row.tolist() == [lower[0]] * (m // 2) + [lower[1]] * (m // 2)
    assert (mat == 1).all()
    ts, live = _screened(tables, wave)
    for c, (a, b) in enumerate(chip_smoke.BINNED_TIE_PAIRS):
        r0 = c * CLUSTER
        assert ts[a - r0, c * (m // 2)] == ts[b - r0, c * (m // 2)] == 5.0
        if c == 0 and k > 1:
            assert (b - r0) % k < (a - r0) % k
    assert _team_closest(ts, live, key, k) == list(zip(t.tolist(), row.tolist()))
    st = torch.tensor([5.0, 4.5] * (m // 2))
    occ = binned.round_anyhit_reference(tables, o, d, lo, st, key)
    assert torch.equal(occ, st == 5.0)
    ref = intersect.triangle_closest_reference(tables, o, d, lo, hi)
    assert all(torch.equal(x, y) for x, y in zip(ref, binned.triangle_closest_binned(
        tables, o, d, lo, hi)))


def test_host_binned_team():
    assert set(binding.BINNED_TEAM) == {"binned_round_closest", "binned_round_anyhit"}
    assert all(v in binding.TEAMS for v in binding.BINNED_TEAM.values())
    assert binding.TEAMS == TEAMS


class _Fn:
    """A mock C entry point: records its arguments, returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _Lib:
    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, _Fn())


def _c_params(name):
    """ctypes types of the parameters of ``extern "C" int name(...)`` in
    ``csrc/binned.cu``: ``int`` as ``c_int``, pointers as ``c_void_p``."""
    src = (Path(binding.__file__).parent.parent / "csrc" / "binned.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)[1].split(",")
    return [binding._P if "*" in p else binding._I for p in params]


def test_launchers_pass_the_team_to_the_kernels(mesh2500, monkeypatch):
    """The launchers, through a mock kernel library: the argument types the
    binding declares match the C signatures, the arguments match them in
    number, ``team`` reaches the entry point (None: ``BINNED_TEAM``), and a
    team size the kernels lack or a misaligned table raises before a
    launch."""
    _, tsc = mesh2500
    tables = intersect.build_tables(tsc, "binned")
    lib = _Lib()
    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding.build, "build", lambda: ("mock.so", 0.0))
    monkeypatch.setattr(binding.ctypes, "CDLL", lambda path: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(binding, "_stream", lambda dev: 0)
    n = 40
    o, d = torch.zeros((n, 3)), torch.zeros((n, 3))
    lo, hi = torch.zeros(n), torch.ones(n)
    key = torch.zeros(n, dtype=torch.int32)
    out = (torch.empty(n), torch.empty(n, dtype=torch.int32), torch.empty((n, 3)),
           torch.empty(n, dtype=torch.int32))
    occ = torch.empty(n, dtype=torch.bool)
    launch = {"binned_round_closest": lambda **kw: binding.launch_binned_round_closest(
                  tables, o, d, lo, hi, key, *out, **kw),
              "binned_round_anyhit": lambda **kw: binding.launch_binned_round_anyhit(
                  tables, o, d, lo, hi, key, occ, **kw)}
    for name, fn in launch.items():
        for team in (None,) + TEAMS:
            fn(team=team)
        entry = lib.fns["pt_" + name]
        assert entry.argtypes == _c_params("pt_" + name)
        assert all(len(args) == len(entry.argtypes) for args in entry.calls)
        assert [args[2] for args in entry.calls] == [binding.BINNED_TEAM[name], *TEAMS]
        assert {(args[0], args[1], args[-2]) for args in entry.calls} == \
            {(tables.tri.data_ptr(), tables.leaf.shape[0], n)}
        with pytest.raises(ValueError, match="team"):
            fn(team=3)
        assert len(entry.calls) == 1 + len(TEAMS)
    shifted = tables._replace(tri=tables.tri.view(-1)[1:1 + tables.tri.numel() - 16]
                              .view(-1, 16))
    with pytest.raises(ValueError, match="aligned"):
        binding.launch_binned_round_anyhit(shifted, o, d, lo, hi, key, occ)
