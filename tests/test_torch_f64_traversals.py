"""The binned and resident routes in float64 against the JAX package in
float64.

The scene is ``mesh_scene(4200)`` (4,182 triangles and 3 spheres: 17
binned clusters of 256 rows, 40 resident clusters of 128), the float32 one
widened by ``cast_floats``, as both packages do. Its rays are those of
``tests/test_torch_f64_routes.py``'s bvh scene (``_rays``, seed 0).

x64 is a process-global switch in JAX, so every JAX float64 reference comes
from ONE subprocess (the module fixture ``jax64``, as in
``tests/test_torch_f64_routes.py``) that writes an ``.npz``; the
comparisons run here, on the port's CPU twins (the binned driver on its
round twins, the resident wrappers on the brute-force twins). The JAX
references, all under x64:

* ``intersect``/``occluded`` with ``method="bruteforce"``,
  ``"binned_interpret"`` and ``"resident_interpret"`` (the JAX binned and
  resident Pallas kernels in interpret mode);
* ``render_pool(dtype=float64)`` and the wave engine in float64 (its CPU
  default, the brute force: every method gives its hits).

Tolerances, those of ``tests/test_torch_f64_routes.py``, and why: prim ids,
materials and occlusion exact; a triangle's t within 32 ulps (XLA
contracts multiply-adds on the CPU) and its normal exact (the table's); a
sphere's t within 1e-12 relative; whole renders equal rays and iterations
and ``max_rel <= 1e-9``. The JAX binned and resident kernels form a
triangle's t their own way: both the port's t and theirs are held within 32
ulps of the JAX brute force (measured: the kernels 22 ulps from it, the port
18; on one lane of 256 the two lie on either side of it, 33 ulps apart).
Against the JAX *kernels* a lane's prim may differ
only where the test shows why: an equal-t tie (both rows hit at the same t,
within the ulps), or, for the binned kernels, the JAX driver's float32 key
(it rounds each float64 entry and bound to nearest float32 and stops on a
strict ``<``, so it can stop a ray before the cluster of its hit; the
port's int64 keys cannot: :func:`test_f64_binned_keys_are_conservative`).
Measured: no lane differs.

Also, in float64: ``resident_walk_reference`` bitwise against the
brute-force twins; the team models of ``tests/teamutil.py`` at every team
against the round twins (binned) and the walk (resident);
``binding.resident_cached`` at both element sizes and the launchers'
float64 entry points through a mock library; the CLI's ``render --dtype f64
--method binned|resident``.

About 50 s on one worker (the JAX subprocess ~35 s of it).
"""

import contextlib
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402

from pathtrace_tpu_torch import cli, pool  # noqa: E402
from pathtrace_tpu_torch.kernels import binding  # noqa: E402
from pathtrace_tpu_torch.models import scenes  # noqa: E402
from pathtrace_tpu_torch.ops import binned, intersect, shade  # noqa: E402
from pathtrace_tpu_torch.ops.binned import cluster_entries  # noqa: E402

from .teamutil import INF, team_in_order, team_vote  # noqa: E402
from .test_torch_binned_team import _c_params as binned_params  # noqa: E402
from .test_torch_binned_team import _Lib, _screened, _warps  # noqa: E402
from .test_torch_binned_team import _team_closest as binned_team_closest  # noqa: E402
from .test_torch_f64_routes import _check_hits, _rays, _t, _ulps  # noqa: E402
from .test_torch_resident_team import _c_params as resident_params  # noqa: E402
from .test_torch_resident_team import _team_closest as resident_team_closest  # noqa: E402

render = importlib.import_module("pathtrace_tpu_torch.render")   # the module, not the function
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
N = 256
W = H = 8
TEAMS = (1, 2, 4, 8, 16, 32)
METHODS = ("binned", "resident")
POOL = dict(width=W, height=H, spp=1, num_slots=64, seed=3, max_bounces=6)
EYE = (0.0, 1.6, 5.5)

JAX_SCRIPT = r"""
import importlib
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp
from pathtrace_tpu import pool
from pathtrace_tpu.models import scenes
from pathtrace_tpu.ops import intersect
render = importlib.import_module("pathtrace_tpu.render")

f64 = jnp.float64
z = dict(np.load(sys.argv[1]))
out = {}
sc = render.cast_floats(scenes.mesh_scene(4200), f64)
o, d, lo, hi, st = (jnp.asarray(z[k]) for k in ("o", "d", "lo", "hi", "st"))
for m in ("bruteforce", "binned_interpret", "resident_interpret"):
    h = intersect.intersect(sc, o, d, lo, hi, method=m)
    for k in ("t", "prim", "normal", "mat"):
        out[f"{m}_{k}"] = getattr(h, k)
    out[f"{m}_occ"] = intersect.occluded(sc, o, d, lo, st, method=m)
W = H = 8
cam = scenes.mesh_scene_camera(W, H)
img, c, it = pool.render_pool(scenes.mesh_scene(4200), cam, width=W, height=H, spp=1,
                              num_slots=64, seed=3, max_bounces=6, dtype=f64)
out.update(pool=img, pool_rays=pool.ray_count(np.asarray(c)), pool_iters=int(it))
wave = render.render(scenes.mesh_scene(4200), cam,
                     render.RenderConfig(width=W, height=H, spp=1, max_bounces=6, seed=3,
                                         dtype=f64))
out["wave"] = wave.image_sum
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def ports():
    """The widened scene and its binned and resident tables."""
    sc = render.cast_floats(scenes.mesh_scene(4200, device="cpu"), F64)
    tables = {m: intersect.build_tables(sc, m) for m in METHODS}
    for m, t in tables.items():
        assert t.route == m
        assert all(x.dtype == F64 for x in (t.tri, t.leaf, t.group, t.sph, t.sph_box))
    assert tables["binned"].leaf.shape[0] == 17 and tables["resident"].leaf.shape[0] == 40
    return sc, tables


@pytest.fixture(scope="module")
def jax64(tmp_path_factory, ports):
    """The JAX float64 references, from one subprocess (x64 is global)."""
    tmp = tmp_path_factory.mktemp("f64traversals")
    z = _rays(ports[0], EYE, N, 0)
    np.savez(tmp / "in.npz", **z)
    subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.npz"), str(tmp / "out.npz")],
                   cwd=REPO, check=True, capture_output=True, text=True, timeout=300,
                   env={**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"})
    return z, dict(np.load(tmp / "out.npz"))


def _lanes(z):
    return tuple(_t(z[k]) for k in ("o", "d", "lo", "hi", "st"))


@pytest.mark.parametrize("method", METHODS)
def test_f64_twins_match_jax_bruteforce(jax64, ports, method):
    """``intersect``/``occluded`` on the route's twins (the binned driver on
    its round twins, the resident wrappers) against the JAX brute force in
    float64."""
    z, want = jax64
    tables = ports[1][method]
    o, d, lo, hi, st = _lanes(z)
    shade.LAUNCHES.clear()
    h = intersect.intersect(tables, o, d, lo, hi)
    assert h.t.dtype == h.normal.dtype == h.point.dtype == F64
    _check_hits(tables, o, h.t.numpy(), h.prim.numpy(), h.normal.numpy(), h.mat.numpy(),
                want["bruteforce_t"], want["bruteforce_prim"], want["bruteforce_normal"],
                want["bruteforce_mat"])
    occ = intersect.occluded(tables, o, d, lo, st).numpy()
    np.testing.assert_array_equal(occ, want["bruteforce_occ"])
    assert 0.05 < occ.mean() < 0.95
    assert not shade.LAUNCHES                        # CPU tensors: twins, no launch


def _jax_binned_stops(tables, o, d, lo, hi, lane, row, bound):
    """Does the JAX binned driver's float32 key stop ray ``lane`` before the
    cluster of triangle ``row`` once its best t is ``bound``: the cluster's
    float64 entry is <= the bound, but the entry rounded to nearest float32,
    its id bits stripped, is not strictly below the float32 bound
    (``binned_intersect._pack_keys``, ``_packed_bound``)?"""
    n_clusters = tables.leaf.shape[0]
    e = cluster_entries(o[lane:lane + 1], d[lane:lane + 1], lo[lane:lane + 1],
                        hi[lane:lane + 1], tables.leaf)[0, row // 256].item()
    idmask = (1 << binned.id_bits(n_clusters)) - 1
    key = int(np.float32(e).view(np.int32)) & ~idmask
    return e <= bound and key >= int(np.float32(bound).view(np.int32))


@pytest.mark.parametrize("method", METHODS)
def test_f64_twins_match_jax_kernels(jax64, ports, method):
    """Against the JAX binned and resident kernels in interpret mode under
    x64: equal prims, materials, normals and occlusion; a triangle's t and
    the kernels' both within 32 ulps of the JAX brute force. A lane whose
    prim differs must be an equal-t tie, or (binned) a ray the JAX float32
    key stopped before its hit's cluster while the JAX brute force agrees
    with the port."""
    z, want = jax64
    tables = ports[1][method]
    o, d, lo, hi, st = _lanes(z)
    h = intersect.intersect(tables, o, d, lo, hi)
    t, prim = h.t.numpy(), h.prim.numpy()
    key = f"{method}_interpret"
    wt, wprim = want[f"{key}_t"], want[f"{key}_prim"]
    differ = np.nonzero(prim != wprim)[0]
    for i in differ:
        tie = prim[i] >= 0 and wprim[i] >= 0 and _ulps(t[i:i + 1], wt[i:i + 1])[0] <= 32
        rounded = (method == "binned" and prim[i] == want["bruteforce_prim"][i]
                   and 0 <= prim[i] < tables.tri_rows and wt[i] > t[i]
                   and _jax_binned_stops(tables, o, d, lo, hi, i, prim[i],
                                         min(float(wt[i]), float(hi[i]))))
        assert tie or rounded, (i, prim[i], wprim[i], t[i], wt[i])
    same = prim == wprim
    hit = same & (prim >= 0)
    assert hit.mean() > 0.3 and len(differ) <= 2
    tri = hit & (prim < tables.tri_rows)
    bf = want["bruteforce_t"]                        # the kernels form t their own way
    assert _ulps(t[tri], bf[tri]).max() <= 32 and _ulps(wt[tri], bf[tri]).max() <= 32
    sph = hit & (prim >= tables.tri_rows)
    assert (np.abs(t[sph] - wt[sph]) <= 1e-12 * wt[sph]).all()
    np.testing.assert_array_equal(h.mat.numpy()[hit], want[f"{key}_mat"][hit])
    np.testing.assert_array_equal(h.normal.numpy()[tri], want[f"{key}_normal"][tri])
    occ = intersect.occluded(tables, o, d, lo, st).numpy()
    np.testing.assert_array_equal(occ, want[f"{key}_occ"])


def test_f64_binned_keys_are_conservative():
    """Two clusters on one ray (from the origin along +z): cluster 0,
    entered at t = 1, holds A hit at b = 5 + 2^-30; cluster 1, entered at e
    = 5 + 2^-31, holds B hit at 5 + 3 2^-32, nearer than A. All three round
    to 5.0f in float32, so the JAX driver's key (the entry rounded to
    nearest float32, low bits stripped: 5.0f) is not strictly below its
    float32 bound (5.0f) once A is found: it stops the ray and returns A.
    The port's float64 keys are the entries' own int64 bits, truncated: the
    ray stays live, the driver visits cluster 1 and returns B, the
    brute-force answer; in float64 every key bound holds."""
    b, e, tb = 5.0 + 2.0**-30, 5.0 + 2.0**-31, 5.0 + 3 * 2.0**-32
    assert np.float32(b) == np.float32(e) == np.float32(tb) == 5.0 and e < tb < b
    tri = torch.zeros((512, 16), dtype=F64)
    for row, z in ((0, b), (256, tb)):                # v0, e1, e2, normal, material
        tri[row, 0:13] = torch.tensor([-1.0, -1.0, z, 2.0, 0, 0, 0, 2.0, 0, 0, 0, 1.0, row + 1],
                                      dtype=F64)
    leaf = torch.tensor([[-1.0, -1.0, 1.0, 1.0, 1.0, b + 1.0, 0, 0],
                         [-1.0, -1.0, e, 1.0, 1.0, tb + 1.0, 0, 0]], dtype=F64)
    empty = tri.new_zeros((0, 8))
    tables = intersect.Tables(tri=tri, leaf=leaf, group=empty, sph=empty, sph_box=empty,
                              tri_rows=512, n_groups=0, route="binned")
    o = torch.zeros((1, 3), dtype=F64)
    d = torch.tensor([[0.0, 0.0, 1.0]], dtype=F64)
    lo, hi = torch.full((1,), 1e-3, dtype=F64), torch.full((1,), INF, dtype=F64)
    entries = cluster_entries(o, d, lo, hi, leaf)
    assert entries.tolist() == [[1.0, e]]
    keys, idmask = binned.pack_keys(entries, 2)
    assert keys.dtype == torch.int64 and (keys & idmask).tolist() == [[0, 1]]
    assert (keys & ~idmask).view(F64).tolist() == [[1.0, e]]    # no id bit in a float64 mantissa
    bound = torch.tensor([b], dtype=F64)
    assert binned.live_rays(keys[:, 1], idmask, bound).tolist() == [True]
    assert _jax_binned_stops(tables, o, d, lo, hi, 0, 256, b)       # the JAX key stops it
    stats = {}
    got = binned.triangle_closest_binned(tables, o, d, lo, hi, stats=stats)
    want = intersect.triangle_closest_reference(tables, o, d, lo, hi)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert got[0].item() == tb and got[1].item() == 256 and got[3].item() == 257
    assert stats == {"rounds": 2, "ray_rounds": 2}
    # A bound just below the entry stops it; one at the entry keeps it live.
    below = torch.tensor([np.nextafter(e, 0.0)], dtype=F64)
    assert binned.live_rays(keys[:, 1], idmask, below).tolist() == [False]
    assert binned.live_rays(keys[:, 1], idmask, torch.tensor([e], dtype=F64)).tolist() == [True]
    assert binned.live_rays(keys[:, 1].clone().fill_(binned._CLEARED[torch.int64]),
                            idmask).tolist() == [False]
    # float32 keys stay int32, and an equal-t entry stays live there too.
    k32, m32 = binned.pack_keys(entries.float(), 2)
    assert k32.dtype == torch.int32
    assert binned.live_rays(k32[:, 1], m32, torch.tensor([5.0])).tolist() == [True]


def test_f64_resident_walk_is_the_twin(jax64, ports):
    """``resident_walk_reference`` in float64 gives the brute-force twins'
    hits and occlusion bit for bit, with edge ranges."""
    z, _ = jax64
    tables = ports[1]["resident"]
    o, d, lo, hi, st = _lanes(z)
    hi = hi.clone()
    hi[:5] = torch.tensor([float("nan"), -1.0, 0.0, shade.EPS, 2.0], dtype=F64)
    st = st.clone()
    st[:5] = torch.tensor([float("nan"), -1.0, 0.0, shade.EPS, INF], dtype=F64)
    want = intersect.triangle_closest_reference(tables, o, d, lo, hi)
    got = intersect.resident_walk_reference(tables, o, d, lo, hi, chunk=100)
    for a, b in zip(want, got[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (want[1] >= 0).double().mean() > 0.3 and not got[4][:3].any()
    assert torch.equal(got[5], 128 * got[4]) and int(got[4].max()) >= 2
    occ = intersect.bvh_anyhit_reference(tables, o, d, lo, st)
    m_occ, visited, tested = intersect.resident_walk_reference(tables, o, d, lo, st,
                                                               anyhit=True)
    assert torch.equal(occ, m_occ) and 0.05 < occ.double().mean() < 0.95
    assert (visited[occ] >= 1).all() and (tested <= 128 * visited).all()


@pytest.fixture(scope="module")
def waves(jax64, ports):
    """The float64 binned drivers' first and largest tail waves (round
    twins), and an edge wave of the first closest round."""
    z, _ = jax64
    tables = ports[1]["binned"]
    o, d, lo, hi, st = _lanes(z)
    _, rounds = chip_smoke.capture_rounds(binned.triangle_closest_binned, tables, o, d, lo, hi)
    _, rounds_a = chip_smoke.capture_rounds(binned.triangle_anyhit_binned, tables, o, d, lo, st)
    assert len(rounds) >= 3 and len(rounds_a) >= 2
    assert rounds[0][0].dtype == F64 and rounds[0][4].dtype == torch.int32
    t_first = binned.round_closest_reference(tables, *rounds[0])[0]
    c = tables.leaf.shape[0]
    tail = max(rounds[1:], key=lambda w: w[4].shape[0])
    tail_a = max(rounds_a[1:], key=lambda w: w[4].shape[0])
    edge = chip_smoke.binned_edge_wave(rounds[0], t_first, c, n=128)
    return tables, {"first": rounds[0], "tail": tail, "edge": edge}, \
        {"first": rounds_a[0], "tail": tail_a, "edge": edge}


@pytest.mark.parametrize("k", TEAMS)
def test_f64_binned_team_sweep_and_vote_are_the_round_twins(waves, k):
    """The round kernels' team sweep and vote at k over float64 screened
    rows give the float64 round twins' (t, row) and occlusion on the first,
    a tail and an edge wave."""
    tables, closest, anyhit = waves
    for which in ("first", "tail", "edge"):
        wave = closest[which]
        ref_t, ref_i, _, _ = binned.round_closest_reference(tables, *wave)
        ts, live = _screened(tables, wave)
        assert ts.dtype == F64 and (ref_i >= 0).any()
        assert binned_team_closest(ts, live, wave[4], k) == list(zip(ref_t.tolist(),
                                                                     ref_i.tolist()))
        wave = anyhit[which]
        want = binned.round_anyhit_reference(tables, *wave)
        ts, live = _screened(tables, wave)
        hits = (ts < INF) & live[None, :]
        got = []
        for rays in _warps(ts.shape[1], k):
            teams = [hits[:, r].tolist() if live[r] else [] for r in rays]
            teams += [[]] * (32 // k - len(rays))
            got += [hit for _, (hit, _) in zip(rays, team_vote(teams, k))]
        assert got == want.tolist()


@pytest.mark.parametrize("k", TEAMS)
def test_f64_resident_team_walk_is_the_model(jax64, ports, k):
    """The resident closest kernel's team walk at k (successor scan over
    float64 entries, ``<=`` gate, split sweep, lexicographic combine) gives
    the float64 twin's (t, row) and sweeps the walk model's clusters; its
    any hit's id-order ballot and vote give the twin's occlusion and the
    model's clusters; the cross-cluster tie in float64 goes to row 0."""
    z, _ = jax64
    tables = ports[1]["resident"]
    o, d, lo, hi, st = (x[:64] for x in _lanes(z))
    ref_t, ref_i, *_ = intersect.triangle_closest_reference(tables, o, d, lo, hi)
    got, swept = resident_team_closest(tables, o, d, lo, hi, k)
    assert got == [(float(t), int(i)) if i >= 0 else (INF, 2**31 - 1)
                   for t, i in zip(ref_t, ref_i)]
    model = intersect.resident_walk_reference(tables, o, d, lo, hi)
    assert swept == int(model[4].sum()) > 64
    want, visited, _ = intersect.resident_walk_reference(tables, o, d, lo, st, anyhit=True)
    entered = cluster_entries(o, d, lo, st, tables.leaf) < INF
    rows = intersect._tri_ts(tables.tri, o, d, lo, st) < INF
    hits = rows.T.reshape(64, -1, 128)
    for first in range(0, 64, 32 // k):
        rays = range(first, first + 32 // k)
        res = team_in_order([entered[r].tolist() for r in rays], [hits[r].tolist() for r in rays],
                            k)
        for r, (hit, n_swept, _) in zip(rays, res):
            assert hit == bool(want[r]) and n_swept == int(visited[r]), (k, r)
    tt, _ = chip_smoke.tie_tables("cpu", 1, route="resident")
    tt = chip_smoke.widen_tables(tt, F64)
    to, td, tlo, thi, _ = (x.to(F64) for x in chip_smoke.tie_rays("cpu"))
    got, swept = resident_team_closest(tt, to, td, tlo, thi, k)
    assert got == [(5.0, 0)] * to.shape[0] and swept == 2 * to.shape[0]


def test_f64_resident_cached_and_launchers(ports, monkeypatch):
    """``binding.resident_cached`` by element size (config 4's 552 clusters
    cached from team 16 in float64, from 8 in float32; 768 at 16 the
    float64 limit), and the launchers through a mock library: float64
    tensors reach the ``_f64`` entry points, whose declared argument types
    match their C signatures, with the float64 cached mode by default where
    the entries fit."""
    assert [binding.resident_cached(552, k, 8) for k in TEAMS] == [False] * 4 + [True] * 2
    assert [binding.resident_cached(552, k) for k in TEAMS] == [False] * 3 + [True] * 3
    assert binding.resident_cached(768, 16, 8) and not binding.resident_cached(769, 16, 8)
    assert binding.resident_cached(1536, 16, 4) and not binding.resident_cached(1536, 16, 8)
    _, tables = ports
    lib = _Lib()
    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding.build, "build", lambda: ("mock.so", 0.0))
    monkeypatch.setattr(binding.ctypes, "CDLL", lambda path: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(binding, "_stream", lambda dev: 0)
    n = 40
    o, d = torch.zeros((n, 3), dtype=F64), torch.zeros((n, 3), dtype=F64)
    lo, hi = torch.zeros(n, dtype=F64), torch.ones(n, dtype=F64)
    key = torch.zeros(n, dtype=torch.int32)
    out = (torch.empty(n, dtype=F64), torch.empty(n, dtype=torch.int32),
           torch.empty((n, 3), dtype=F64), torch.empty(n, dtype=torch.int32))
    occ = torch.empty(n, dtype=torch.bool)
    tb, tr = tables["binned"], tables["resident"]
    binding.launch_binned_round_closest(tb, o, d, lo, hi, key, *out)
    binding.launch_binned_round_anyhit(tb, o, d, lo, hi, key, occ)
    for team in TEAMS:
        binding.launch_resident_closest(tr, o, d, lo, hi, *out, team=team)
    binding.launch_resident_anyhit(tr, o, d, lo, hi, occ)
    for name, params in (("pt_binned_round_closest", binned_params),
                         ("pt_binned_round_anyhit", binned_params),
                         ("pt_resident_closest", resident_params),
                         ("pt_resident_anyhit", resident_params)):
        entry = lib.fns[name + "_f64"]
        assert not lib.fns[name].calls and entry.calls
        assert entry.argtypes == params(name + "_f64") == params(name)
        assert all(len(args) == len(entry.argtypes) for args in entry.calls)
        assert entry.calls[0][0] == (tb if "binned" in name else tr).tri.data_ptr()
    cached = [args[4] for args in lib.fns["pt_resident_closest_f64"].calls]
    assert cached == [int(binding.resident_cached(40, t, 8)) for t in TEAMS] == [1] * 6
    with pytest.raises(ValueError, match="shared memory"):
        binding.launch_resident_closest(tr._replace(leaf=tr.leaf.new_zeros((776, 8))), o, d, lo,
                                        hi, *out, team=16, cached=True)


def test_f64_host_teams(ports):
    """The teams the host takes for the float64 instances: the float32
    ones, but for the closest round, 4 threads a ray against 16
    (``binding.BINNED_TEAM_F64``: its float64 time summed over a driver
    call's waves at every team on the H100, ``PERF.md`` row 9f)."""
    tb, tr = ports[1]["binned"], ports[1]["resident"]
    tb32 = intersect.build_tables(scenes.mesh_scene(4200, device="cpu"), "binned")
    assert [binding._binned_team(t, None, k) for t in (tb, tb32)
            for k in ("binned_round_closest", "binned_round_anyhit")] == [4, 32, 16, 32]
    assert binding._binned_team(tb, 8, "binned_round_closest") == 8
    assert binding.RESIDENT_TEAM == {"resident_closest": 16, "resident_anyhit": 32}
    assert tr.leaf.element_size() == 8


@pytest.mark.parametrize("method", METHODS)
def test_render_pool_f64_matches_jax(jax64, method):
    """``render_pool(dtype=float64, method=m)`` (the composed branch on the
    route's twins) against the JAX float64 pool: equal rays and iterations,
    ``max_rel <= 1e-9``."""
    _, want = jax64
    sc = scenes.mesh_scene(4200, device="cpu")
    img, counters, iters = pool.render_pool(sc, scenes.mesh_scene_camera(W, H, device="cpu"),
                                            dtype=F64, method=method, **POOL)
    assert img.dtype == F64
    assert pool.ray_count(counters) == int(want["pool_rays"])
    assert iters == int(want["pool_iters"])
    a = want["pool"]
    assert np.max(np.abs(a - img.numpy()) / np.maximum(np.abs(a), 1.0)) <= 1e-9


@pytest.mark.parametrize("method", METHODS)
def test_wave_f64_matches_jax(jax64, method):
    """The wave engine in float64 under ``method`` against the JAX wave
    engine in float64: ``max_rel <= 1e-9``."""
    _, want = jax64
    st = render.render(scenes.mesh_scene(4200, device="cpu"),
                       scenes.mesh_scene_camera(W, H, device="cpu"),
                       render.RenderConfig(width=W, height=H, spp=1, max_bounces=6, seed=3,
                                           dtype=F64, method=method))
    assert st.image_sum.dtype == F64 and st.ray_queries > W * H
    a = want["wave"]
    assert np.max(np.abs(a - st.image_sum.numpy()) / np.maximum(np.abs(a), 1.0)) <= 1e-9


@pytest.mark.parametrize("method", METHODS)
def test_cli_renders_mesh_f64_per_ray(tmp_path, method):
    """``render --scene mesh --dtype f64 --method m`` (config 4's
    69,938-triangle mesh) renders on the CPU twins, exits 0 and writes a
    float64 image."""
    npy = str(tmp_path / "i.npy")
    assert cli.main(["render", "--scene", "mesh", "--dtype", "f64", "--method", method,
                     "--device", "cpu", "--width", "4", "--height", "4", "--spp", "1",
                     "--max-bounces", "2", "--out", str(tmp_path / "o.png"), "--npy", npy]) == 0
    img = np.load(npy)
    assert img.dtype == np.float64 and img.shape == (4, 4, 3) and np.isfinite(img).all()
    assert img.sum() > 0
