"""Per-ray binned triangle traversal: the binned route of ``ops/intersect.py``.

Counterpart of the drivers of ``pathtrace_tpu/ops/binned_intersect.py``
(``triangle_closest_binned``, ``triangle_anyhit_binned``), in plain torch
around two hand-written round kernels (``csrc/binned.cu``, replacing
``_round_closest_kernel`` and ``_round_anyhit_kernel``).

Every ray keeps the entry distance of its segment into each 256-row cluster
box (the binned tables' widened boxes, :func:`cluster_entries`), packed with
the cluster id into one monotone key (:func:`pack_keys`: int32 from float32
rays, int64 from float64 ones). Round by round:

* each live ray takes its nearest unvisited cluster (the minimum key);
* the wave is sorted by that cluster id (``torch.sort`` and gathers; dead
  rays carry the sentinel key ``C`` and sort to the end, where they are cut
  off), and one round kernel tests every ray against its cluster's rows;
* the results go back to the rays' places by a scatter, the visited cluster
  is cleared, and the live count comes to the host (one sync a round, the
  JAX ``while_loop`` condition).

A ray stops once its best hit lies before the entry of its next unvisited
cluster. When fewer than a quarter (then a sixteenth) of the wave is live,
the live rays are compacted into a smaller state, the JAX cascade.

Two deliberate changes from the JAX drivers, so that the result equals the
brute-force twin (``intersect.triangle_closest_reference``) exactly, as the
port's other traversals do:

* a ray stays live while its truncated packed entry is **<=** its bound
  ``min(best_t, t_max)`` (JAX: ``<``, which can drop an equal-``t`` hit in a
  cluster not yet visited);
* the merge across rounds takes the lower row on equal ``t`` (JAX keeps the
  cluster visited first).

So the result depends neither on the cascade nor on the order the sort
gives equal keys. In float64 the JAX driver packs its entries rounded to
nearest into float32 and compares them with the bound rounded the same way,
so a rounded-up entry can stop a ray before the cluster that holds its hit;
the port packs the float64 bits themselves into int64 keys, truncated down
like the float32 ones, so the gate stays conservative in both types.

The round kernels' plain twins test each ray against the 256 rows of its
cluster in the kernels' op order (``shade._tri_hits``); the round wrappers
dispatch on the device (CPU: twin; CUDA: kernel or raise) and count each
launch in ``shade.LAUNCHES`` (a float64 instance under ``*_f64``).
"""

from __future__ import annotations

import torch

from .. import profiler
from ..models.scene import CLUSTER_SIZE
from .intersect import (
    _TRI_COLS,
    Tables,
    _check_rays,
    _check_route,
    _closest_out,
    _empty,
)
from .shade import _SUFFIX, LAUNCHES, _check, _tri_hits

_INF = float("inf")
# By key dtype (int32 from float32 entries, int64 from float64 ones): the
# bits of +inf (a cluster the segment misses), and the key of a visited
# cluster (above every bound once its id bits are stripped).
_KEY_DTYPE = {torch.float32: torch.int32, torch.float64: torch.int64}
_INF_BITS = {torch.int32: 0x7F800000, torch.int64: 0x7FF0000000000000}
_CLEARED = {torch.int32: 0x7FFFFFFF, torch.int64: 0x7FFFFFFFFFFFFFFF}
CASCADE_MIN = 4096          # waves from this size compact their live tail
_TWIN_RAYS = 4096           # rays per step of the round twins


def cluster_entries(o, d, t_min, t_max, boxes):
    """Conservative entry distance of each ray into each cluster box
    (``boxes`` ``(C, 8)`` rows ``[min | max | 0 0]``, or ``(N, C, 6)`` boxes
    of each ray's own): ``(N, C)``, +inf where the ``[t_min, t_max]`` segment
    misses the box or the box is inverted."""
    inv = 1.0 / torch.where(torch.abs(d) < 1e-20, 1e-20, d)
    lo, hi = boxes[..., 0:3], boxes[..., 3:6]
    a = (lo - o[:, None, :]) * inv[:, None, :]
    b = (hi - o[:, None, :]) * inv[:, None, :]
    tn = torch.maximum(torch.minimum(a, b).amax(dim=-1), t_min[:, None])
    tf = torch.minimum(torch.maximum(a, b).amin(dim=-1), t_max[:, None])
    valid = lo[..., 0] <= hi[..., 0]
    return torch.where((tn <= tf) & valid, tn, _INF)


def id_bits(n_clusters: int) -> int:
    """Low key bits that hold a cluster id in ``[0, n_clusters]``."""
    return max(1, n_clusters.bit_length())


def pack_keys(entries, n_clusters: int):
    """``(keys (N, C), idmask)``: each entry's bits as an integer of its
    width (int32 for float32 entries, int64 for float64: monotone for
    non-negative floats) with the low :func:`id_bits` bits replaced by the
    cluster id. The minimum key of a row is its nearest cluster, and its
    high bits a truncated-down (conservative) entry. In float64 the keys
    take twice the memory: 144 MB at 65,536 rays and 274 clusters."""
    idmask = (1 << id_bits(n_clusters)) - 1
    kdt = _KEY_DTYPE[entries.dtype]
    ids = torch.arange(entries.shape[1], dtype=kdt, device=entries.device)
    return (entries.contiguous().view(kdt) & ~idmask) | ids[None, :], idmask


def live_rays(kmin, idmask: int, bound=None):
    """Rays whose nearest unvisited cluster (minimum key ``kmin``) is
    entered, and entered no later than ``bound`` (``min(best_t, t_max)``,
    in the keys' float type, its bits compared exactly) when one is given:
    the truncated entry is ``<=`` the bound, so an equal-``t`` hit in that
    cluster is still found."""
    entry = kmin & ~idmask
    live = entry < _INF_BITS[kmin.dtype]
    if bound is not None:
        live &= entry <= bound.contiguous().view(kmin.dtype)
    return live


# ---------------------------------------------------------------------------
# The round kernels and their twins
# ---------------------------------------------------------------------------

def _check_round(tables, o, d, t_min, t_up, key):
    n, kind = _check_rays(o, d, t_min, t_up)
    _check_route(tables, "binned", t_min.device, o.dtype)
    _check("key", key, torch.int32, (n,))
    if key.device != t_min.device:
        raise ValueError(f"key on {key.device}, rays on {t_min.device}")
    return n, kind


def _cluster_rows(tables, key, a, b):
    """``(live, cluster, rows (256, 16, n))`` of rays ``a:b``: the rows of
    each ray's cluster, rays on the last axis (sentinel keys read cluster 0
    and are masked by ``live``)."""
    c = tables.leaf.shape[0]
    k = key[a:b].long()
    live = (k >= 0) & (k < c)
    k = torch.where(live, k, 0)
    rows = tables.tri.view(c, CLUSTER_SIZE, _TRI_COLS)[k].permute(1, 2, 0)
    return live, k, rows


def _split(x, a, b):
    return tuple(x[a:b, j] for j in range(3))


def round_closest_reference(tables: Tables, o, d, t_min, t_up, key):
    """Twin of :func:`round_closest`: per ray, the closest of the 256 rows
    of cluster ``key`` in ``[t_min, t_up]``, the lower row on equal ``t``;
    floats in the rays' dtype."""
    n = t_min.shape[0]
    t = torch.full((n,), _INF, dtype=o.dtype, device=o.device)
    idx = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    for a in range(0, n, _TWIN_RAYS):
        b = min(a + _TWIN_RAYS, n)
        live, k, rows = _cluster_rows(tables, key, a, b)
        ok, ts = _tri_hits(rows, _split(o, a, b), _split(d, a, b), t_up[a:b], t_min[a:b])
        t_c, arg = torch.min(torch.where(ok, ts, _INF)[:, 0, :], dim=0)   # first minimum
        hit = live & (t_c < _INF)
        t[a:b] = torch.where(hit, t_c, _INF)
        idx[a:b] = torch.where(hit, k * CLUSTER_SIZE + arg, -1)
    hit = idx >= 0
    row = tables.tri[idx.clamp_min(0)]
    normal = torch.where(hit[:, None], row[:, 9:12], 0.0)
    mat = torch.where(hit, row[:, 12].to(torch.int32), 0)
    return t, idx.to(torch.int32), normal, mat


def round_anyhit_reference(tables: Tables, o, d, t_min, t_max, key):
    """Twin of :func:`round_anyhit`: is any of the 256 rows of cluster
    ``key`` hit in ``[t_min, t_max]``."""
    n = t_min.shape[0]
    occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
    for a in range(0, n, _TWIN_RAYS):
        b = min(a + _TWIN_RAYS, n)
        live, _, rows = _cluster_rows(tables, key, a, b)
        ok, _ = _tri_hits(rows, _split(o, a, b), _split(d, a, b), t_max[a:b], t_min[a:b])
        occ[a:b] = live & ok[:, 0, :].any(dim=0)
    return occ


def round_closest(tables: Tables, o, d, t_min, t_up, key):
    """One round on a wave sorted by cluster: for each ray with ``key`` in
    ``[0, C)``, the closest hit among that cluster's 256 rows in ``[t_min,
    t_up]``: ``(t, row, outward normal, material)``; a miss or the sentinel
    key gives ``(inf, -1, 0, 0)``. Float32 or float64 rays and tables (the
    kernel's instance for the dtype). Counterpart of ``_run_round_closest``."""
    _, kind = _check_round(tables, o, d, t_min, t_up, key)
    if kind == "cpu":
        return round_closest_reference(tables, o, d, t_min, t_up, key)
    from ..kernels import binding

    out = _closest_out(o)
    binding.launch_binned_round_closest(tables, o, d, t_min, t_up, key, *out)
    LAUNCHES["binned_round_closest" + _SUFFIX[o.dtype]] += 1
    return out


def round_anyhit(tables: Tables, o, d, t_min, t_max, key):
    """One any-hit round: is any row of each ray's cluster hit in ``[t_min,
    t_max]`` (false for the sentinel key). Counterpart of
    ``_run_round_anyhit``."""
    n, kind = _check_round(tables, o, d, t_min, t_max, key)
    if kind == "cpu":
        return round_anyhit_reference(tables, o, d, t_min, t_max, key)
    from ..kernels import binding

    occ = _empty((n,), torch.bool, o)
    binding.launch_binned_round_anyhit(tables, o, d, t_min, t_max, key, occ)
    LAUNCHES["binned_round_anyhit" + _SUFFIX[o.dtype]] += 1
    return occ


# ---------------------------------------------------------------------------
# The drivers
# ---------------------------------------------------------------------------

def _initial_state(tables, o, d, t_min, t_max):
    _check_rays(o, d, t_min, t_max)
    _check_route(tables, "binned", t_min.device, o.dtype)
    n_clusters = tables.leaf.shape[0]
    keys, idmask = pack_keys(cluster_entries(o, d, t_min, t_max, tables.leaf), n_clusters)
    st = dict(o=o, d=d, t_min=t_min, t_max=t_max, keys=keys, kmin=keys.amin(dim=1))
    return st, idmask, n_clusters


def _sorted_wave(st, live, n_live, idmask, n_clusters):
    """``(perm, key)``: the live rays in order of their round cluster (the
    first ``n_live`` of the wave sorted by key, dead rays keyed ``C``), the
    key an int32 cluster id whatever the keys' width."""
    keyr = torch.where(live, (st["kmin"] & idmask).to(torch.int32), n_clusters)
    key, perm = torch.sort(keyr)
    return perm[:n_live], key[:n_live].contiguous()


def _traverse(st, live_of, step, results, stats):
    """Rounds until no ray is live, with the JAX cascade: below a quarter
    (then a sixteenth) of the original wave, the live rays move into a
    compacted state and their results are scattered back at the end."""
    n = st["o"].shape[0]
    stops = [n // 4, n // 16] if n // 4 >= CASCADE_MIN else [n // 4] if n >= CASCADE_MIN else []

    def phase(st, stop_below):
        while True:
            live = live_of(st)
            with profiler.span("sync.binned_live"):
                n_live = int(live.sum())        # the round's one host sync
            if n_live <= stop_below:
                return live
            step(st, live, n_live)
            st["keys"] = torch.where(live[:, None] & (st["keys"] == st["kmin"][:, None]),
                                     _CLEARED[st["keys"].dtype], st["keys"])
            st["kmin"] = st["keys"].amin(dim=1)
            if stats is not None:
                stats["rounds"] = stats.get("rounds", 0) + 1
                stats["ray_rounds"] = stats.get("ray_rounds", 0) + n_live

    def run(st, stops):
        if not stops:
            phase(st, 0)
            return
        live = phase(st, stops[0])
        with profiler.span("sync.binned_compact"):
            idx = torch.nonzero(live).squeeze(1)
        sub = {k: v[idx] for k, v in st.items()}
        run(sub, stops[1:])
        for k in results:
            st[k][idx] = sub[k]

    run(st, stops)


def triangle_closest_binned(tables: Tables, o, d, t_min, t_max, *, round_twin: bool = False,
                            stats: dict | None = None):
    """Closest triangle hit by per-ray binned traversal on the binned route's
    tables: ``(t (N,), row (N,) int32, outward normal (N, 3), material (N,)
    int32)``; a miss is ``(inf, -1, 0, 0)``; floats in the rays' dtype
    (float32 or float64). Equals ``intersect.triangle_closest_reference``.
    ``round_twin=True`` runs the round twin on any device (for checking the
    kernel); ``stats`` gathers ``rounds`` and ``ray_rounds`` (rays tested,
    summed over rounds)."""
    st, idmask, n_clusters = _initial_state(tables, o, d, t_min, t_max)
    n = o.shape[0]
    st.update(best_t=torch.full((n,), _INF, dtype=o.dtype, device=o.device),
              best_i=torch.full((n,), -1, dtype=torch.int32, device=o.device),
              best_n=torch.zeros((n, 3), dtype=o.dtype, device=o.device),
              best_m=torch.zeros((n,), dtype=torch.int32, device=o.device))
    round_fn = round_closest_reference if round_twin else round_closest

    def live_of(st):
        return live_rays(st["kmin"], idmask, torch.minimum(st["best_t"], st["t_max"]))

    def step(st, live, n_live):
        bound = torch.minimum(st["best_t"], st["t_max"])
        perm, key = _sorted_wave(st, live, n_live, idmask, n_clusters)
        rt, ri, rn, rm = round_fn(tables, st["o"][perm], st["d"][perm], st["t_min"][perm],
                                  bound[perm], key)
        bt, bi = st["best_t"][perm], st["best_i"][perm]
        better = (rt < bt) | ((rt == bt) & (ri < bi))     # ties to the lower row
        st["best_t"][perm] = torch.where(better, rt, bt)
        st["best_i"][perm] = torch.where(better, ri, bi)
        st["best_n"][perm] = torch.where(better[:, None], rn, st["best_n"][perm])
        st["best_m"][perm] = torch.where(better, rm, st["best_m"][perm])

    _traverse(st, live_of, step, ("best_t", "best_i", "best_n", "best_m"), stats)
    return st["best_t"], st["best_i"], st["best_n"], st["best_m"]


def triangle_anyhit_binned(tables: Tables, o, d, t_min, t_max, *, round_twin: bool = False,
                           stats: dict | None = None):
    """Occlusion by any triangle in ``[t_min, t_max]`` by per-ray binned
    traversal, nearest cluster first, a ray settled at its first hit: bool
    ``(N,)``. Equals ``intersect.bvh_anyhit_reference``; ``round_twin`` and
    ``stats`` as in :func:`triangle_closest_binned`."""
    st, idmask, n_clusters = _initial_state(tables, o, d, t_min, t_max)
    st["occ"] = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    round_fn = round_anyhit_reference if round_twin else round_anyhit

    def live_of(st):
        return ~st["occ"] & live_rays(st["kmin"], idmask)

    def step(st, live, n_live):
        perm, key = _sorted_wave(st, live, n_live, idmask, n_clusters)
        st["occ"][perm] = st["occ"][perm] | round_fn(
            tables, st["o"][perm], st["d"][perm], st["t_min"][perm], st["t_max"][perm], key)

    _traverse(st, live_of, step, ("occ",), stats)
    return st["occ"]
