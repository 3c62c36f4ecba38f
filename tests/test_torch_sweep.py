"""The split sweep of the pool's two kernels, held on the CPU.

``csrc/fused_bounce.cu`` and ``csrc/shadow_any_hit.cu`` split each lane's
row sweep over ``split`` threads: thread j of a lane's group tests rows j,
j + T, j + 2T, ... and keeps its strict first minimum of the screened t
(``t`` where ``eps <= t <= cap``, else inf) from ``(inf, 0)``; the group
combines its threads' bests by a butterfly of warp shuffles as a
lexicographic min over ``(t, row)``. The any hit ORs its threads' hits,
voting after every few rows. A CUDA kernel cannot run here, so the models
below follow those rules step for step in plain Python and are held against
the twins' argmin (``torch.min``, first minimum) and ``any``, exactly, on
rows with ties, misses and NaN padding; then the host's choice of the split
and the block shape (``kernels/binding.py``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pathtrace_tpu_torch.kernels import binding  # noqa: E402
from pathtrace_tpu_torch.models import scenes  # noqa: E402
from pathtrace_tpu_torch.models.materials import Emissive, Lambertian, Mirror  # noqa: E402
from pathtrace_tpu_torch.models.scene import SceneBuilder  # noqa: E402
from pathtrace_tpu_torch.ops import shade  # noqa: E402

INF = float("inf")
SPLITS_MODELLED = (1, 4, 8, 16, 32)
CHECK = 4   # rows a thread tests between two votes (shadow_any_hit.cu kCheck)


def split_argmin(t, cap, eps, split):
    """The kernels' split closest-hit sweep over one lane's raw row values
    ``t`` (NaN on a miss or a padding row): each thread's strict first
    minimum of the screened value from ``(inf, 0)``, then the butterfly of
    ``group_min``. Returns every thread's ``(t, row)`` after the combine."""
    best = []
    for j in range(split):
        bt, br = INF, 0
        for r in range(j, len(t), split):
            v = t[r] if (t[r] >= eps and t[r] <= cap) else INF   # NaN fails both
            if v < bt:
                bt, br = v, r
        best.append((bt, br))
    off = split // 2
    while off > 0:
        nxt = []
        for j in range(split):
            (bt, br), (ot, orow) = best[j], best[j ^ off]
            nxt.append((ot, orow) if (ot < bt or (ot == bt and orow < br)) else (bt, br))
        best = nxt
        off //= 2
    return best


def split_any(hits, split, check=CHECK):
    """The split any-hit sweep: thread j tests rows j + c * T of each chunk of
    ``check * T`` rows and the group leaves at the first vote that sees a hit."""
    n = len(hits)
    for base in range(0, n, check * split):
        rows = [base + c * split + j for j in range(split) for c in range(check)]
        if any(hits[r] for r in rows if r < n):
            return True
    return False


def _lanes(n_rows, n_lanes, seed):
    """Rays against ``n_rows`` random spheres with repeated rows (equal t),
    rays that miss everything, and the NaN padding rows of ``build_tables``."""
    g = np.random.default_rng(seed)
    b = SceneBuilder("cpu")
    sph = [(tuple(g.uniform(-5, 5, 3)), float(g.uniform(0.3, 1.0))) for _ in range(n_rows)]
    repeated = list(range(0, n_rows - 17, 5))
    for a in repeated:                        # repeats at distances 1, 3, 8, 16
        sph[a + (1, 3, 8, 16)[a % 4]] = sph[a]
    for c, r in sph:
        b.add_sphere(c, r, Lambertian((0.5, 0.5, 0.5)))
    b.add_triangle((-9, -9, 9), (9, -9, 9), (0, 9, 9), Emissive((1.0, 1.0, 1.0)))
    tables = shade.build_tables(b.build())
    # Each ray starts just outside a repeated sphere (most then hit it first).
    pick = [sph[repeated[k]] for k in g.integers(0, len(repeated), n_lanes)]
    dirs = g.normal(size=(n_lanes, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    o = np.array([c for c, _ in pick]) + (np.array([r for _, r in pick]) + 0.05)[:, None] * dirs
    d = np.where((np.arange(n_lanes) % 4 == 3)[:, None], dirs, -dirs)   # a quarter miss
    o3 = tuple(torch.tensor(o[:, k], dtype=torch.float32) for k in range(3))
    d3 = tuple(torch.tensor(d[:, k], dtype=torch.float32) for k in range(3))
    return tables, shade._sphere_ts(tables.sph, o3, d3, shade.EPS)


@pytest.mark.parametrize("n_rows", [37, 96, 488])
def test_split_combine_is_the_twins_argmin(n_rows):
    """At every split, every thread of the group ends with the twin's
    ``torch.min`` value and first-minimum row, (inf, 0) on a miss; the
    padded row counts (40, 96, 488) leave some splits' last threads short."""
    tables, ts = _lanes(n_rows, 96, seed=n_rows)
    n_pad = tables.sph.shape[0] - n_rows
    assert torch.isnan(ts[n_rows:]).all() and (n_pad > 0) == (n_rows % 8 != 0)
    for cap in (INF, 6.0):
        screened = torch.where((ts >= shade.EPS) & (ts <= cap), ts, INF)
        ref_t, ref_row = torch.min(screened, dim=0)
        ties = ((screened == ref_t) & torch.isfinite(ref_t)).sum(0) > 1
        assert ties.any() and torch.isinf(ref_t).any() and torch.isfinite(ref_t).any()
        for split in SPLITS_MODELLED:
            for lane in range(ts.shape[1]):
                want = (float(ref_t[lane]), int(ref_row[lane]))
                got = split_argmin(ts[:, lane].tolist(), cap, shade.EPS, split)
                assert all(g == want for g in got), (split, lane, want, got)


def test_split_combine_ties_go_to_the_lower_row():
    nan = math.nan
    t = [nan, 2.0, 5.0, 2.0, 0.0, 2.0, INF, nan, 2.0]
    for split in SPLITS_MODELLED:
        assert set(split_argmin(t, INF, 1e-3, split)) == {(2.0, 1)}
        assert set(split_argmin(t, 1.5, 1e-3, split)) == {(INF, 0)}   # nothing below the cap
        assert set(split_argmin([nan] * 5, INF, 1e-3, split)) == {(INF, 0)}


@pytest.mark.parametrize("n_rows", [37, 488])
def test_split_any_hit_is_the_twins_any(n_rows):
    tables, ts = _lanes(n_rows, 64, seed=7 + n_rows)
    for cap in (2.0, 12.0, INF):
        hits = (ts >= shade.EPS) & (ts <= cap)
        want = hits.any(0)
        assert want.any() and not want.all()
        for split in SPLITS_MODELLED:
            got = [split_any(hits[:, lane].tolist(), split) for lane in range(ts.shape[1])]
            assert got == want.tolist(), split


def _on_pbr_tables():
    """The ON/PBR scene's tables (chip_smoke.py's phase 3e scene)."""
    import chip_smoke

    return shade.build_tables(chip_smoke.on_pbr_scene("cpu"))


def test_host_split_and_block_shape():
    for split in binding.SPLITS:
        lanes, threads = binding.launch_shape(split)
        assert lanes % 32 == 0 and threads == lanes * split <= 512
    with pytest.raises(ValueError, match="split"):
        binding.launch_shape(32)
    on_pbr = _on_pbr_tables()
    many = shade.build_tables(scenes.many_spheres(device="cpu"))
    cornell = shade.build_tables(scenes.cornell_box(device="cpu"))
    rows = {k: t.sph.shape[0] + t.tri.shape[0]
            for k, t in (("on_pbr", on_pbr), ("many", many), ("cornell", cornell))}
    assert rows == {"on_pbr": 16, "many": 496, "cornell": 24}
    fused, shadow = "fused_bounce", "shadow_any_hit"
    for k in (fused, shadow):                # 8 primitives: no split
        assert binding._shape(on_pbr, None, k) == binding._shape(cornell, None, k) == (1, 128)
    assert binding._shape(many, None, fused) == (4, 32)       # 124 rows a thread
    assert binding._shape(many, None, shadow) == (16, 32)     # 31 rows a thread
    assert binding._shape(many, 2, shadow) == (2, 64)
    assert [binding.sweep_split(n, shadow) for n in (32, 33, 64, 65, 512, 4096)] == \
        [1, 2, 2, 4, 16, 16]


def test_shared_bytes_within_the_limit():
    """At the kernels' caps (512 spheres, 64 triangles, 64 lights) and for
    the ON/PBR scene, every split's block stays under the 48 KB that needs
    no opt-in; past the caps the binding refuses."""
    caps = shade.Tables(sph=torch.zeros((shade.MAX_SPHERES, 15)),
                        tri=torch.zeros((shade.MAX_TRIS, 22)),
                        lgt=torch.zeros((shade.MAX_LIGHTS, 18)))
    on_pbr = _on_pbr_tables()
    for split in binding.SPLITS:
        lanes, _ = binding.launch_shape(split)
        assert binding._shape(caps, split, "fused_bounce") == (split, lanes)
        at_caps = binding.shared_bytes(512, 64, 64, lanes)
        assert at_caps == 512 * 16 + 64 * 36 + 64 * 72 + lanes * 16 <= binding.SHARED_LIMIT
        assert binding.shared_bytes(512, 64) < at_caps
        small = binding.shared_bytes(on_pbr.sph.shape[0], on_pbr.tri.shape[0],
                                     on_pbr.lgt.shape[0], lanes)
        assert small == 8 * 16 + 8 * 36 + 8 * 72 + lanes * 16
    huge = caps._replace(sph=torch.zeros((4096, 15)))
    with pytest.raises(ValueError, match="shared memory"):
        binding._shape(huge, 8, "shadow_any_hit")


def test_wrappers_leave_the_split_to_the_kernels():
    """On CPU tensors the wrappers run the twins, whatever the scene's split;
    a repeated sphere row with another material changes nothing when it
    comes after the first (the lower row wins the tie)."""
    b = SceneBuilder("cpu")
    b.add_sphere((0.0, 0.0, -3.0), 1.0, Lambertian((0.8, 0.1, 0.1)))
    b.add_sphere((0.0, 0.0, -3.0), 1.0, Mirror(roughness=0.2, metallic=1.0))
    b.add_sphere((0.0, 4.0, -3.0), 0.5, Emissive((5.0, 5.0, 5.0)))
    one = SceneBuilder("cpu")
    one.add_sphere((0.0, 0.0, -3.0), 1.0, Lambertian((0.8, 0.1, 0.1)))
    one.add_sphere((0.0, 0.0, 30.0), 1.0, Mirror(roughness=0.2, metallic=1.0))
    one.add_sphere((0.0, 4.0, -3.0), 0.5, Emissive((5.0, 5.0, 5.0)))
    S = 64
    g = np.random.default_rng(3)
    d = np.stack([g.uniform(-0.2, 0.2, S), g.uniform(-0.2, 0.2, S), -np.ones(S)])
    d /= np.linalg.norm(d, axis=0)
    batch = [torch.ones(S, dtype=torch.bool), torch.zeros(S, dtype=torch.int32),
             torch.zeros((3, S)), torch.tensor(d, dtype=torch.float32), torch.ones(S),
             torch.ones(S), torch.ones((3, S)), torch.tensor(g.random((9, S)), dtype=torch.float32)]
    outs = []
    for builder in (b, one):
        sc = builder.build()
        kw = dict(num_tris=sc.tri_v0.shape[0], num_lights=sc.num_lights, integrator="mis",
                  max_bounces=8, has_tri_lights=sc.has_tri_lights,
                  has_sph_lights=sc.has_sph_lights)
        outs.append(shade.fused_bounce(shade.build_tables(sc), *batch, **kw))
    assert outs[0].shade.sum() > S // 2
    for a, c in zip(*outs):
        assert torch.equal(a, c)
