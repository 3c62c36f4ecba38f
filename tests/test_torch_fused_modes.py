"""The two modes of ``fused_bounce``: the raygen mode
(``fused_bounce(raygen=...)``, which the pool's fused branch runs) and the
fused NEE shadow sweep (``fused_bounce(fuse_shadow=True)``).

The port's twins run against the JAX kernel in interpret mode (as
``tests/test_torch_shade.py`` runs it), on lane states made with numpy from
a seed at S = 1024, and against the port's own split compositions, which
they must equal bit for bit on the CPU. Tolerances, and why:

* fused shadow against JAX, Cornell: ``tests/test_torch_shade.py``'s Cornell
  bounds (discrete outputs exact; floats to rtol 1e-4 / atol 1e-5;
  ``next_pdf`` to rtol 1e-3 with at most 1% of lanes past 1e-4, the glass
  Jacobian); many_spheres(n_per_side=3): its many_spheres bounds (discrete
  outputs on >= 99.9% of lanes, the 99th percentile of the relative error
  <= 1e-3). ``nee_gain`` is zero in both.
* raygen against JAX, Cornell with ~40% of the lanes started on real
  pixels: XLA on the CPU contracts the camera's multiply-adds into FMAs, so
  the started lanes' rays differ from the port's in the last bits, and every
  output after them follows. Discrete outputs and ``next_eta`` are exact;
  every float meets the Cornell bound (rtol 1e-4 / atol 1e-5) on each lane
  but the live lanes that hit the glass sphere (``next_eta`` 1/1.5 or 1.5),
  where refraction amplifies those bits: there rtol 5e-3 / atol 1e-4, on at
  most 3% of all lanes past the Cornell bound (measured: ``next_pdf`` on
  19 of 1,024 lanes, worst 2.3e-3 relative; one ``next_d`` and one
  ``shadow_d``, 4.0e-5 and 3.0e-5).
* the port's modes against its split compositions, float32 and float64:
  bitwise (NaNs equal). The raygen mode runs ``Camera.generate_rays``' op
  sequence and the pool's merges; the fused sweep is ``shadow_any_hit``'s
  test on the same rays, and its gain the one the pool adds.
* the pool (raygen) against its split path (``chip_smoke.split_pool``:
  ``generate_rays``, the merges and the default instance, as the pool ran
  before): image, rays and iterations bitwise; against the JAX pool under
  ``PT_RAYGEN_FUSION=1``: rays and iterations equal, the image within
  ``tests/imgutil.py``'s budget.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu import pool as jax_pool  # noqa: E402
from pathtrace_tpu.models import scenes as jax_scenes  # noqa: E402
from pathtrace_tpu.ops import pallas_shade  # noqa: E402
from pathtrace_tpu.ops.intersect import set_default_method  # noqa: E402
from pathtrace_tpu_torch import pool  # noqa: E402
from pathtrace_tpu_torch.convert import (  # noqa: E402
    camera_from_arrays,
    scene_from_arrays,
    split_fields,
)
from pathtrace_tpu_torch.kernels import binding  # noqa: E402
from pathtrace_tpu_torch.models import scenes  # noqa: E402
from pathtrace_tpu_torch.ops import shade  # noqa: E402
from pathtrace_tpu_torch.render import cast_floats  # noqa: E402

from .imgutil import assert_images_match  # noqa: E402
from .test_torch_shade import (  # noqa: E402
    FLOAT_FIELDS,
    SCENES,
    _assert_close_cornell_bounds,
    _consumed,
    _lanes,
    _on_pbr_scene,
)

S = 1024
CAM = 16                      # the Cornell camera's width and height for raygen lanes


def _port_scene(name):
    build, kw, lo, hi = SCENES[name]
    jsc = build(**kw)
    return jsc, scene_from_arrays(*split_fields(jsc), device="cpu"), lo, hi


def _kw(tsc, integrator, max_bounces=6):
    return dict(num_tris=tsc.tri_v0.shape[0], num_lights=tsc.num_lights,
                integrator=integrator, max_bounces=max_bounces,
                has_tri_lights=tsc.has_tri_lights, has_sph_lights=tsc.has_sph_lights,
                has_oren_nayar=tsc.has_oren_nayar, has_pbr=tsc.has_pbr)


def _jax_bounce(jsc, args, integrator, **mode):
    return pallas_shade.fused_bounce(
        pallas_shade.build_tables(jsc), *(jnp.asarray(a) for a in args),
        num_tris=jsc.tri_v0.shape[0], num_lights=jsc.num_lights,
        integrator=integrator, max_bounces=6, eps=shade.EPS,
        has_on=jsc.has_oren_nayar, has_pbr=jsc.has_pbr,
        has_tri_lights=jsc.has_tri_lights, has_sph_lights=jsc.has_sph_lights,
        transposed=True, interpret=True, **mode)


def _bitwise(got, want):
    for field, a, b in zip(shade.BounceResult._fields, got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=field)


def _split_with_shadow(tables, args, kw):
    """The split twin and the pool's composition of its outputs with the
    shadow twin: ``(result, rad_delta + visible NEE gain, blocked)``."""
    res = shade.fused_bounce_reference(tables, *args, **kw)
    occ = shade.shadow_any_hit_reference(tables, res.next_o, res.shadow_d, res.shadow_tmax)
    return res, res.rad_delta + torch.where(res.live & ~occ, res.nee_gain, 0.0), occ


# ---------------------------------------------------------------------------
# (a), (b): the fused shadow sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cornell", "many"])
@pytest.mark.parametrize("integrator", ["mis", "nee"])
def test_fused_shadow_twin_matches_jax(name, integrator):
    """(a) The fused-shadow twin against the JAX kernel's ``fuse_shadow``."""
    jsc, tsc, lo, hi = _port_scene(name)
    args = _lanes(0, lo, hi)
    ref = _jax_bounce(jsc, args, integrator, fuse_shadow=True)
    targs = [torch.from_numpy(a) for a in args]
    tables = shade.build_tables(tsc)
    got = shade.fused_bounce_reference(tables, *targs, fuse_shadow=True, **_kw(tsc, integrator))
    _, _, occ = _split_with_shadow(tables, targs, _kw(tsc, integrator))
    assert int((got.live & occ).sum()) > 0                    # some live lanes blocked
    assert not got.nee_gain.any() and not np.asarray(ref.nee_gain).any()
    if name == "cornell":
        _assert_close_cornell_bounds(ref, got)
        return
    for field in ("live", "shade"):
        agree = getattr(got, field).numpy() == np.asarray(getattr(ref, field))
        assert agree.mean() >= 0.999, field
    errs = []
    for field in FLOAT_FIELDS:
        a, b = _consumed(ref, got, field)
        assert np.isfinite(b).all(), field
        errs.append((np.abs(b - a) / np.maximum(np.abs(a), 1.0)).ravel())
    assert np.quantile(np.concatenate(errs), 0.99) <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["cornell", "many", "on_pbr"])
def test_fused_shadow_twin_equals_split_pair(name, dtype):
    """(b) ``rad_delta`` of the fused sweep is the split twin's plus its gain
    where ``shadow_any_hit_reference`` finds the live lane's shadow ray free,
    bit for bit; ``nee_gain`` is zero and every other output the split
    twin's, ``shadow_d``/``shadow_tmax`` included."""
    _, tsc, lo, hi = _port_scene(name)
    tsc = cast_floats(tsc, dtype)
    tables = shade.build_tables(tsc)
    args = [torch.from_numpy(a) for a in _lanes(3, lo, hi)]
    args = [a.to(dtype) if a.is_floating_point() else a for a in args]
    for integrator in ("mis", "nee", "brdf_only"):
        kw = _kw(tsc, integrator)
        split, rad, occ = _split_with_shadow(tables, args, kw)
        got = shade.fused_bounce_reference(tables, *args, fuse_shadow=True, **kw)
        assert got.rad_delta.dtype == dtype
        want = split._replace(rad_delta=rad, nee_gain=torch.zeros_like(split.nee_gain))
        _bitwise(got, want)
        if integrator != "brdf_only":
            assert int((split.live & occ & split.nee_gain.ne(0).any(0)).sum()) > 0
            assert not torch.equal(got.rad_delta, split.rad_delta)


# ---------------------------------------------------------------------------
# (c), (d): the raygen mode
# ---------------------------------------------------------------------------

def _raygen_lanes(seed=0, n=S):
    """Cornell lane states with ~40% of the lanes started on real pixels of a
    16x16 camera: the carried state (random), the merged busy/bounce, and the
    raygen tuple's started flags and pixels (py flipped)."""
    _, _, lo, hi = SCENES["cornell"]
    busy, bounce, o, d, eta, pdf, pfx, u = _lanes(seed, lo, hi, n)
    g = np.random.default_rng(seed + 100)
    started = g.random(n) < 0.4
    pixel = g.integers(0, CAM * CAM, n)
    px = (pixel % CAM).astype(np.int32)
    py = ((CAM - 1) - pixel // CAM).astype(np.int32)
    busy = busy | started
    bounce = np.where(started, 0, bounce).astype(np.int32)
    return (busy, bounce, o, d, eta, pdf, pfx, u), (started, px, py)


def _cam_row_jax(jcam):
    """``pathtrace_tpu/pool.py``'s packing of the camera."""
    dtype = jcam.origin.dtype
    return jnp.stack([
        jnp.concatenate([jcam.origin, jcam.lower_left_corner,
                         jnp.asarray([jcam.width - 1, jcam.height - 1], dtype)]),
        jnp.concatenate([jcam.horizontal, jcam.vertical, jnp.zeros((2,), dtype)]),
    ])


@pytest.mark.parametrize("integrator", ["mis"])
def test_raygen_twin_matches_jax(integrator):
    """(c) The raygen twin against the JAX kernel's raygen mode."""
    jsc, tsc, _, _ = _port_scene("cornell")
    jcam = jax_scenes.cornell_camera(CAM, CAM)
    args, (started, px, py) = _raygen_lanes()
    cam_row = pool.camera_row(camera_from_arrays(*split_fields(jcam), device="cpu"))
    np.testing.assert_array_equal(cam_row.numpy(), np.asarray(_cam_row_jax(jcam)))
    ref = _jax_bounce(jsc, args, integrator, raygen=(
        jnp.asarray(started), jnp.asarray(px), jnp.asarray(py), _cam_row_jax(jcam)))
    got = shade.fused_bounce_reference(
        shade.build_tables(tsc), *(torch.from_numpy(a) for a in args),
        raygen=(torch.from_numpy(started), torch.from_numpy(px), torch.from_numpy(py), cam_row),
        **_kw(tsc, integrator))
    live = np.asarray(ref.live)
    for field in ("live", "shade", "next_eta"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)
    eta = got.next_eta.numpy()
    glass = live & (np.isclose(eta, 1.5) | np.isclose(eta, 1 / 1.5))
    assert glass.sum() > 20
    past = np.zeros(S, bool)
    for field in FLOAT_FIELDS:
        a, b = (np.asarray(getattr(ref, field)), getattr(got, field).numpy())
        lanes = live if field in ("nee_gain", "shadow_d") else np.ones(S, bool)
        a, b = a.reshape(-1, S), b.reshape(-1, S)
        out = (~np.isclose(b, a, rtol=1e-4, atol=1e-5)).any(0) & lanes
        assert not (out & ~glass).any(), (field, np.nonzero(out & ~glass))
        np.testing.assert_allclose(b[:, glass], a[:, glass], rtol=5e-3, atol=1e-4,
                                   err_msg=field)
        past |= out
    assert past.mean() <= 0.03
    # A started lane that does not live on keeps its merged ray: the camera's.
    kept = started & ~np.asarray(ref.live)
    assert kept.sum() > 0
    np.testing.assert_array_equal(got.next_o.numpy()[:, kept],
                                  np.repeat(cam_row.numpy()[0, :3, None], kept.sum(), 1))
    np.testing.assert_array_equal(got.next_pdf.numpy()[kept], 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["cornell", "on_pbr"])
def test_raygen_twin_equals_split_path(name, dtype):
    """(d) The raygen twin is the pool's split path, ``Camera.generate_rays``
    and the five merges then the split twin, bit for bit."""
    _, tsc, _, _ = _port_scene(name)
    camera = (scenes.cornell_camera(CAM, CAM, "cpu") if name == "cornell"
              else scenes.default_spheres_camera(CAM, CAM, "cpu"))
    tsc, camera = cast_floats(tsc, dtype), cast_floats(camera, dtype)
    tables = shade.build_tables(tsc)
    args, (started, px, py) = _raygen_lanes(seed=5)
    busy, bounce, o, d, eta, pdf, pfx, u = [
        torch.from_numpy(a).to(dtype) if a.dtype.kind == "f" else torch.from_numpy(a)
        for a in args]
    started, px, py = (torch.from_numpy(a) for a in (started, px, py))
    jitter = torch.stack([u[7], u[8]], dim=1)
    cam_o, cam_d = camera.generate_rays(px.long(), py.long(), jitter)
    merged = [busy, bounce, torch.where(started, cam_o, o), torch.where(started, cam_d, d),
              torch.where(started, 1.0, eta), torch.where(started, 1.0, pdf),
              torch.where(started, 1.0, pfx), u]
    raygen = (started, px, py, pool.camera_row(camera))
    for integrator in ("mis", "brdf_only"):
        kw = _kw(tsc, integrator)
        for fuse_shadow in (False, True):
            want = shade.fused_bounce_reference(tables, *merged, fuse_shadow=fuse_shadow, **kw)
            got = shade.fused_bounce_reference(tables, busy, bounce, o, d, eta, pdf, pfx, u,
                                               raygen=raygen, fuse_shadow=fuse_shadow, **kw)
            assert got.next_o.dtype == dtype
            _bitwise(got, want)
        assert int((started & want.shade).sum()) > 50


# ---------------------------------------------------------------------------
# (e), (f): the raygen pool
# ---------------------------------------------------------------------------

CORNELL_POOL = dict(width=16, height=16, spp=2, integrator="mis", max_bounces=6,
                    num_slots=64, seed=5)


@pytest.mark.parametrize("name,dtype", [("cornell", torch.float32), ("on_pbr", torch.float32),
                                        ("cornell", torch.float64)])
def test_raygen_pool_equals_split_pool(name, dtype):
    """(e) ``render_pool``, whose fused branch makes its rays in the kernel,
    renders the split path's frame (``chip_smoke.split_pool``) bit for bit,
    with its rays and iterations; each way runs the kernel instance it
    names, the twin here."""
    if name == "cornell":
        sc, cam = scenes.cornell_box(device="cpu"), scenes.cornell_camera(16, 16, "cpu")
        kw = CORNELL_POOL
    else:
        sc = scene_from_arrays(*split_fields(_on_pbr_scene()), device="cpu")
        cam = scenes.default_spheres_camera(16, 16, "cpu")
        kw = dict(CORNELL_POOL, max_bounces=6, seed=3)
    sc, cam = cast_floats(sc, dtype), cast_floats(cam, dtype)
    assert pool.route(sc, "mis") == "fused"
    calls = []
    kernel = shade.fused_bounce_reference

    def twin(*args, raygen=None, **kwargs):
        calls.append(raygen is not None)
        return kernel(*args, raygen=raygen, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(shade, "fused_bounce_reference", twin)
        with chip_smoke.split_pool(cam):
            img, counters, iters = pool.render_pool(sc, cam, **kw)
        assert calls and not any(calls)
        calls.clear()
        rimg, rcounters, riters = pool.render_pool(sc, cam, **kw)
        assert calls and all(calls)
    assert rimg.dtype == dtype
    assert torch.equal(rimg, img) and torch.equal(rcounters, counters) and riters == iters
    assert pool.ray_count(counters) > 1000


def test_raygen_pool_matches_jax_raygen_pool(monkeypatch):
    """(f) Against the JAX pool with its raygen fusion on
    (``PT_RAYGEN_FUSION=1``, read when ``render_pool`` is traced, so the
    caches are cleared around it)."""
    jsc, jcam = jax_scenes.cornell_box(), jax_scenes.cornell_camera(16, 16)
    monkeypatch.setenv("PT_RAYGEN_FUSION", "1")
    jax.clear_caches()
    set_default_method("pallas_interpret")
    try:
        img, counters, iters = jax_pool.render_pool(jsc, jcam, **CORNELL_POOL)
        img = np.asarray(img)
    finally:
        set_default_method(None)
        jax.clear_caches()
    timg, tcounters, titers = pool.render_pool(
        scene_from_arrays(*split_fields(jsc), device="cpu"),
        camera_from_arrays(*split_fields(jcam), device="cpu"), **CORNELL_POOL)
    assert (jax_pool.ray_count(counters), int(iters)) == (3568, 48)
    assert (pool.ray_count(tcounters), titers) == (3568, 48)
    assert pool.busy_count(tcounters) == jax_pool.busy_count(counters)
    assert_images_match(timg.numpy(), img)


# ---------------------------------------------------------------------------
# (h): the wrapper and the binding
# ---------------------------------------------------------------------------

def _small_call(n=64):
    tsc = scenes.cornell_box(device="cpu")
    tables = shade.build_tables(tsc)
    args, (started, px, py) = _raygen_lanes(seed=1, n=n)
    args = [torch.from_numpy(a) for a in args]
    raygen = (torch.from_numpy(started), torch.from_numpy(px), torch.from_numpy(py),
              pool.camera_row(scenes.cornell_camera(CAM, CAM, "cpu")))
    return tables, args, raygen, _kw(tsc, "mis")


def test_wrapper_rejects_malformed_raygen():
    """(h) The wrapper checks the raygen tuple's dtypes, shapes, layout and
    device before running anything; well-formed, it runs the twin on the CPU
    (no launch counted)."""
    tables, args, raygen, kw = _small_call()
    started, px, py, cam = raygen
    bad = {
        "a 3-tuple": raygen[:3],
        "px int64": (started, px.long(), py, cam),
        "py float": (started, px, py.float(), cam),
        "started uint8": (started.to(torch.uint8), px, py, cam),
        "short started": (started[:-1], px, py, cam),
        "cam_row float64": (started, px, py, cam.double()),
        "cam_row (8, 2)": (started, px, py, cam.T.contiguous()),
        "cam_row not contiguous": (started, px, py, cam.T.contiguous().T),
        "pixels on meta": (started, px.to("meta"), py, cam),
    }
    for what, rg in bad.items():
        with pytest.raises(ValueError):
            shade.fused_bounce(tables, *args, raygen=rg, **kw)
    shade.LAUNCHES.clear()
    for fuse_shadow in (False, True):
        got = shade.fused_bounce(tables, *args, raygen=list(raygen), fuse_shadow=fuse_shadow,
                                 **kw)
        _bitwise(got, shade.fused_bounce_reference(tables, *args, raygen=raygen,
                                                   fuse_shadow=fuse_shadow, **kw))
    assert not shade.LAUNCHES


def _c_params(name):
    """ctypes types of ``extern "C" int name(...)`` in ``csrc/fused_bounce.cu``."""
    src = (Path(binding.__file__).parent.parent / "csrc" / "fused_bounce.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)[1].split(",")
    return [binding._P if "*" in p else binding._F if "float " in p else
            binding._D if "double " in p else binding._I for p in params]


class _Lib:
    """A mock kernel library: each entry point records its arguments."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        calls = self.calls.setdefault(name, [])

        class Fn:
            def __call__(self, *args):
                calls.append(args)
                return 0
        fn = Fn()
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launcher_picks_the_mode_instance(dtype, monkeypatch):
    """Through a mock kernel library and a wrapper that takes the CPU tensors
    for the card's: the declared argument types match the C signatures, the
    raygen pointers and the two mode flags reach the entry point (null
    pointers without raygen), the fused-shadow instance's shared memory is
    counted, and each mode's launch is counted under its own name."""
    tables, args, raygen, kw = _small_call()
    if dtype == torch.float64:
        tables = shade.Tables(*(t.double() for t in tables))
        args = [a.double() if a.is_floating_point() else a for a in args]
        raygen = raygen[:3] + (raygen[3].double(),)
    lib = _Lib()
    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding.build, "build", lambda: ("mock.so", 0.0))
    monkeypatch.setattr(binding.ctypes, "CDLL", lambda path: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(binding, "_stream", lambda dev: 0)
    monkeypatch.setattr(shade, "_device_kind", lambda x: "cuda")
    shade.LAUNCHES.clear()
    name = "pt_fused_bounce" + ("_f64" if dtype == torch.float64 else "")
    modes = [(rg, fs) for rg in (None, raygen) for fs in (False, True)]
    for rg, fs in modes:
        shade.fused_bounce(tables, *args, raygen=rg, fuse_shadow=fs, **kw)
    entry = getattr(lib, name)
    assert entry.argtypes == _c_params(name)
    calls = lib.calls[name]
    assert len(calls) == 4 and all(len(c) == len(entry.argtypes) for c in calls)
    for (rg, fs), c in zip(modes, calls):
        ptrs = c[8:12]
        assert ptrs == ((None,) * 4 if rg is None else tuple(x.data_ptr() for x in rg))
        assert c[-6:-4] == (int(rg is not None), int(fs))      # raygen, fuse_shadow flags
    suffix = "_f64" if dtype == torch.float64 else ""
    assert dict(shade.LAUNCHES) == {f"fused_bounce{m}{suffix}": 1 for m in
                                    ("", "_shadow", "_raygen", "_raygen_shadow")}
    for split in binding.SPLITS:
        lanes, _ = binding.launch_shape(split)
        item = 8 if dtype == torch.float64 else 4
        n = (tables.sph.shape[0], tables.tri.shape[0], tables.lgt.shape[0], lanes, item)
        assert (binding.shared_bytes(*n, fuse_shadow=True) - binding.shared_bytes(*n)
                == lanes * (7 * item + 4))
    assert shade.launch_name(True, True, True, torch.float64) == \
        "fused_bounce_raygen_shadow_on_pbr_f64"


def test_fused_shadow_split():
    """The fused-shadow instance's split by its own rows a thread: 8 threads
    on many_spheres' 496 rows in float32 and float64 (the vertex alone: 4
    in both); one on Cornell's 24."""
    many = shade.build_tables(scenes.many_spheres(device="cpu"))
    many64 = shade.Tables(*(t.double() for t in many))
    cornell = shade.build_tables(scenes.cornell_box(device="cpu"))
    assert binding._shape(many, None, "fused_bounce_shadow") == (8, 32)
    assert binding._shape(many64, None, "fused_bounce_shadow") == (8, 32)
    assert binding._shape(many, None, "fused_bounce") == \
        binding._shape(many64, None, "fused_bounce") == (4, 32)
    assert binding._shape(cornell, None, "fused_bounce_shadow") == (1, 128)
