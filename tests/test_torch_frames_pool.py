"""The frame axis of the persistent pool: ``frames_pool_sharded`` renders a
rank's block of frames in one ``pool._pool_loop`` on the composed branch.

A 3-frame orbit of a small knot (``ptbench/recipes/knot_field.py``, 4,182
triangles: the BVH route) at 16x16, 2 spp, 64 slots, so the pool's slots
move between frames:

* each frame is bit for bit its own ``render_pool``, its rays and busy
  slot-iterations exact; the block's iterations sit on its first frame and
  equal one batched ``_pool_loop`` of the stacked cameras;
* the frames are within the check's limits of the plain reference
  (``ptbench/reference.py``) at 64 pixels drawn over all three frames;
* a traced sweep is one pass record holding the pool's spans and the
  ``dist.*`` spans;
* one camera (``render_pool``, every benchmark cell's path) runs no
  operation of the frame axis (``index_add_``) and no kind of operation it
  did not run before.

The fused branch (Cornell) keeps one pool a frame, bit for bit.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pathtrace_tpu_torch import pool, profiler  # noqa: E402
from pathtrace_tpu_torch.models import scenes  # noqa: E402
from pathtrace_tpu_torch.ops import intersect  # noqa: E402
from pathtrace_tpu_torch.parallel import distributed, sharding  # noqa: E402
from pathtrace_tpu_torch.render import RenderConfig  # noqa: E402
from ptbench import check, harness, program, ranks, reference, scene  # noqa: E402

W = H = 16
SEED = 2**31 + 11
CFG = {"scene": {"recipe": "knot_field", "params": {"n_tris": 4200}},
       "cameras": {"recipe": "orbit", "params": {"frames": 3}},
       "width": W, "height": H, "integrator": "mis", "max_bounces": 8}
RUN = RenderConfig(width=W, height=H, spp=2, integrator="mis", max_bounces=8,
                   seed=SEED & 0xFFFFFFFF)
POOL = dict(width=W, height=H, spp=2, integrator="mis", max_bounces=8, num_slots=64,
            seed=SEED & 0xFFFFFFFF)
# The names torch.profiler records on the CPU for one render_pool of the
# knot's frame 1 (POOL), spans included, before the frame axis (torch 2.x;
# the whole histogram, 133,647 operations, was the same with the frame axis
# in). A change that gives the pool a new kind of operation on purpose adds
# its name here.
ONE_CAMERA_OP_NAMES = frozenset({
    "aten::__and__", "aten::__ior__", "aten::__lshift__", "aten::__or__",
    "aten::__rshift__", "aten::__xor__", "aten::_index_put_impl_",
    "aten::_local_scalar_dense", "aten::_to_copy", "aten::abs", "aten::add", "aten::all",
    "aten::amax", "aten::amin", "aten::any", "aten::arange", "aten::argmax",
    "aten::as_strided", "aten::as_strided_", "aten::bitwise_and", "aten::bitwise_not",
    "aten::bitwise_or", "aten::bitwise_or_", "aten::bitwise_xor", "aten::cat",
    "aten::clamp_max", "aten::clamp_min", "aten::clone", "aten::contiguous", "aten::copy_",
    "aten::cos", "aten::detach_", "aten::div", "aten::empty", "aten::empty_like",
    "aten::empty_strided", "aten::eq", "aten::exp2", "aten::expand", "aten::expand_as",
    "aten::fill_", "aten::floor_divide", "aten::full", "aten::full_like", "aten::ge",
    "aten::gt", "aten::index", "aten::index_put_", "aten::is_nonzero", "aten::isfinite",
    "aten::item", "aten::le", "aten::lift_fresh", "aten::lt", "aten::maximum", "aten::min",
    "aten::minimum", "aten::mul", "aten::narrow", "aten::ne", "aten::neg",
    "aten::new_empty", "aten::new_full", "aten::new_zeros", "aten::nonzero",
    "aten::numpy_T", "aten::ones", "aten::ones_like", "aten::permute", "aten::pow",
    "aten::reciprocal", "aten::remainder", "aten::reshape", "aten::resize_",
    "aten::result_type", "aten::rsub", "aten::scalar_tensor", "aten::select", "aten::sin",
    "aten::slice", "aten::sqrt", "aten::squeeze", "aten::squeeze_", "aten::stack",
    "aten::sub", "aten::sum", "aten::to", "aten::unbind", "aten::unsqueeze",
    "aten::unsqueeze_", "aten::view", "aten::where", "aten::zero_", "aten::zeros",
    "aten::zeros_like", "bsdf", "detach_", "intersect", "lights", "pool.bounce",
    "pool.count", "pool.flush", "pool.iter", "pool.pass", "pool.refill", "pool.rng",
    "pool.shadow", "sync.flush_index", "sync.h2d", "sync.pool_exit",
})


@pytest.fixture(scope="module")
def knot():
    desc = scene.build(CFG["scene"])
    return desc, program.build(desc, CFG, "cpu")


@pytest.fixture(scope="module")
def sweep(knot):
    _, system = knot
    return sharding.frames_pool_sharded(system.scene, system.cameras, RUN, num_slots=64)


def test_knot_takes_the_bvh_route(knot):
    s = knot[1].scene
    assert s.tri_v0.shape[0] >= intersect.BVH_MIN_TRIS
    assert pool.route(s, "mis") == "composed"
    assert intersect.resolve_route(s.tri_v0.shape[0], s.sph_center.shape[0], "auto") == "bvh"


def test_each_frame_is_its_render_pool_bit_for_bit(knot, sweep):
    _, system = knot
    frames, counters, iters = sweep
    assert frames.shape == (3, H, W, 3) and counters.shape == (3, 1, 4)
    for f, cam in enumerate(system.cameras):
        img, ctr, _ = pool.render_pool(system.scene, cam, **POOL)
        assert torch.equal(frames[f], img.reshape(H, W, 3) / 2), f
        assert pool.ray_count(counters[f]) == pool.ray_count(ctr), f
        assert pool.busy_count(counters[f]) == pool.busy_count(ctr), f


def test_the_blocks_iterations_sit_on_its_first_frame(knot, sweep):
    _, system = knot
    _, counters, iters = sweep
    stack = sharding.stack_cameras(system.cameras)
    img, ctr, it = pool._pool_loop(system.scene, stack, 0, 0, total_pixels=3 * W * H,
                                   local_pixels=3 * W * H, **POOL)
    assert iters.shape == (3, 1) and iters[:, 0].tolist() == [it, 0, 0] and it > 0
    assert ctr.shape == (3, 4) and torch.equal(ctr, counters[:, 0])


def test_frames_are_within_the_checks_limits_of_the_reference(knot, sweep):
    desc, _ = knot
    frames, _, _ = sweep
    ids = check.pixel_sample(SEED, 3 * W * H, 64)
    assert not check.missed_blocks(ids, W * H, 3, 3)
    got = (frames * 2).reshape(-1, 3)[ids]
    want = reference.render_frames(desc, scene.cameras(CFG), ids, 0, 2, width=W, height=H,
                                   seed=SEED & 0xFFFFFFFF, integrator="mis", max_bounces=8)
    limits = harness.load_json(
        harness.BENCH_DIR / "checks" / "knot70k_640x360.sweep4.json")["limits"]
    numbers = check.compare(got, want)
    assert check.judge(numbers, limits), numbers


def test_a_traced_sweep_is_one_pass_record(knot):
    """On a group of one gloo rank, so the gathers run and count."""
    _, system = knot
    distributed.initialize(f"127.0.0.1:{ranks.free_port()}", 1, 0, device="cpu",
                           timeout_s=60)
    try:
        profiler.clear()
        with profiler.tracing():
            frames, counters, iters = sharding.frames_pool_sharded(
                system.scene, system.cameras, RUN, num_slots=64)
    finally:
        distributed.shutdown()
    (rec,) = profiler.passes()
    assert rec.kind == "frames" and rec.names[0] == "frames.pass"
    assert rec.counts["pool.pass"] == 1 and rec.counts["pool.iter"] == iters.sum()
    for name in ("pool.refill", "pool.bounce", "dist.all_reduce"):
        assert rec.counts[name] >= 1, name
    assert rec.counts["dist.gather"] == 1     # the frames, counters and iterations
    gather = rec.names.index("dist.gather")
    assert rec.names[1] == "pool.pass" and rec.parents[1] == 0   # the pool, a span of the sweep
    assert rec.parents[gather] == 0 and rec.start_ns[gather] >= rec.end_ns[1]


def test_one_camera_runs_the_operations_it_ran_before(knot):
    from torch.profiler import ProfilerActivity, profile

    _, system = knot
    pool.render_pool(system.scene, system.cameras[1], **POOL)    # anything built once
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pool.render_pool(system.scene, system.cameras[1], **POOL)
    ops = {e.key: e.count for e in prof.key_averages()}
    assert "aten::index_add_" not in ops
    assert set(ops) <= ONE_CAMERA_OP_NAMES, set(ops) - ONE_CAMERA_OP_NAMES


def _cornell():
    s = scenes.cornell_box("cpu")
    cam = scenes.cornell_camera(W, H, "cpu")
    return s, [dataclasses.replace(cam, origin=cam.origin + torch.tensor([0.02 * i, 0.0, 0.0]))
               for i in range(3)]


def test_the_fused_route_renders_one_pool_a_frame_bit_for_bit():
    s, cams = _cornell()
    assert pool.route(s, "mis") == "fused"
    cfg = dataclasses.replace(RUN, max_bounces=5)
    profiler.clear()
    with profiler.tracing():
        frames, counters, iters = sharding.frames_pool_sharded(s, cams, cfg, num_slots=64)
    (rec,) = profiler.passes()
    assert rec.counts["pool.pass"] == 3
    total = 0
    for f, cam in enumerate(cams):
        img, ctr, it = pool.render_pool(s, cam, **dict(POOL, max_bounces=5))
        assert torch.equal(frames[f], img.reshape(H, W, 3) / 2), f
        assert pool.ray_count(counters[f]) == pool.ray_count(ctr), f
        total += it
    assert iters[:, 0].tolist() == [total, 0, 0]
    with pytest.raises(NotImplementedError, match="one camera"):
        pool._pool_loop(s, sharding.stack_cameras(cams), 0, 0, total_pixels=3 * W * H,
                        local_pixels=3 * W * H, **POOL)
