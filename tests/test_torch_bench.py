"""The port's profiler and bench on the CPU.

``profiler.profiled_render`` against the JAX package's on the same Cornell
frame (the JAX pool's fused branch in Pallas interpret mode, the port's
twins): the traced-ray and iteration counts equal, the image within the
``tests/imgutil.py`` budget, the same ``RenderStats`` fields. The bench's
small frame through ``python -m pathtrace_tpu_torch bench --device cpu``:
one JSON line with the root ``bench.py``'s keys, its counts those of
``render_pool`` on the same frame; with no card and no ``--device cpu`` it
raises and falls back to nothing.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pathtrace_tpu import profiler as jax_profiler  # noqa: E402
from pathtrace_tpu.models import scenes as jax_scenes  # noqa: E402
from pathtrace_tpu.ops.intersect import set_default_method  # noqa: E402
from pathtrace_tpu_torch import bench, cli, pool, profiler  # noqa: E402
from pathtrace_tpu_torch.convert import (  # noqa: E402
    camera_from_arrays,
    scene_from_arrays,
    split_fields,
)
from pathtrace_tpu_torch.models import scenes  # noqa: E402
from pathtrace_tpu_torch.render import RenderState  # noqa: E402

from .imgutil import assert_images_match  # noqa: E402

FRAME = dict(width=32, height=32, spp=2, integrator="mis", max_bounces=8, num_slots=256,
             seed=0)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
EXTRA_KEYS = {"platform", "spp_per_sec", "total_rays", "pool_iterations", "occupancy",
              "wall_s", "image_checksum"}


def test_profiled_render_matches_jax():
    jsc, jcam = jax_scenes.cornell_box(), jax_scenes.cornell_camera(32, 32)
    set_default_method("pallas_interpret")
    try:
        jstate, jstats = jax_profiler.profiled_render(jsc, jcam, **FRAME)
        jimg = np.asarray(jstate.image_sum)
    finally:
        set_default_method(None)
    sc = scene_from_arrays(*split_fields(jsc), device="cpu")
    cam = camera_from_arrays(*split_fields(jcam), device="cpu")
    state, stats = profiler.profiled_render(sc, cam, **FRAME)

    assert isinstance(state, RenderState) and state.num_samples == 2
    assert state.image_sum.shape == (32, 32, 3)
    assert (stats.traced_rays, stats.pool_iterations) == (jstats.traced_rays,
                                                         jstats.pool_iterations)
    assert state.ray_queries == stats.traced_rays
    assert_images_match(state.image_sum.numpy(), jimg)
    assert stats.platform == "cpu"
    assert (stats.width, stats.height, stats.spp, stats.integrator) == (32, 32, 2, "mis")
    assert stats.wall_s > 0 and stats.mrays_per_s > 0 and stats.spp_per_s > 0
    record = json.loads(stats.to_json())
    assert list(record) == [f.name for f in dataclasses.fields(jax_profiler.RenderStats)]

    # A second pass adds to the state: samples and queries accumulate.
    state2, stats2 = profiler.profiled_render(sc, cam, **dict(FRAME, sample_offset=2),
                                              state=state)
    assert state2.num_samples == 4
    assert state2.ray_queries == stats.traced_rays + stats2.traced_rays


def test_bench_cpu_prints_one_json_line(monkeypatch, capsys):
    """The CLI on the CPU's small frame. The untimed warm-up is replaced by
    a check of its arguments (:func:`test_bench_warm_up` renders it), and
    the timed frame's ``render_pool`` call is recorded: the line's counts
    must be those that call returned, on the bench's frame and camera."""
    warm, calls = [], []
    monkeypatch.setattr(bench, "warm_up", lambda *a: warm.append(a) or 0.0)
    render_pool = pool.render_pool

    def recorded(scene, camera, **kw):
        calls.append((scene, camera, kw, render_pool(scene, camera, **kw)))
        return calls[-1][-1]

    monkeypatch.setattr(pool, "render_pool", recorded)
    assert cli.main(["bench", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == BENCH_KEYS and set(line["extra"]) == EXTRA_KEYS
    assert line["vs_baseline"] is None and line["unit"] == "Mrays/s"
    assert line["metric"] == "Mrays/sec/chip (many-sphere 128x128 @1spp MIS)"
    extra = line["extra"]
    assert extra["platform"] == "cpu"

    assert len(warm) == 1 and warm[0][2] == bench.SMALL_FRAME
    assert len(calls) == 1
    scene, camera, kw, (img, counters, iters) = calls[0]
    assert kw == bench.SMALL_FRAME
    assert (kw["width"], kw["spp"], kw["num_slots"]) == (128, 1, 4096)
    assert (scene.num_spheres, scene.device.type) == (warm[0][0].num_spheres, "cpu")
    ref_cam = scenes.many_spheres_camera(128, 128, device="cpu")
    assert all(torch.equal(getattr(camera, f), getattr(ref_cam, f))
               for f in ("origin", "lower_left_corner", "horizontal", "vertical"))
    assert extra["total_rays"] == pool.ray_count(counters)
    assert extra["pool_iterations"] == iters
    assert extra["image_checksum"] == round(float(img.double().sum()), 2)
    assert extra["occupancy"] == round(pool.busy_count(counters) / (iters * 4096), 4)
    assert line["value"] >= 0 and extra["wall_s"] > 0


def test_bench_warm_up(monkeypatch):
    """The warm-up renders 1 spp of the frame on the camera moved by 1e-4."""
    calls = []
    render_pool = pool.render_pool

    def recorded(scene, camera, **kw):
        calls.append((camera, kw))
        return render_pool(scene, camera, **kw)

    monkeypatch.setattr(pool, "render_pool", recorded)
    scene, camera, frame = bench.setup("cpu")
    frame = dict(frame, width=8, height=8, num_slots=64)
    camera = scenes.many_spheres_camera(8, 8, device="cpu")
    assert bench.warm_up(scene, camera, frame) > 0
    (warm, kw), = calls
    assert kw == dict(frame, spp=1)
    assert torch.equal(warm.origin, camera.origin + 1e-4)
    assert torch.equal(warm.horizontal, camera.horizontal)


def test_bench_without_card_raises(monkeypatch, capsys):
    """No card and no ``--device cpu``: the library raises and the CLI
    exits 2 with nothing on stdout; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.setup("cuda", small=True)
    assert cli.main(["bench"]) == 2
    assert cli.main(["bench", "--small"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_bench_frame_is_the_root_bench_frame():
    assert bench.FRAME == dict(width=1920, height=1080, spp=16, integrator="mis",
                               max_bounces=32, num_slots=16384, seed=0)
    assert bench.SMALL_FRAME == dict(bench.FRAME, width=128, height=128, spp=1,
                                     num_slots=4096)
