"""The port's render orchestration, checkpoint format, exports, pixel replay
and CLI, against the JAX package's on the CPU.

The port's renders run the plain twins of its kernels (CPU tensors); the
JAX side runs its CPU default route. Renders of the two packages agree
within the ``tests/imgutil.py`` knife-edge budget; the port's own
re-orderings of the same samples (resume, pixel chunks, one-pixel replay)
are bitwise equal to one full render, because every random decision is
keyed by ``(pixel, sample, bounce, slot)`` and every lane's arithmetic is
independent of the wave it rides in.
"""

import importlib
import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pathtrace_tpu import io as jax_io  # noqa: E402
from pathtrace_tpu import metrics as jax_metrics  # noqa: E402
from pathtrace_tpu.models import scenes as jax_scenes  # noqa: E402
from pathtrace_tpu_torch import debug, io, metrics  # noqa: E402
from pathtrace_tpu_torch.models import scenes  # noqa: E402

from .imgutil import assert_images_match  # noqa: E402

# Both packages export a function named ``render``: take the modules.
jax_render = importlib.import_module("pathtrace_tpu.render")
render = importlib.import_module("pathtrace_tpu_torch.render")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 12


def _cornell():
    return scenes.cornell_box(device="cpu"), scenes.cornell_camera(W, H, device="cpu")


def _cfg(**kw):
    return render.RenderConfig(**{**dict(width=W, height=H, spp=3, seed=4, max_bounces=64), **kw})


def test_render_matches_jax():
    cfg = dict(width=W, height=H, spp=2, seed=4, max_bounces=64, samples_per_batch=2)
    want = jax_render.render(jax_scenes.cornell_box(), jax_scenes.cornell_camera(W, H),
                             jax_render.RenderConfig(**cfg))
    got = render.render(*_cornell(), render.RenderConfig(**cfg))
    assert got.num_samples == want.num_samples == 2
    assert got.image_sum.shape == (H, W, 3) and got.image_sum.dtype == torch.float32
    assert_images_match(got.image.numpy(), np.asarray(want.image))
    assert got.ray_queries > W * H * 2


def test_resume_and_pixel_chunks_are_bitwise_one_render():
    full = render.render(*_cornell(), _cfg())
    part = render.render(*_cornell(), _cfg(spp=1))
    resumed = render.render(*_cornell(), _cfg(), state=part)
    chunked = render.render(*_cornell(), _cfg(pixel_chunk=50))
    seen = []
    render.render(*_cornell(), _cfg(), progress_callback=seen.append)
    assert seen == [1, 2, 3]
    assert resumed.num_samples == chunked.num_samples == 3
    assert torch.equal(resumed.image_sum, full.image_sum)
    assert torch.equal(chunked.image_sum, full.image_sum)
    assert part.num_samples == 1 and not torch.equal(part.image_sum, full.image_sum)
    assert resumed.ray_queries == chunked.ray_queries == full.ray_queries > part.ray_queries


def test_checkpoints_cross_between_packages(tmp_path):
    """A state saved by JAX resumes in the port and the other way round; each
    resumed render matches the other package's uninterrupted one."""
    jsc, jcam = jax_scenes.cornell_box(), jax_scenes.cornell_camera(W, H)
    jcfg = dict(width=W, height=H, seed=4, max_bounces=64)
    jax_one = jax_render.render(jsc, jcam, jax_render.RenderConfig(spp=1, **jcfg))
    jax_one.save(str(tmp_path / "jax.npz"))
    state = render.RenderState.load(str(tmp_path / "jax.npz"), device="cpu")
    np.testing.assert_array_equal(state.image_sum.numpy(), np.asarray(jax_one.image_sum))
    assert state.num_samples == 1 and state.image_sum.dtype == torch.float32
    port_two = render.render(*_cornell(), _cfg(spp=2), state=state)

    port_one = render.render(*_cornell(), _cfg(spp=1))
    port_one.save(str(tmp_path / "port.npz"))
    back = jax_render.RenderState.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(back.image_sum), port_one.image_sum.numpy())
    assert back.num_samples == 1
    jax_two = jax_render.render(jsc, jcam, jax_render.RenderConfig(spp=2, **jcfg), state=back)

    assert_images_match(port_two.image.numpy(), np.asarray(jax_two.image))
    assert_images_match(port_two.image.numpy(), render.render(*_cornell(), _cfg(spp=2)).image)


def test_exports_equal_jax(tmp_path):
    g = np.random.default_rng(0)
    img = (g.standard_normal((7, 9, 3)) * 0.7 + 0.4).astype(np.float32)
    img[0, 0] = [np.inf, -np.inf, 0.0]
    u8 = render.to_srgb_u8(torch.from_numpy(img))
    np.testing.assert_array_equal(u8, jax_render.to_srgb_u8(jnp.asarray(img)))
    assert u8.dtype == np.uint8 and u8.shape == (7, 9, 3)
    np.testing.assert_array_equal(render.luminance_image(torch.from_numpy(img)).numpy(),
                                  np.asarray(jax_render.luminance_image(jnp.asarray(img))))
    for mod, tag in ((io, "port"), (jax_io, "jax")):
        mod.write_png(u8, str(tmp_path / f"{tag}.png"))
        mod.export_luminance_csv(img[1:], str(tmp_path / f"{tag}.csv"))
        mod.save_npy(img, str(tmp_path / f"{tag}.npy"))
    for ext in ("png", "csv", "npy"):
        assert (tmp_path / f"port.{ext}").read_bytes() == (tmp_path / f"jax.{ext}").read_bytes()
    io.export_luminance_csv(torch.from_numpy(img[1:]), str(tmp_path / "tensor.csv"))
    assert (tmp_path / "tensor.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    np.testing.assert_allclose(io.import_luminance_csv(str(tmp_path / "port.csv")), img[1:],
                               atol=5e-7)


def test_metrics_equal_jax(tmp_path):
    g = np.random.default_rng(1)
    a, b = g.random((6, 5, 3)), g.random((6, 5, 3))
    assert metrics.rmse(a, b) == jax_metrics.rmse(a, b)
    assert metrics.luminance_rmse(a, b) == jax_metrics.luminance_rmse(a, b)
    np.testing.assert_array_equal(metrics.channel_mean_abs_diff(a, b),
                                  jax_metrics.channel_mean_abs_diff(a, b))
    io.export_luminance_csv(b, str(tmp_path / "ref.csv"))
    assert (metrics.rmse_vs_reference_csv(a, str(tmp_path / "ref.csv"))
            == jax_metrics.rmse_vs_reference_csv(a, str(tmp_path / "ref.csv")))
    with pytest.raises(ValueError, match="shape"):
        metrics.rmse(a, b[:2])


def test_replay_pixel_equals_frame_samples():
    """Each replayed sample of one pixel is bitwise the sample a full-frame
    render traced for it (the frame's sum over spp one-sample passes)."""
    sc, cam = _cornell()
    spp, x, y = 4, 9, 7
    samples = debug.render_pixel_samples(sc, cam, x, y, width=W, height=H, spp=spp, seed=4)
    assert samples.shape == (spp, 3)
    prev = None
    for s in range(spp):
        st = render.render(sc, cam, _cfg(spp=s + 1), state=prev)
        got = st.image_sum[y, x] - (prev.image_sum[y, x] if prev else 0.0)
        np.testing.assert_allclose(got.numpy(), samples[s], rtol=1e-6, atol=1e-6)
        prev = st
    frame = render.render(sc, cam, _cfg(spp=spp, samples_per_batch=spp))
    acc = torch.zeros(3)
    for s in range(spp):
        acc = acc + torch.from_numpy(samples[s])
    assert torch.equal(frame.image_sum[y, x], acc)
    rep = debug.replay_pixel(sc, cam, x, y, width=W, height=H, spp=spp, seed=4,
                             luminance_threshold=0.05)
    assert rep["pixel"] == [x, y] and rep["spp"] == spp
    np.testing.assert_allclose(rep["mean_rgb_pre_gamma"], samples.mean(0), rtol=1e-6)
    assert rep["max_sample_luminance"] >= rep["mean_luminance"]
    assert rep["high_luminance_count"] == len(rep["high_luminance_samples"])


def test_render_refuses_what_is_not_ported():
    """A camera of another size is refused; float64 under ``binned``, once
    refused, renders the flat route's float64 image bit for bit."""
    sc, cam = _cornell()
    mesh = scenes.mesh_scene(1000, device="cpu")
    mcam = scenes.mesh_scene_camera(W, H, device="cpu")
    cfg = dict(spp=1, max_bounces=8, dtype=torch.float64)
    got = render.render(mesh, mcam, _cfg(method="binned", **cfg))
    want = render.render(mesh, mcam, _cfg(method="pallas", **cfg))
    assert got.image_sum.dtype == torch.float64 and got.ray_queries == want.ray_queries > W * H
    assert torch.equal(got.image_sum, want.image_sum)
    with pytest.raises(ValueError, match="camera"):
        render.render(sc, scenes.cornell_camera(W + 1, H, device="cpu"), _cfg())


def test_render_binned_and_resident_on_cpu():
    """``RenderConfig(method="binned"|"resident")`` renders on the CPU twins,
    and the image is bitwise the flat route's: every route equals the
    brute-force hit."""
    sc = scenes.mesh_scene(1000, device="cpu")
    cam = scenes.mesh_scene_camera(6, 6, device="cpu")
    cfg = dict(width=6, height=6, spp=1, seed=2, max_bounces=8)
    flat = render.render(sc, cam, render.RenderConfig(method="pallas", **cfg))
    for m in ("binned", "resident"):
        got = render.render(sc, cam, render.RenderConfig(method=m, **cfg))
        assert got.ray_queries == flat.ray_queries > 36
        assert torch.equal(got.image_sum, flat.image_sum)


def _cli(*args, timeout=300):
    # One intra-op thread, like the in-process tests: the test workers share
    # the cores, and a mesh render on oversubscribed torch threads can run
    # past the timeout.
    return subprocess.run([sys.executable, "-m", "pathtrace_tpu_torch", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})


def test_cli_renders_resumes_and_replays(tmp_path):
    common = ["--scene", "cornell", "--width", "10", "--height", "10", "--device", "cpu"]
    ckpt, out = str(tmp_path / "state.npz"), str(tmp_path / "o.png")
    r = _cli("render", *common, "--spp", "1", "--engine", "wave", "--checkpoint", ckpt,
             "--out", out)
    assert r.returncode == 0, r.stderr[-2000:]
    csv, npy = str(tmp_path / "l.csv"), str(tmp_path / "i.npy")
    r = _cli("render", *common, "--spp", "2", "--engine", "wave", "--checkpoint", ckpt,
             "--resume", "--out", out, "--luminance-csv", csv, "--npy", npy,
             "--samples-per-batch", "1")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed at 1 spp" in r.stderr
    assert open(out, "rb").read(8) == b"\x89PNG\r\n\x1a\n" and os.path.exists(csv)
    z = np.load(ckpt)
    assert int(z["num_samples"]) == 2
    np.testing.assert_array_equal(np.load(npy), z["image_sum"] / 2)
    cam = scenes.cornell_camera(10, 10, device="cpu")
    whole = render.render(scenes.cornell_box(device="cpu"), cam,
                          render.RenderConfig(width=10, height=10, spp=2))
    np.testing.assert_array_equal(z["image_sum"], whole.image_sum.numpy())

    pool_ckpt = str(tmp_path / "pool.npz")
    r = _cli("render", *common, "--spp", "2", "--engine", "pool", "--progressive", "1",
             "--checkpoint", pool_ckpt, "--out", str(tmp_path / "p.png"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(np.load(pool_ckpt)["num_samples"]) == 2

    r = _cli("debug-pixel", *common, "--spp", "3", "--x", "4", "--y", "6")
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout)["pixel"] == [4, 6]


def test_cli_coordinator_with_one_process_writes_the_same_png(tmp_path):
    """``--coordinator`` with one process forms a one-rank group and renders
    the plain run's frame (the two-rank CLI is in test_torch_distributed.py)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    common = ["--scene", "cornell", "--width", "10", "--height", "10", "--spp", "1",
              "--device", "cpu"]
    plain, ranked = str(tmp_path / "plain.png"), str(tmp_path / "ranked.png")
    r = _cli("render", *common, "--out", plain)
    assert r.returncode == 0, r.stderr[-2000:]
    r = _cli("--coordinator", f"127.0.0.1:{port}", "--num-processes", "1", "render", *common,
             "--out", ranked)
    assert r.returncode == 0 and "rank 0 of 1" in r.stderr, r.stderr[-2000:]
    assert open(plain, "rb").read() == open(ranked, "rb").read()


@pytest.mark.parametrize("args,message", [
    (["--num-processes", "2", "render"], "coordinator address"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2", "--process-id", "2", "render"],
     "not a rank of 2"),
])
def test_cli_refuses_incomplete_multiprocess_flags(args, message):
    r = _cli(*args, "--device", "cpu")
    assert r.returncode == 2 and message in r.stderr, r.stderr[-2000:]


@pytest.mark.parametrize("method,engine", [("binned", "wave"), ("resident", "pool"),
                                           ("bruteforce", "pool")])
def test_cli_renders_with_per_ray_methods(tmp_path, method, engine):
    """``--method binned|resident|bruteforce`` reaches the wave engine and
    the pool."""
    out = str(tmp_path / "m.png")
    r = _cli("render", "--scene", "mesh", "--method", method, "--engine", engine, "--width", "8",
             "--height", "8", "--spp", "1", "--max-bounces", "3", "--device", "cpu", "--out", out)
    assert r.returncode == 0, r.stderr[-2000:]
    assert open(out, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
