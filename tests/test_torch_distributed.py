"""Multi-process rendering over ``torch.distributed``: two gloo ranks on the
CPU at ``127.0.0.1`` and a free port, each a process that imports only the
port, numpy and torch (``chip_smoke.rank_main``, the ranks of its phase 9,
here on the CPU at small sizes).

* ``render_pool_sharded`` at ``dp=2, sp=1`` gives the single-process pool's
  image bit for bit, at ``dp=1, sp=2`` (twice the samples, a window each)
  the same rays and the image within ``rtol=atol=1e-5`` (the ``all_reduce``
  reassociates the sums); on three frames at ``dp=2`` (the second rank's
  last frame is padding), ``frames_sharded`` gives each frame of
  ``render.render`` within the ``tests/imgutil.py`` budget and
  ``frames_pool_sharded`` each ``render_pool`` frame
  bit for bit. One launch runs them all.
* The CLI's ``animate`` on two ranks writes the frames of the
  single-process CLI, byte for byte.
* A rank whose peer never starts fails within the process-group timeout.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from pathtrace_tpu_torch import pool  # noqa: E402
from pathtrace_tpu_torch.models import scenes  # noqa: E402
from pathtrace_tpu_torch.render import RenderConfig, render  # noqa: E402

from .imgutil import assert_images_match  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = dict(width=16, height=16, spp=2, integrator="mis", max_bounces=6, num_slots=64, seed=5)
WAVE = dict(width=12, height=12, spp=2, integrator="mis", max_bounces=6, seed=5)


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    # The ranks share the cores with the other test workers: one intra-op
    # thread each, or their spinning thread pools starve one another.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_two_gloo_ranks_render_pool_sharded_and_frames_sharded(tmp_path):
    out = str(tmp_path / "ranks.npz")
    spec = dict(job="cornell", device="cpu", n=2, out=out, frame=FRAME, wave=WAVE)
    logs = chip_smoke.launch_ranks(chip_smoke.rank_argv(spec), 2, timeout=300)
    assert all("backend gloo" in log_text for log_text in logs), logs
    got = np.load(out)
    W, H = FRAME["width"], FRAME["height"]
    assert got["counters_2x1"].shape == (2, 1, 4) and got["iters_1x2"].shape == (1, 2)
    for sp in (1, 2):   # the sp=2 run renders twice the samples, one window each
        img, counters, _ = pool.render_pool(scenes.cornell_box("cpu"),
                                            scenes.cornell_camera(W, H, "cpu"),
                                            **dict(FRAME, spp=FRAME["spp"] * sp))
        tag = "2x1" if sp == 1 else "1x2"
        assert pool.ray_count(got[f"counters_{tag}"]) == pool.ray_count(counters)
        if sp == 1:
            np.testing.assert_array_equal(got[f"image_{tag}"], img.numpy())
        else:
            np.testing.assert_allclose(got[f"image_{tag}"], img.numpy(), rtol=1e-5, atol=1e-5)
    cfg = RenderConfig(**WAVE)
    cams = chip_smoke.shifted_cornell_cameras(cfg.width, cfg.height, torch.device("cpu"))
    assert got["frames"].shape == got["pool_frames"].shape == (3, cfg.height, cfg.width, 3)
    for f, cam in enumerate(cams):
        assert_images_match(got["frames"][f],
                            render(scenes.cornell_box("cpu"), cam, cfg).image.numpy())
        img, counters, iters = pool.render_pool(scenes.cornell_box("cpu"), cam, **WAVE)
        np.testing.assert_array_equal(got["pool_frames"][f],
                                      (img.reshape(cfg.height, cfg.width, 3) / 2).numpy())
        assert pool.ray_count(got["pool_counters"][f]) == pool.ray_count(counters)
        assert got["pool_iters"][f, 0] == iters


def test_two_rank_cli_animate_matches_one_process(tmp_path):
    small = ("--scene", "cornell", "--width", "12", "--height", "12", "--max-bounces", "6")
    two = str(tmp_path / "two")
    chip_smoke.run_cli_ranks(two, "cpu", extra=small)
    one = str(tmp_path / "one")
    r = subprocess.run([sys.executable, "-m", "pathtrace_tpu_torch", "animate", "--frames", "2",
                        "--spp", "2", "--device", "cpu", "--out-dir", one, *small],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    names = sorted(os.listdir(one))
    assert names == ["frame_0000.png", "frame_0001.png"] == sorted(os.listdir(two))
    for name in names:
        with open(os.path.join(one, name), "rb") as a, open(os.path.join(two, name), "rb") as b:
            assert a.read() == b.read(), name


def test_missing_peer_fails_within_the_timeout():
    code = ("from pathtrace_tpu_torch.parallel import distributed\n"
            f"distributed.initialize('127.0.0.1:{chip_smoke.free_port()}', 2, 0, "
            "device='cpu', timeout_s=3)\n")
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and time.monotonic() - t0 < 60, r.stderr[-2000:]
    assert "rank 0 of 2 on cpu, joining tcp://127.0.0.1:" in r.stderr
