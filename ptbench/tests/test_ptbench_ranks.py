"""Multi-rank cells and frames, on the CPU: two gloo ranks (this process
rank 0, one peer that the harness starts) render a 3-frame orbit of a small
knot scene (16x16, 2 spp) through ``frames_pool``, driven through
``harness.run_cell(..., parts=...)``.

* The run is correct, on two devices, with the same passes on both ranks,
  and each frame of rank 0's framebuffer is the single-process
  ``pool.render_pool`` of that frame's camera, bit for bit.
* A fault that zeroes rank 1's block of frames, one that leaves out the
  frames' gather and one that swaps two frames each come out not correct.
* A peer that exits at once, is killed in the window, or holds JAX once
  its part is over ends the run non-zero with no result within the
  harness's timeout, and leaves no process behind.
* No cell's file may plant a fault.
* A one-chip cell starts no peer and checks the ids it always drew.

On the card (marked ``chip``): four ranks render a 4-frame orbit of the
70k-triangle knot at 640x360 (one GPU: the ranks share it over gloo; four:
NCCL, one GPU a rank), correct, traced and not; and a peer killed in the
window ends the run there too.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from pathtrace_tpu_torch import pool
from pathtrace_tpu_torch.models import scenes
from ptbench import check, harness, program, ranks, reference, scene
from ptbench.engines import frames_pool
from ptbench.tests import cells

SEED = 2**31 + 7
FAULTS = "ptbench.tests.rank_faults"


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    # The ranks share the cores with the other test workers: one intra-op
    # thread each, or their spinning thread pools starve one another.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def frames_parts(frames: int, width: int, height: int, traffic: dict, chips: int,
                 n_tris: int | None = None, plant: str | None = None) -> dict:
    """The knot cell's parts with an orbit of ``frames`` cameras in place of
    its camera, on the frames pool."""
    parts = copy.deepcopy(harness.cell_parts(cells.spec(), "knot70k_1080p.pool"))
    cfg = parts["config"]
    del cfg["camera"]
    cfg.update(width=width, height=height,
               cameras={"recipe": "orbit", "params": {"frames": frames}})
    if n_tris:
        cfg["scene"]["params"] = {"n_tris": n_tris}
    parts["traffic"] = {"engine": "frames_pool", **traffic}
    parts["workload"] = dict(parts["workload"], name=f"knot_orbit{frames}.ranks{chips}",
                             chips=chips)
    if plant:
        parts["plant"] = f"{FAULTS}:{plant}"
    return parts


def orbit_parts(chips: int = 2, plant: str | None = None) -> dict:
    """A 3-frame orbit of a ~300-triangle knot at 16x16, 2 spp, 64 slots:
    with two ranks, rank 0 renders frames 0-1 and rank 1 frame 2."""
    parts = frames_parts(3, 16, 16, {"spp_per_pass": 2, "num_slots": 64}, chips, 300, plant)
    parts["check"]["pixels"] = 96
    return parts


def trial_parts(plant: str | None = None) -> dict:
    """The card's trial: a 4-frame orbit of the 70k-triangle knot at
    640x360 (``sweep_cameras(4, 640, 360)``), 16 spp a pass at 32,768
    slots, over four ranks; traced side passes of 4 spp."""
    return frames_parts(4, 640, 360, {"spp_per_pass": 16, "num_slots": 32768,
                                      "trace_passes": 1, "trace_spp": 4}, 4, plant=plant)


def _run(parts, seconds=0.3):
    return harness.run_cell(None, parts["workload"]["name"], SEED, seconds, False,
                            device="cpu", parts=parts)


@pytest.mark.parametrize("chips", [1, 2])
def test_frames_run_correct_on_every_rank_and_match_the_pool(chips, monkeypatch):
    kept = []
    original = frames_pool.Engine.framebuffer
    monkeypatch.setattr(frames_pool.Engine, "framebuffer",
                        lambda self: kept.append(original(self)) or kept[-1])
    parts = orbit_parts(chips)
    result = _run(parts, seconds=1.5)
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == chips
    assert len(result["device"]["memory_peak_bytes_by_rank"]) == chips
    assert result["attempted_by_rank"] == [result["attempted"]] * chips
    assert result["attempted"] >= 1

    cfg = parts["config"]
    system = program.build(scene.build(cfg["scene"]), cfg, "cpu")
    fb = kept[-1].reshape(3, cfg["width"] * cfg["height"], 3)
    for f, cam in enumerate(system.cameras):
        image, _, _ = pool.render_pool(
            system.scene, cam, width=cfg["width"], height=cfg["height"], spp=2,
            integrator=cfg["integrator"], max_bounces=cfg["max_bounces"], num_slots=64,
            seed=SEED & 0xFFFFFFFF)
        assert torch.equal(fb[f], image.reshape(-1, 3)), f


@pytest.mark.parametrize("fault", ["zero_rank1_block", "no_gather", "swap_frames"])
def test_a_fault_across_ranks_is_not_correct(fault):
    result = _run(orbit_parts(2, fault))
    assert not result["correct"], result["checks"]


RANK0 = """
import json, sys
from ptbench import harness, ranks
parts = harness.load_json(sys.argv[1])
try:
    result = harness.run_cell(None, parts["workload"]["name"], 7, float(sys.argv[2]), False,
                              device=sys.argv[3], parts=parts)
except ranks.RanksFailed:     # as run.py ends
    sys.exit(ranks.EXIT_RANK_FAILED)
print(json.dumps(result))
"""


def _failed_run(parts: dict, seconds: float, device: str, tmp_path, said: str = "") -> None:
    """Rank 0 in a process of its own session that ends as ``run.py`` does,
    the run's peer planted to fail: the run ends non-zero with no result
    within the harness's timeout, and no process of the session is left."""
    job = tmp_path / "parts.json"
    job.write_text(json.dumps(parts))
    code = RANK0
    t0 = time.monotonic()
    rank0 = subprocess.Popen([sys.executable, "-c", code, str(job), str(seconds), device],
                             cwd=harness.BENCH_DIR.parent, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, start_new_session=True,
                             env=dict(os.environ, TMPDIR=str(tmp_path)))
    try:
        out, err = rank0.communicate(timeout=ranks.TIMEOUT_S + seconds)
    finally:
        if rank0.poll() is None:
            os.killpg(rank0.pid, 9)
            rank0.wait()
    took = time.monotonic() - t0
    print(f"rank 0 exited {rank0.returncode} after {took:.1f} s:\n{err[-2000:]}",
          file=sys.stderr)
    assert took < ranks.TIMEOUT_S + seconds
    assert rank0.returncode == ranks.EXIT_RANK_FAILED, err[-3000:]
    assert out == "", out
    assert "[ranks] peer(s) exited non-zero" in err, err[-3000:]
    assert said in err, err[-3000:]
    time.sleep(0.5)
    with pytest.raises(ProcessLookupError):    # no process of the run is left
        os.killpg(rank0.pid, 0)
    assert not list(tmp_path.glob("ptbench_job_*")), "the run's job file is left"


@pytest.mark.parametrize("fault,seconds,said", [
    ("exit_at_once", 0.3, ""),
    ("killed_mid_window", 30.0, ""),
    ("jax_in_rank1", 0.3, "[rank 1] ptbench: rank 1 loaded ['jax']"),
])
def test_a_failed_peer_ends_the_run_and_every_rank(fault, seconds, said, tmp_path):
    _failed_run(orbit_parts(2, fault), seconds, "cpu", tmp_path, said)


def test_no_cell_file_may_name_a_plant(monkeypatch):
    load_json = harness.load_json
    monkeypatch.setattr(harness, "load_json", lambda path: dict(
        load_json(path), **({"plant": f"{FAULTS}:swap_frames"} if "traffic" in str(path)
                            else {})))
    with pytest.raises(ValueError, match="plant"):
        harness.cell_parts(cells.spec(), "knot70k_1080p.pool")


@pytest.mark.chip
def test_a_killed_peer_ends_the_run_on_the_card(cuda_device, tmp_path):
    _failed_run(trial_parts("killed_mid_window"), 30.0, cuda_device, tmp_path)


@pytest.mark.chip
@pytest.mark.parametrize("trace", [False, True])
def test_four_ranks_on_the_card(trace, cuda_device):
    result = harness.run_cell(None, "knot_orbit4.ranks4", SEED, 10.0, trace,
                              device=cuda_device, parts=trial_parts())
    print(json.dumps(result), file=sys.stderr)
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == 4
    assert len(result["device"]["memory_peak_bytes_by_rank"]) == 4
    assert result["attempted_by_rank"] == [result["attempted"]] * 4


def test_a_one_chip_cell_starts_no_peer_and_checks_the_same_ids(monkeypatch):
    def no_peers(*args, **kw):
        raise AssertionError("a one-chip cell started a peer")

    drawn = []
    render_pixels = reference.render_pixels
    monkeypatch.setattr(ranks, "Peers", no_peers)
    monkeypatch.setattr(reference, "render_pixels",
                        lambda desc, cam, ids, *a, **kw: drawn.append(ids.clone())
                        or render_pixels(desc, cam, ids, *a, **kw))
    parts = cells.small_parts("rtiow_1080p.pool")
    cfg = parts["config"]
    result = harness.run_cell(cells.spec(), "rtiow_1080p.pool", SEED, 0.0, False,
                              device="cpu", parts=parts)
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == 1 and result["attempted_by_rank"] == [1]
    ids = check.pixel_sample(SEED & 0xFFFFFFFF, cfg["width"] * cfg["height"],
                             parts["check"]["pixels"])
    assert len(drawn) == 1 and torch.equal(drawn[0], ids)


def test_the_orbit_is_the_renderers_sweep():
    cfg = orbit_parts()["config"]
    cfg["cameras"]["params"]["frames"] = 120
    system = program.build(scene.build(cfg["scene"]), cfg, "cpu")
    sweep = scenes.sweep_cameras(120, 16, 16, device="cpu")
    assert len(system.cameras) == len(sweep) == 120
    for ours, theirs in zip(system.cameras, sweep):
        for name, value in vars(theirs).items():
            got = getattr(ours, name)
            assert torch.equal(got, value) if isinstance(value, torch.Tensor) else got == value


def test_the_check_reaches_every_ranks_frames():
    assert [list(b) for b in check.frame_blocks(3, 2)] == [[0, 1], [2]]
    assert [list(b) for b in check.frame_blocks(120, 4)][3] == list(range(90, 120))
    px = 16 * 16
    assert check.missed_blocks(torch.tensor([0, px + 3]), px, 3, 2) == [1]
    assert check.missed_blocks(torch.tensor([0, 2 * px]), px, 3, 2) == []
    ids = check.pixel_sample(SEED, 120 * 640 * 360, 1024)
    assert check.missed_blocks(ids, 640 * 360, 120, 4) == []
