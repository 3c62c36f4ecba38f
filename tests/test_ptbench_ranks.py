"""The benchmark's multi-rank cells on the CPU, in the tier-1 run: the CPU
cases of ``ptbench/tests/test_ptbench_ranks.py`` (two gloo ranks on a
3-frame orbit of a small knot through ``frames_pool``, the faults across
ranks, failed peers, the check's reach), and a 4-frame orbit on two ranks
whose pools each hold their rank's whole block of frames."""

import pytest

torch = pytest.importorskip("torch")

from pathtrace_tpu_torch.parallel import sharding  # noqa: E402
from ptbench.tests.test_ptbench_ranks import (  # noqa: E402, F401
    _one_thread,
    _run,
    frames_parts,
    test_a_failed_peer_ends_the_run_and_every_rank,
    test_a_fault_across_ranks_is_not_correct,
    test_a_one_chip_cell_starts_no_peer_and_checks_the_same_ids,
    test_frames_run_correct_on_every_rank_and_match_the_pool,
    test_no_cell_file_may_name_a_plant,
    test_the_check_reaches_every_ranks_frames,
    test_the_orbit_is_the_renderers_sweep,
)


def test_two_ranks_render_a_4_frame_orbit_a_pool_a_rank(monkeypatch):
    """Rank 0 renders frames 0-1 and rank 1 frames 2-3 of a ~300-triangle
    knot (16x16, 2 spp, 64 slots), each block in one pool of stacked
    cameras: correct, with the same passes on both ranks."""
    blocks = []
    pool_loop = sharding._pool_loop

    def spy(scene, camera, *args, **kw):
        blocks.append(tuple(camera.origin.shape))
        return pool_loop(scene, camera, *args, **kw)

    monkeypatch.setattr(sharding, "_pool_loop", spy)
    parts = frames_parts(4, 16, 16, {"spp_per_pass": 2, "num_slots": 64}, 2, 300)
    parts["check"]["pixels"] = 128
    result = _run(parts, seconds=1.0)
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == 2
    assert result["attempted_by_rank"] == [result["attempted"]] * 2
    # Rank 0's calls: the warm-up and every pass, each one pool of two frames.
    assert blocks and set(blocks) == {(2, 3)}, blocks
