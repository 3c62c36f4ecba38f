"""Busy slot-iterations of the window's passes over ``num_slots`` x pool
iterations, summed over every rank: the occupancy of the frames pool, whose
passes' counts (``busy_count`` of every frame's counters, and every rank's
iterations) ``frames_pool_sharded`` returns on each rank (program counter).

The engine's ``slots`` count takes one frame a pool, so the slots come from
the traffic: a rank's pool holds ``num_slots`` where its block of frames
has at least that many pixels. Rank 0's block, the largest, is read from
the traced pass's samples; None where ``num_slots`` exceeds it (the pool
would cap its slots there), and off the ``frames_pool`` engine."""


def read(rec):
    if rec["engine"] != "frames_pool" or not rec["trace_samples"]:
        return None
    traffic = rec["traffic"]
    slots = int(traffic["num_slots"])
    side_spp = int(traffic.get("trace_spp", traffic["spp_per_pass"]))
    block_px = rec["trace_samples"] // (int(traffic.get("trace_passes", 1)) * side_spp)
    iters = sum(p["iters"] for p in rec["passes"])
    if slots > block_px or not iters:
        return None
    return 100.0 * sum(p["busy"] for p in rec["passes"]) / (slots * iters)
