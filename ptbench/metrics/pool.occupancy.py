"""Busy slot-iterations over iterations x slots in the window: the pool's
``busy_count`` of its counters (program counter)."""


def read(rec):
    if rec["engine"] != "pool":
        return None
    return 100.0 * sum(p["busy"] for p in rec["passes"]) / sum(
        p["iters"] * p["slots"] for p in rec["passes"])
