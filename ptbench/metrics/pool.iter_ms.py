"""Milliseconds a pool iteration: the window over the iterations that
``render_pool`` returned for its passes (host clock)."""


def read(rec):
    if rec["engine"] != "pool":
        return None
    return rec["window_s"] * 1e3 / sum(p["iters"] for p in rec["passes"])
