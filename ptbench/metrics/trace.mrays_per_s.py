"""Traced rays a second over the window: the pool's ``ray_count`` (every
busy slot's closest hit and every NEE shadow query) or the wave engine's
``RenderState.ray_queries`` (primary, shadow and peek queries), program
counters, over the window's host clock."""


def read(rec):
    return sum(p["rays"] for p in rec["passes"]) / rec["window_s"] / 1e6
