"""Median wall of a pass of the wave engine in the window (host clock, each
pass ended by a device synchronise)."""

import statistics


def read(rec):
    if rec["engine"] != "wave":
        return None
    return statistics.median(rec["walls"]) * 1e3
