"""Device time of the operations that the program's random-number spans
launched (``pool.rng``: the pool's keys and uniforms; ``wave.rng``: the
wave's primary jitter and bounce uniforms), over all device time of the
traced passes: the program's spans read against the profiler's device trace
(``ptbench/spans.py``)."""

from ptbench import spans


def read(rec):
    a = spans.analysis(rec)
    if a is None:
        return None
    return 100.0 * spans.share(a, "device", "pool.rng", "wave.rng") / a["device_s"]
