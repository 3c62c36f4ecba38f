"""Rank 0's host time inside the program's ``dist.*`` spans (the sample
``all_reduce`` and the frames' gather, with the block's copy to the host
and the gathered frames' copy back to the device) over the host time of
its traced sweep (``ptbench/spans.py``).

A profiled rank 0 is the slowest rank of the side pass (the profiler slows
it and the peers run theirs unprofiled), so the others wait for it at the
gather and it seldom waits for them: this reads the gather's own cost more
than the wait for other ranks. None where the program records no ``dist.*``
span."""

from ptbench import spans


def read(rec):
    a = spans.analysis(rec)
    if a is None or not any(k.startswith("dist.") for k in a["host"]):
        return None
    return 100.0 * spans.share(a, "host", "dist.") / a["pass_host_s"]
