"""Share of the traced window in which the device sat idle inside the
program's ``dist.*`` spans: the card waiting while the frames cross the
host (the block's copy down, the gather, the copy back up) and while rank 0
waits for the other ranks. Each idle stretch of the device trace goes to
the innermost span open at that point of the stream (``ptbench/spans.py``).
None where the program records no ``dist.*`` span."""

from ptbench import spans


def read(rec):
    a = spans.analysis(rec)
    if a is None or not any(k.startswith("dist.") for k in a["host"]):
        return None
    return 100.0 * spans.share(a, "idle", "dist.") / a["window_s"]
