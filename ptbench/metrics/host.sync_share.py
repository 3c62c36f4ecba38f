"""Host time inside the program's ``sync.*`` spans (the host waiting on the
device: the pool's flush index and exit test, the wave's live-lane test and
ray count, and every copy of a host constant to the device, ``sync.h2d``)
over the host time of the traced passes (``ptbench/spans.py``)."""

from ptbench import spans


def read(rec):
    a = spans.analysis(rec)
    if a is None:
        return None
    return 100.0 * spans.share(a, "host", "sync.") / a["pass_host_s"]
