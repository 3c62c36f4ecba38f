"""Share of the traced window in which the device was idle while the host
was inside a program span other than a ``sync.*`` one, that is, enqueuing:
the launch-bound idle that fewer launches or CUDA graphs would recover. The
device's idle stretches come from the profiler's device trace, each given to
the innermost span open at that point of the stream: an idle device has run
all that was queued, so that is where the host is (``ptbench/spans.py``)."""

from ptbench import spans


def read(rec):
    a = spans.analysis(rec)
    if a is None:
        return None
    enqueue = sum(v for k, v in a["idle"].items() if not k.startswith("sync."))
    return 100.0 * enqueue / a["window_s"]
