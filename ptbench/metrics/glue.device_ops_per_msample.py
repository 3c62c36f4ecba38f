"""Device operations (kernels, copies, fills) of the traced passes per
million pixel samples, from the profiler's device trace."""


def read(rec):
    t = rec["trace"]
    if t is None or not t.device:
        return None
    return len(t.device) / (rec["trace_samples"] / 1e6)
