"""Share of the traced window in which no operation ran on the device: 1
minus the union of device activity over the window's wall, from the
profiler's device trace."""


def read(rec):
    t = rec["trace"]
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
