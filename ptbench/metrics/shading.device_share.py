"""Device time of the operations launched inside the program's ``bsdf`` and
``lights`` spans (the calls into ``ops/bsdf.py`` and ``ops/lights.py`` of
the composed vertex and the wave; the fused kernel shades inside itself),
over all device time of the traced passes (``ptbench/spans.py``)."""

from ptbench import spans


def read(rec):
    a = spans.analysis(rec)
    if a is None:
        return None
    return 100.0 * spans.share(a, "device", "bsdf", "lights") / a["device_s"]
