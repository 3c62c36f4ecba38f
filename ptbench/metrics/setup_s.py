"""Seconds from the start of the process to the end of the untimed warm-up
pass: the imports, the CUDA context, the kernel library (built on a
checkout's first run), the scene and the warm-up (host clock)."""


def read(rec):
    return rec["setup_s"]
