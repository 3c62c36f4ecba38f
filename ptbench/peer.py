"""A peer rank of a multi-rank cell, started by rank 0 (``ptbench/ranks.py``):

    python3 -m ptbench.peer <job.json> <rank>

from the checkout's root. It runs its rank's part of the run
(``harness.run_rank``) and prints nothing on standard output. Like rank 0
(``run.py``), it exits non-zero if JAX or the JAX package was loaded once the
window has closed, which fails the run. It dies with rank 0: the
parent-death signal kills it when rank 0 ends first."""

from __future__ import annotations

import ctypes
import json
import os
import signal
import sys

PR_SET_PDEATHSIG = 1


def die_with_parent(parent: int) -> None:
    """SIGKILL this process when its parent ends (Linux); a parent that has
    already ended is caught by its pid."""
    if sys.platform.startswith("linux"):
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl.argtypes = [ctypes.c_int, ctypes.c_ulong, ctypes.c_ulong, ctypes.c_ulong,
                               ctypes.c_ulong]
        libc.prctl.restype = ctypes.c_int
        if libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
            raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != parent:
        sys.exit(f"ptbench.peer: rank 0 (pid {parent}) has ended")


def main(argv=None) -> int:
    path, rank = argv if argv is not None else sys.argv[1:]
    with open(path) as f:
        job = json.load(f)
    die_with_parent(int(job["parent"]))
    from ptbench import harness, run

    harness.run_rank(job, int(rank))
    bad = run.loaded_forbidden()
    if bad:     # its frames reach rank 0's result: the run fails (``ranks.Peers``)
        print(f"ptbench: rank {rank} loaded {bad}; nothing of JAX may run", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
