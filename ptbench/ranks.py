"""The ranks of a multi-rank cell (a workload of ``chips: N > 1``).

The process that runs the cell (``harness.run_cell``) is rank 0. It starts
the other ``N - 1`` ranks, its peers, as ``python3 -m ptbench.peer <job>
<rank>`` from the checkout's root, with the run's job (workload, seed,
seconds, trace, device and the cell's parts) in a temporary JSON file, and
every rank joins the program's own process group at a free localhost port
(``program.join``) with the harness's timeout, :data:`TIMEOUT_S`.

* Peers print nothing on standard output; each line of a peer's standard
  error reaches rank 0's, prefixed with ``[rank r]``.
* A peer that exits non-zero ends the run: rank 0 kills every peer, waits
  for each and exits with :data:`EXIT_RANK_FAILED`, printing no result
  (once rank 0's part has ended, it raises :class:`RanksFailed`, which
  ``run.py`` turns into that exit). A
  collective or rendezvous that waits longer than :data:`TIMEOUT_S` for a
  rank fails its rank, which then exits non-zero; peers that outlast rank
  0's end of the run by :data:`TIMEOUT_S` are killed and fail it. A peer is
  killed when rank 0 dies (the parent-death signal), so no rank outlives
  the run.
* Rank 0's clock ends the window: after each pass every rank learns whether
  to go on from one small collective (:func:`agree`), so every rank runs the
  same passes.

A run of one rank forms no group and starts no peer; every function here
is then the identity or a no-op.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch
import torch.distributed as dist

TIMEOUT_S = 120.0        # rendezvous and collective timeout of every rank
EXIT_RANK_FAILED = 4     # rank 0's exit code when a peer failed
POLL_S = 0.1


class RanksFailed(RuntimeError):
    """A peer exited non-zero after rank 0's part of the run had ended."""


def log(msg: str) -> None:
    """One line to standard error, the harness's log on every rank."""
    sys.stderr.write(msg + "\n")     # one write: a peer's relayed line cannot split it
    sys.stderr.flush()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _relay(rank: int, stream) -> None:
    for line in stream:
        sys.stderr.write(f"[rank {rank}] {line}")
    sys.stderr.flush()


class Peers:
    """Ranks ``1 .. n - 1`` of a run, started from ``root``; a context
    manager whose value is the job with the group's coordinates added
    (``ranks``, ``coordinator``, ``timeout_s``, ``parent``)."""

    def __init__(self, job: dict, n: int, root: Path):
        self.job = {**job, "ranks": n, "coordinator": f"127.0.0.1:{free_port()}",
                    "timeout_s": TIMEOUT_S, "parent": os.getpid()}
        fd, self.path = tempfile.mkstemp(prefix="ptbench_job_", suffix=".json")
        with os.fdopen(fd, "w") as f:
            json.dump(self.job, f)
        self.procs = {}
        self.relays = []
        self.closing = threading.Event()
        try:
            for r in range(1, n):
                p = subprocess.Popen([sys.executable, "-m", "ptbench.peer", self.path, str(r)],
                                     cwd=root, stdin=subprocess.DEVNULL,
                                     stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                     text=True)
                self.procs[r] = p
                self.relays.append(threading.Thread(target=_relay, args=(r, p.stderr),
                                                    daemon=True))
                self.relays[-1].start()
        except BaseException:
            self._kill()
            os.remove(self.path)
            raise
        log(f"[ranks] rank 0 (pid {os.getpid()}) started peers "
            f"{ {r: p.pid for r, p in self.procs.items()} } at {self.job['coordinator']}")
        self.watchdog = threading.Thread(target=self._watch, daemon=True)
        self.watchdog.start()

    def _failed(self) -> list:
        return [(r, p.returncode) for r, p in self.procs.items() if p.poll() not in (None, 0)]

    def _kill(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
        for p in self.procs.values():
            p.wait()

    def _watch(self) -> None:
        """Until the run closes: a peer that exits non-zero ends every rank.
        Rank 0 may be waiting inside a collective, which no exception can
        interrupt, so it leaves at once (``os._exit``), printing no result."""
        while not self.closing.wait(POLL_S):
            failed = self._failed()
            if failed:
                log(f"[ranks] peer(s) exited non-zero {failed}: killing every rank")
                self._kill()
                for t in self.relays:
                    t.join(timeout=5)
                os.remove(self.path)
                sys.stderr.flush()
                os._exit(EXIT_RANK_FAILED)

    def __enter__(self) -> dict:
        return self.job

    def __exit__(self, kind, value, tb) -> None:
        self.closing.set()
        self.watchdog.join()
        deadline = time.monotonic() + TIMEOUT_S
        try:
            for r, p in self.procs.items():
                if kind is None:     # rank 0 ended well: give each peer its end
                    try:
                        p.wait(timeout=max(0.0, deadline - time.monotonic()))
                    except subprocess.TimeoutExpired:
                        log(f"[ranks] rank {r} runs on {TIMEOUT_S:.0f} s after rank 0's end")
        finally:
            self._kill()
            for t in self.relays:
                t.join(timeout=5)
            os.remove(self.path)
        failed = self._failed()
        if kind is None and failed:
            log(f"[ranks] peer(s) exited non-zero {failed} after rank 0's part: every rank "
                "is ended")
            raise RanksFailed(f"peer(s) exited non-zero {failed}")


def _word(value: int) -> int:
    """The largest of the ranks' ``value``: one all-reduce of one word (on
    the rank's GPU under NCCL), which every rank has entered before any
    leaves."""
    on = (torch.device("cuda", torch.cuda.current_device())
          if dist.get_backend() == "nccl" else "cpu")
    t = torch.tensor([value], dtype=torch.int64, device=on)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def barrier() -> None:
    """Every rank has come here (no-op on one rank)."""
    if dist.is_initialized():
        _word(0)


def agree(go: bool) -> bool:
    """Rank 0's ``go`` on every rank (one rank: ``go``)."""
    if not dist.is_initialized():
        return go
    return bool(_word(int(go) if dist.get_rank() == 0 else 0))


def gather(obj) -> list:
    """Every rank's ``obj``, by rank (one rank: ``[obj]``)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
