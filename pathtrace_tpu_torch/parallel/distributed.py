"""Multi-process launch over ``torch.distributed``: one process per GPU.

Counterpart of ``pathtrace_tpu/parallel/distributed.py``. Each process is a
rank with one device (``cuda:LOCAL_RANK``, else ``cuda:(rank %
device_count)``, or the CPU when asked); :func:`initialize` joins the ranks
into one process group, and :func:`make_global_mesh` lays them out as a
``(dp, sp)`` mesh for the renderers of
:mod:`pathtrace_tpu_torch.parallel.sharding`.

* The only collective on the render path is the ``all_reduce`` of the
  per-pixel radiance sums over the ``sp`` group; the ``dp`` axis has none
  until the final gather. :func:`make_global_mesh` orders the ranks
  node-major, so that each ``sp`` group sits within one node whenever ``sp``
  divides the ranks a node has.
* **Backend.** NCCL when every rank has a GPU of its own; gloo on the CPU
  and when ranks share a GPU (NCCL refuses two ranks on one device, as on a
  one-GPU machine). The choice is made from the arguments and the layout
  (each rank's host name and device, exchanged through the coordinator's
  store) before the group forms, and printed on stderr. Under gloo a collective on
  a CUDA tensor goes through a host copy (:func:`all_reduce_sum`).
* Everything degrades to one process: with nothing asking for distribution
  :func:`initialize` is a no-op and :func:`make_global_mesh` is the 1x1
  mesh.

Launch (one command per rank)::

    python -m pathtrace_tpu_torch --coordinator host0:29500 \\
        --num-processes 4 --process-id $i animate ...

or set ``PT_COORDINATOR``/``PT_NUM_PROCESSES``/``PT_PROCESS_ID``, or launch
under ``torchrun`` (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``), and call :func:`initialize`
with no arguments.

Left behind from the JAX module: ``host_shard_to_global``, which builds a
JAX global array from a host-replicated value (a rank computes its own
window offsets here), and JAX's many devices per process (the virtual
8-device CPU mesh): one rank per process, one device per rank, is the
port's layout.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 300.0   # rendezvous and collective timeout: a missing peer fails, never hangs
_PLACE_KEY = "pathtrace_tpu_torch/place/"

_HOSTS: list = []      # each rank's host name, by rank, once the group has formed
_MESHES: dict = {}     # (dp, sp) -> Mesh: each layout's process groups, made once


def _env_int(name: str) -> Optional[int]:
    return int(os.environ[name]) if name in os.environ else None


def device_index(rank: int, n_gpus: int, local_rank: Optional[int] = None) -> int:
    """The GPU a rank takes: ``LOCAL_RANK``, else its rank, modulo the GPUs
    of its node (ranks past them share)."""
    return (rank if local_rank is None else local_rank) % n_gpus


def choose_backend(places) -> tuple[str, str]:
    """``(backend, why)`` for the ranks at ``places`` (each rank's
    ``(host, device)``, by rank): NCCL when every rank has a GPU of its
    own, gloo on the CPU or when two ranks share a GPU."""
    devices = [dev for _, dev in places]
    if not all(dev.startswith("cuda") for dev in devices):
        return "gloo", "CPU ranks"
    shared = len(set(places)) < len(places)
    n_hosts = len({host for host, _ in places})
    if shared:
        return "gloo", f"{len(places)} ranks share {len(set(places))} GPU(s) on {n_hosts} node(s)"
    return "nccl", f"one GPU a rank, {len(places)} on {n_hosts} node(s)"


def _rendezvous(host: str, port: int, n: int, rank: int, timeout_s: float):
    """The group's store: rank 0 serves it (torchrun's agent already does
    when ``TORCHELASTIC_USE_AGENT_STORE`` is set), and every rank joins."""
    serve = rank == 0 and os.environ.get("TORCHELASTIC_USE_AGENT_STORE") != "True"
    return dist.TCPStore(host, port, n, serve, datetime.timedelta(seconds=timeout_s))


def _exchange_places(store, n: int, rank: int, place: tuple) -> list:
    """Every rank's ``(host, device)``, by rank, through ``store``."""
    store.set(f"{_PLACE_KEY}{rank}", "\0".join(place))
    return [tuple(store.get(f"{_PLACE_KEY}{r}").decode().split("\0")) for r in range(n)]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = TIMEOUT_S,
) -> None:
    """Join (or form) the process group of a multi-process run. Idempotent.

    Arguments default to ``PT_COORDINATOR`` / ``PT_NUM_PROCESSES`` /
    ``PT_PROCESS_ID``, then to torchrun's ``MASTER_ADDR:MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK``. A no-op when neither arguments nor the
    environment ask for distribution. ``process_id`` may be left out only
    for one process.

    ``device`` is ``"cuda"`` (the default; the rank takes
    ``cuda:LOCAL_RANK``, else ``cuda:(rank % device_count)``, and it becomes
    the current device) or ``"cpu"``. Before the group forms, the ranks
    meet at the coordinator's store (``tcp://host:port``) and exchange their
    host names and devices; ``backend`` None then picks NCCL when every
    rank has a GPU of its own, else gloo (:func:`choose_backend`), the same
    choice on every rank. Asking for NCCL where it cannot run raises. The
    group forms on that store. A peer that never joins fails the call after
    ``timeout_s``.
    """
    if dist.is_initialized():
        return
    addr = coordinator_address or os.environ.get("PT_COORDINATOR")
    n = num_processes if num_processes is not None else _env_int("PT_NUM_PROCESSES")
    rank = process_id if process_id is not None else _env_int("PT_PROCESS_ID")
    if addr is None and n is None and "MASTER_ADDR" in os.environ:
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        n, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
    if addr is None and n is None:
        return
    if addr is None or n is None:
        raise ValueError("a multi-process run needs both a coordinator address and the "
                         "number of processes")
    if rank is None and n == 1:
        rank = 0
    if rank is None or not 0 <= rank < n:
        raise ValueError(f"process id {rank} is not a rank of {n} processes")
    host, port = addr.rsplit(":", 1)

    kind = torch.device(device or "cuda").type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda: no CUDA device is available")
        dev = torch.device("cuda", device_index(rank, torch.cuda.device_count(),
                                                _env_int("LOCAL_RANK")))
    elif kind == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"device {device!r}: cuda or cpu")
    print(f"pathtrace_tpu_torch: rank {rank} of {n} on {dev}, joining tcp://{addr}",
          file=sys.stderr, flush=True)
    store = _rendezvous(host.strip("[]"), int(port), n, rank, timeout_s)
    places = _exchange_places(store, n, rank, (socket.gethostname(), str(dev)))
    chosen, why = choose_backend(places)
    backend = backend or chosen
    if backend == "nccl" and chosen != "nccl":
        raise ValueError(f"backend nccl needs one GPU a rank ({why})")
    if kind == "cuda":
        torch.cuda.set_device(dev)
    print(f"pathtrace_tpu_torch: rank {rank} of {n} on {dev}, backend {backend} ({why})",
          file=sys.stderr, flush=True)
    dist.init_process_group(backend, store=store, world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _HOSTS[:] = [h for h, _ in places]


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    """This process's rank (0 when not distributed), as ``jax.process_index``."""
    return dist.get_rank() if dist.is_initialized() else 0


def shutdown() -> None:
    """Leave the process group, if one formed: ``destroy_process_group``
    frees it and every mesh's groups, and the meshes are forgotten."""
    _MESHES.clear()
    _HOSTS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(dp, sp)`` layout of the ranks: ``ranks[d, s]`` renders pixel (or
    frame) window ``d`` and sample window ``s``. ``coord`` is this rank's
    ``(d, s)``; ``sp_group`` holds the ranks ``ranks[d, :]`` (the sample
    ``all_reduce``) and ``dp_group`` the ranks ``ranks[:, s]`` (the window
    gather). Without a process group both are None and the mesh is 1x1."""

    ranks: np.ndarray
    coord: tuple
    dp_group: object = None
    sp_group: object = None

    @property
    def shape(self) -> dict:
        return {"dp": self.ranks.shape[0], "sp": self.ranks.shape[1]}

    def gather_dp(self, x) -> np.ndarray:
        """Every window's ``x`` on every rank: ``(dp, *x.shape)`` in ``d``
        order, from this rank's ``dp`` group."""
        members = self.ranks[:, self.coord[1]]
        parts = gather_global(np.asarray(_host(x))[None], self.dp_group)
        return parts[np.argsort(np.argsort(members))]    # group order is ascending rank

    def gather_all(self, x) -> np.ndarray:
        """Every rank's ``x`` on every rank: ``(dp, sp, *x.shape)``."""
        return gather_global(np.asarray(_host(x))[None])[self.ranks]


def mesh_layout(hosts, dp: Optional[int] = None, sp: Optional[int] = None) -> np.ndarray:
    """The ``(dp, sp)`` array of ranks for ranks on ``hosts`` (one host name
    a rank, by rank), node-major: ranks ordered by (first rank of their
    node, rank), so each run of ``sp`` consecutive ranks, one sample
    ``all_reduce`` group, sits within one node whenever ``sp`` divides the
    ranks a node has (or is a multiple of it). Raises ``ValueError`` when
    ``dp * sp`` is not the number of ranks, or ``sp`` cannot be
    node-contained."""
    n = len(hosts)
    if dp is None and sp is None:
        dp, sp = n, 1
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"mesh {dp}x{sp} != {n} ranks")
    first = {}
    for r, h in enumerate(hosts):
        first.setdefault(h, r)
    local = max(list(hosts).count(h) for h in first)
    if sp > 1 and (local % sp) and (sp % local):
        raise ValueError(
            f"sp={sp} cannot be host-contained with {local} ranks/host; the sample "
            "all_reduce would cross nodes: pick sp dividing the per-host rank count "
            "(or a multiple of it)")
    order = sorted(range(n), key=lambda r: (first[hosts[r]], r))
    return np.asarray(order).reshape(dp, sp)


def make_global_mesh(dp: Optional[int] = None, sp: Optional[int] = None) -> Mesh:
    """A ``(dp, sp)`` mesh over every rank (:func:`mesh_layout` of the
    ranks' host names), with this rank's coordinate and its ``dp`` and
    ``sp`` process groups. Each layout's groups are made once, on its first
    call, and kept until :func:`shutdown`; every rank must make its first
    call of each layout, in the same order."""
    if not dist.is_initialized():
        return Mesh(mesh_layout([socket.gethostname()], dp, sp), (0, 0))
    if not _HOSTS:    # a group formed without initialize()
        hosts = [None] * dist.get_world_size()
        dist.all_gather_object(hosts, socket.gethostname())
        _HOSTS[:] = hosts
    ranks = mesh_layout(_HOSTS, dp, sp)
    if ranks.shape not in _MESHES:
        d, s = (int(v) for v in np.argwhere(ranks == dist.get_rank())[0])
        # new_group is collective: every rank creates every group, in one order.
        sp_groups = [dist.new_group(row.tolist()) for row in ranks]
        dp_groups = [dist.new_group(col.tolist()) for col in ranks.T]
        _MESHES[ranks.shape] = Mesh(ranks, (d, s), dp_groups[s], sp_groups[d])
    return _MESHES[ranks.shape]


def _host(x):
    return x.cpu() if isinstance(x, torch.Tensor) else x


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (None or one rank: unchanged). A
    CUDA tensor under gloo is reduced through a host copy."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def gather_global(x, group=None) -> np.ndarray:
    """Every rank's ``x`` on every rank of ``group`` (None: the world) as
    numpy, concatenated along axis 0 in ascending rank order; ``x`` itself
    when there is no process group. The parts may differ in length."""
    x = np.asarray(_host(x))
    if not dist.is_initialized():
        return x
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, x, group=group)
    return np.concatenate(parts)
