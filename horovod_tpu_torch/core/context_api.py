"""Global context: the process world, rank/size queries, init/shutdown.

Counterpart of ``horovod_tpu/core/context_api.py``. The JAX package runs one
controller per host over a device mesh; the port runs what the original
Horovod ran: one process per GPU in a ``torch.distributed`` world, NCCL
between CUDA devices and gloo between CPU processes.

- ``size()`` / ``rank()``: the world size and this process's rank.
- ``local_size()`` / ``local_rank()``: processes on this host and this
  process's index among them; the CUDA device is ``cuda:local_rank``.
- ``cross_size()`` / ``cross_rank()``: the number of hosts and this host's
  index, the cross-communicator of hierarchical ops.
"""

from __future__ import annotations

import os
import socket
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .config import Config
from .exceptions import NotInitializedError
from .process_sets import ProcessSet, ProcessSetTable


class Context:
    """Singleton holding the device, the world's layout, the config and the
    process-set table."""

    def __init__(self, device: torch.device, config: Config, *, rank: int,
                 size: int, local_rank: int, local_size: int,
                 cross_rank: int, cross_size: int, owns_world: bool):
        self.device = device
        self.config = config
        self.rank = rank
        self.size = size
        self.local_rank = local_rank
        self.local_size = local_size
        self.cross_rank = cross_rank
        self.cross_size = cross_size
        self.owns_world = owns_world
        self.process_sets = ProcessSetTable(size)
        self.cpu_groups: dict = {}  # gloo groups for CPU tensors, by ranks


_context: Optional[Context] = None
_lock = threading.Lock()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _layout(rank: int, size: int):
    """(local_rank, local_size, cross_rank, cross_size) from every rank's
    hostname, gathered over a gloo group so no device is needed yet."""
    host = socket.gethostname()
    if size == 1:
        return 0, 1, 0, 1
    hosts: list = [None] * size
    dist.all_gather_object(hosts, host, group=dist.new_group(backend="gloo"))
    order = list(dict.fromkeys(hosts))  # hosts in first-rank order
    local = [r for r in range(size) if hosts[r] == host]
    return local.index(rank), len(local), order.index(host), len(order)


def init(device=None, coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         config: Optional[Config] = None) -> Context:
    """Initialise the global context. Idempotent, like the reference's
    ``InitializeHorovodOnce``.

    ``device``: ``"cuda"`` (the default) or ``"cpu"``. Without a CUDA device
    the default raises; it never carries on silently on the CPU.

    The world comes from the arguments, else from the launcher's
    environment (``HOROVOD_COORDINATOR_ADDR`` as ``host:port``,
    ``HOROVOD_NUM_PROCESSES``, ``HOROVOD_PROCESS_ID``); with none of them,
    a one-process world on a local TCP store. A ``torch.distributed`` world
    that the caller already initialised is adopted as it is.
    """
    global _context
    with _lock:
        if _context is not None:
            return _context
        dev = torch.device(device if device is not None else "cuda")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch.init(): no CUDA device is available; pass "
                "device='cpu' to run on the CPU")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {dev}")
        cfg = config or Config.from_env()
        owns = not dist.is_initialized()
        if owns:
            coord = coordinator_address or os.environ.get(
                "HOROVOD_COORDINATOR_ADDR")
            if coord:
                nproc = num_processes or int(
                    os.environ.get("HOROVOD_NUM_PROCESSES", "0")) or None
                pid = process_id if process_id is not None else (
                    int(os.environ["HOROVOD_PROCESS_ID"])
                    if "HOROVOD_PROCESS_ID" in os.environ else None)
                if nproc is None or pid is None:
                    raise ValueError(
                        "a coordinator address needs the number of "
                        "processes and this process's id "
                        "(HOROVOD_NUM_PROCESSES, HOROVOD_PROCESS_ID)")
            else:
                coord, nproc, pid = f"127.0.0.1:{_free_port()}", 1, 0
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method=f"tcp://{coord}", world_size=nproc, rank=pid)
        rank, size = dist.get_rank(), dist.get_world_size()
        local_rank, local_size, cross_rank, cross_size = _layout(rank, size)
        if dev.type == "cuda":
            dev = torch.device("cuda", local_rank)
            torch.cuda.set_device(dev)
        _context = Context(dev, cfg, rank=rank, size=size,
                           local_rank=local_rank, local_size=local_size,
                           cross_rank=cross_rank, cross_size=cross_size,
                           owns_world=owns)
        return _context


def shutdown() -> None:
    """Tear down the context, and the ``torch.distributed`` world if
    :func:`init` created it."""
    global _context
    with _lock:
        if _context is not None and _context.owns_world \
                and dist.is_initialized():
            dist.destroy_process_group()
        _context = None


def is_initialized() -> bool:
    return _context is not None


def context() -> Context:
    if _context is None:
        raise NotInitializedError()
    return _context


def device() -> torch.device:
    return context().device


def size() -> int:
    return context().size


def rank() -> int:
    return context().rank


def local_size() -> int:
    return context().local_size


def local_rank() -> int:
    return context().local_rank


def cross_size() -> int:
    return context().cross_size


def cross_rank() -> int:
    return context().cross_rank


# Build introspection (reference basics.py), answered by the installed torch.
def nccl_built() -> bool:
    return dist.is_nccl_available()


def cuda_built() -> bool:
    return torch.version.cuda is not None


def add_process_set(ranks: Sequence[int]) -> ProcessSet:
    """Collective: every rank calls it with the same ranks."""
    return context().process_sets.add(ranks)


def remove_process_set(ps: "ProcessSet | int") -> None:
    context().process_sets.remove(ps)


def global_process_set() -> ProcessSet:
    return context().process_sets.global_set
