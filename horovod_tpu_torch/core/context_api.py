"""Global context: the process world, rank/size queries, init/shutdown.

Counterpart of ``horovod_tpu/core/context_api.py``. The JAX package runs one
controller per host over a device mesh; the port runs what the original
Horovod ran: one process per GPU in a ``torch.distributed`` world, NCCL
between CUDA devices and gloo between CPU processes.

- ``size()`` / ``rank()``: the world size and this process's rank.
- ``local_size()`` / ``local_rank()``: the intra-node size and this
  process's index within its node.
- ``cross_size()`` / ``cross_rank()``: the number of nodes and this node's
  index, the cross-communicator of hierarchical ops.

The two-level layout (cross x intra) is the counterpart of the JAX package's
2-axis mesh (``init(mesh=...)``, or the automatic cross-process x
local-device mesh). By default it is read from the hosts: one node a host.
A layout can be declared instead, with ``init(mesh=(cross, intra))`` or the
launcher's ``HOROVOD_LOCAL_SIZE`` (the reference runner's ``exec_run.py``
exports it), so one host can stand in for several nodes. Ranks are laid out
node-major, rank = cross_rank * local_size + local_rank. A declared layout
only shapes the groups of the hierarchical collectives: the CUDA device stays
``cuda:<this process's index among the processes of its host>``, so two ranks
of one host never share a card.
"""

from __future__ import annotations

import os
import socket
import threading
from typing import Optional, Sequence, Tuple

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
                 cross_rank: int, cross_size: int, owns_world: bool,
                 two_level: bool = True):
        self.device = device
        self.config = config
        self.rank = rank
        self.size = size
        self.local_rank = local_rank
        self.local_size = local_size
        self.cross_rank = cross_rank
        self.cross_size = cross_size
        #: The layout is node-major and every node has ``local_size`` ranks,
        #: so the hierarchical collectives can run over it.
        self.two_level = two_level
        self.owns_world = owns_world
        self.process_sets = ProcessSetTable(size)
        self.cpu_groups: dict = {}  # gloo groups for CPU tensors, by ranks

    def layout_groups(self):
        """``(intra group, intra ranks, cross group, cross ranks)`` of this
        rank: its node, and the ranks of the other nodes at its local index.
        Made on first use, every node's and every index's, on every rank in
        the same order (``new_group`` is collective)."""
        if not self.two_level:
            raise ValueError(
                "the hierarchical collectives need a node-major layout with "
                "the same number of ranks on every node; this world has "
                "ranks per node that differ or interleave")
        return self.process_sets.layout_groups(self.rank, self.cross_size,
                                               self.local_size)


_context: Optional[Context] = None
_lock = threading.Lock()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _layout(rank: int, size: int):
    """(local_rank, local_size, cross_rank, cross_size, node-major and
    even) from every rank's hostname, gathered over a gloo group so no
    device is needed yet."""
    host = socket.gethostname()
    if size == 1:
        return 0, 1, 0, 1, True
    hosts: list = [None] * size
    dist.all_gather_object(hosts, host, group=dist.new_group(backend="gloo"))
    order = list(dict.fromkeys(hosts))  # hosts in first-rank order
    local = [r for r in range(size) if hosts[r] == host]
    per = size // len(order)
    even = per * len(order) == size and all(hosts[r] == order[r // per]
                                            for r in range(size))
    return local.index(rank), len(local), order.index(host), len(order), even


def _declared_layout(mesh: Optional[Tuple[int, int]], size: int):
    """``(cross, intra)`` from ``mesh`` or ``HOROVOD_LOCAL_SIZE``, or None
    when neither declares a layout."""
    if mesh is None:
        local = os.environ.get("HOROVOD_LOCAL_SIZE")
        if not local:
            return None
        if int(local) < 1 or size % int(local):
            raise ValueError(f"HOROVOD_LOCAL_SIZE={local} does not divide "
                             f"the world size {size}")
        return size // int(local), int(local)
    cross, intra = (int(n) for n in mesh)
    if cross < 1 or intra < 1 or cross * intra != size:
        raise ValueError(f"mesh {tuple(mesh)} (cross, intra) does not "
                         f"cover the world size {size}")
    return cross, intra


def init(device=None, coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         config: Optional[Config] = None,
         mesh: Optional[Tuple[int, int]] = None) -> Context:
    """Initialise the global context. Idempotent, like the reference's
    ``InitializeHorovodOnce``.

    ``device``: ``"cuda"`` (the default) or ``"cpu"``. Without a CUDA device
    the default raises; it never carries on silently on the CPU.

    The world comes from the arguments, else from the launcher's
    environment (``HOROVOD_COORDINATOR_ADDR`` as ``host:port``,
    ``HOROVOD_NUM_PROCESSES``, ``HOROVOD_PROCESS_ID``); with none of them,
    a one-process world on a local TCP store. A ``torch.distributed`` world
    that the caller already initialised is adopted as it is.

    ``mesh``: the ``(cross, intra)`` sizes of a declared two-level layout,
    as the JAX package's 2-axis ``mesh`` (module doc); else
    ``HOROVOD_LOCAL_SIZE`` declares the intra size; else one node a host.
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
            _declared_layout(mesh, nproc)  # reject it before a world starts
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method=f"tcp://{coord}", world_size=nproc, rank=pid)
        rank, size = dist.get_rank(), dist.get_world_size()
        declared = _declared_layout(mesh, size)
        host_rank, local_size, cross_rank, cross_size, even = _layout(rank,
                                                                       size)
        local_rank = host_rank
        if declared is not None:
            cross_size, local_size = declared
            cross_rank, local_rank = divmod(rank, local_size)
            even = True
        if dev.type == "cuda":
            dev = torch.device("cuda", host_rank)
            torch.cuda.set_device(dev)
        _context = Context(dev, cfg, rank=rank, size=size,
                           local_rank=local_rank, local_size=local_size,
                           cross_rank=cross_rank, cross_size=cross_size,
                           owns_world=owns, two_level=even)
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
