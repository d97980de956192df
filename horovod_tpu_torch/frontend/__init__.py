"""``horovod_tpu_torch.frontend`` — upstream Horovod's ``horovod.torch`` API
on the port.

Every public name of ``horovod_tpu/torch/__init__.py``, so a script written
for it, or for upstream Horovod, runs with one changed line::

    from horovod_tpu_torch import frontend as hvd

The collectives take integer handles and are matched by name through a
negotiation thread (``mpi_ops.py``). Where the port already has a function
(``DistributedOptimizer``, ``SyncBatchNorm``, the startup broadcasts, the
object helpers, ``Compression``) the frontend exports it under upstream's
signature and copies nothing. The subpackage is not called ``torch``: a
subpackage of that name would become an attribute of ``horovod_tpu_torch``
and could shadow a module-level ``import torch`` there.

``init`` runs on the card unless the caller passes ``device="cpu"``, and
raises without CUDA. The build probes say what is true of the installed
torch: NCCL and gloo through ``torch.distributed``, CUDA or ROCm as built,
and no MPI, DDL or oneCCL.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..collectives.compression import Compression
from ..core import context_api as _ctx
from ..core.context_api import (cross_rank, cross_size, cuda_built,
                                global_process_set, local_rank, local_size,
                                nccl_built, rank, remove_process_set, size)
from ..core.process_sets import ProcessSet
from . import mpi_ops as _mpi_ops
from .functions import (SyncBatchNorm, allgather_object, broadcast_object,
                        broadcast_optimizer_state, broadcast_parameters)
from .mpi_ops import (Adasum, Average, Max, Min, Product, Sum, allgather,
                      allgather_async, allreduce, allreduce_,
                      allreduce_async, allreduce_async_,
                      allreduce_fused_async_, alltoall, alltoall_async,
                      barrier, broadcast, broadcast_, broadcast_async,
                      broadcast_async_, grouped_allgather,
                      grouped_allgather_async, grouped_allreduce,
                      grouped_allreduce_, grouped_allreduce_async,
                      grouped_allreduce_async_, grouped_reducescatter,
                      grouped_reducescatter_async, join, negotiation_stats,
                      poll, reducescatter, reducescatter_async,
                      sparse_allreduce_async, synchronize)
from .optimizer import DistributedOptimizer


def init(comm=None, process_sets: Optional[Sequence] = None, device=None,
         **kwargs) -> None:
    """Initialise the port (``core.context_api.init``, which takes
    ``device`` and the rest of ``kwargs``) and start the frontend's
    negotiation thread. ``process_sets``: rank lists (or process sets) to
    add, in order. Collective; idempotent."""
    if comm is not None:
        raise ValueError("the port has no MPI communicator; the world comes "
                         "from torch.distributed")
    _ctx.init(device=device, **kwargs)
    _mpi_ops.start()
    for ps in process_sets or ():
        add_process_set(ps.ranks if isinstance(ps, ProcessSet) else ps)


def shutdown() -> None:
    """Stop the negotiation thread (once every rank asks) and tear down the
    port's context. Collective."""
    _mpi_ops.stop()
    _ctx.shutdown()


def is_initialized() -> bool:
    return _mpi_ops._state is not None


def add_process_set(ranks) -> ProcessSet:
    """Collective: every rank calls it with the same ranks (or process
    set). The frontend's own group over them is made with the set's, as
    for a set added through the port's top level."""
    return _ctx.add_process_set(ranks.ranks if isinstance(ranks, ProcessSet)
                                else ranks)


def mpi_enabled() -> bool:
    return False


def mpi_built() -> bool:
    return False


def gloo_enabled() -> bool:
    return dist.is_gloo_available()


def gloo_built() -> bool:
    return dist.is_gloo_available()


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def rocm_built() -> bool:
    return torch.version.hip is not None
