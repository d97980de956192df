"""The startup broadcasts, the object helpers and ``SyncBatchNorm`` under
upstream Horovod's signatures.

The port has these functions already (``optimizer/functions.py``,
``optimizer/sync_batch_norm.py``); the frontend calls them with
upstream's arguments (``horovod/torch/functions.py``:
``root_rank``, ``name``, ``process_set``) and copies nothing.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from ..collectives import ops as _ops
from ..core import context_api as _ctx
from ..core.process_sets import ProcessSet
from ..optimizer import functions as _fn
from ..optimizer.sync_batch_norm import SyncBatchNorm as _SyncBatchNorm


def _global(process_set: Optional[ProcessSet]) -> bool:
    return process_set is None or process_set.process_set_id == 0


def broadcast_parameters(params, root_rank: int = 0,
                         process_set: Optional[ProcessSet] = None) -> None:
    """Broadcast a ``state_dict()`` or ``named_parameters()`` from
    ``root_rank`` (a global rank, a member of ``process_set``)."""
    if _global(process_set):
        _fn.broadcast_parameters(params, root_rank)
        return
    items = params.values() if isinstance(params, dict) \
        else (t for _, t in params)
    with torch.no_grad():
        for t in items:
            if torch.is_tensor(t):
                _ops.broadcast_(t.data, root_rank, process_set=process_set)


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0,
                              process_set: Optional[ProcessSet] = None
                              ) -> None:
    """Broadcast the optimizer's state and hyper-parameters from
    ``root_rank``, over the whole world."""
    if not _global(process_set):
        raise ValueError("broadcast_optimizer_state takes the global "
                         "process set in the port")
    _fn.broadcast_optimizer_state(optimizer, root_rank)


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None) -> Any:
    """``root_rank``'s picklable object on every member (``name`` is
    accepted for signature parity: the CPU group orders the calls)."""
    if _global(process_set):
        return _fn.broadcast_object(obj, root_rank)
    if _ctx.rank() not in process_set.ranks:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, root_rank,
                               group=_ops._cpu_group(process_set))
    return box[0]


def allgather_object(obj: Any, name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None) -> list:
    """Every member's picklable object, in rank order."""
    if _global(process_set):
        return _fn.allgather_object(obj)
    out: list = [None] * process_set.size()
    dist.all_gather_object(out, obj, group=_ops._cpu_group(process_set))
    return out


def SyncBatchNorm(num_features: int, eps: float = 1e-5,
                  momentum: float = 0.1, affine: bool = True,
                  track_running_stats: bool = True) -> _SyncBatchNorm:
    """The port's ``SyncBatchNorm`` with upstream's arguments: torch's
    ``momentum`` (the weight of the new statistics) is flax's ``1 -
    momentum``. The port's module has an affine transform and running
    statistics always, and keeps flax's biased running variance."""
    if not (affine and track_running_stats):
        raise ValueError("the port's SyncBatchNorm is affine and tracks "
                         "running statistics")
    dev = _ctx.device() if _ctx.is_initialized() else None
    return _SyncBatchNorm(num_features, momentum=1.0 - momentum, eps=eps,
                          device=dev)
