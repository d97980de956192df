"""State broadcast, object and join helpers.

Counterpart of ``horovod_tpu/optimizer/functions.py`` (reference
``horovod/torch/functions.py``): the broadcasts run once at startup or after
a restore so every rank starts from ``root_rank``'s parameters and optimizer
state; ``broadcast_object`` and ``allgather_object`` carry picklable Python
objects (a resume epoch, per-rank metrics) over the gloo CPU group, not
NCCL; ``join_allreduce`` is the uneven-data gradient reduction.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from ..collectives import ops as _ops
from ..collectives.join import join_allreduce as _join_allreduce
from ..core import context_api as _ctx
from ..core.process_sets import ProcessSet


def _tensors(params: Any):
    if isinstance(params, torch.nn.Module):
        return [t for t in params.state_dict().values()]
    if isinstance(params, dict):
        return list(params.values())
    return [t for _, t in params]


def broadcast_parameters(params: Any, root_rank: int = 0) -> Any:
    """Overwrite every rank's ``params`` in place with ``root_rank``'s and
    return them. ``params`` is a module, a ``state_dict()`` or an iterable of
    ``(name, tensor)``, as in the reference's
    ``hvd.broadcast_parameters(model.state_dict(), root_rank=0)``."""
    with torch.no_grad():
        for t in _tensors(params):
            _ops.broadcast_(t.data if isinstance(t, torch.nn.Parameter)
                            else t, root_rank)
    return params


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> torch.optim.Optimizer:
    """Overwrite every rank's optimizer state in place with ``root_rank``'s:
    the state tensors (moments, step counters) by broadcast, the
    hyper-parameters of each param group as an object. A fresh optimizer,
    whose state is still empty, has only its hyper-parameters to send.

    A group with a ``replica_set`` (parameters sharded over it,
    ``DistributedOptimizer``) takes its state from the set's first rank
    over the set alone, and keeps its own ``replica_set``."""
    with torch.no_grad():
        for group in optimizer.param_groups:
            rs = group.get("replica_set")
            for p in group["params"]:
                for value in optimizer.state.get(p, {}).values():
                    if not torch.is_tensor(value):
                        continue
                    if rs is None:
                        _ops.broadcast_(value, root_rank)
                    elif rs.size() > 1:
                        _ops.broadcast_(value, rs.ranks[0], process_set=rs)
    local = ("params", "replica_set")
    hyper = [{k: v for k, v in g.items() if k not in local}
             for g in optimizer.param_groups]
    if _ctx.size() > 1:
        box = [hyper]
        dist.broadcast_object_list(box, root_rank,
                                   group=_ops._cpu_group(None))
        hyper = box[0]
    for group, h in zip(optimizer.param_groups, hyper):
        group.update(h)
    return optimizer


def broadcast_object(obj: Any, root_rank: int = 0) -> Any:
    """``root_rank``'s picklable object, on every rank (reference:
    ``hvd.broadcast_object``). A world of one returns ``obj``."""
    if _ctx.size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, root_rank, group=_ops._cpu_group(None))
    return box[0]


def allgather_object(obj: Any) -> list:
    """Every rank's picklable object, in rank order, on every rank
    (reference: ``hvd.allgather_object``). A world of one gives
    ``[obj]``."""
    if _ctx.size() == 1:
        return [obj]
    out: list = [None] * _ctx.size()
    dist.all_gather_object(out, obj, group=_ops._cpu_group(None))
    return out


def join_allreduce(grads, have_data, *, op: str = _ops.Average,
                   process_set: Optional[ProcessSet] = None):
    """Uneven-data gradient reduction, of one tensor or of each of a list:
    the JAX package's rendering of ``hvd.join()``, here a call of
    :func:`horovod_tpu_torch.collectives.join.join_allreduce`.
    ``have_data`` is this rank's flag; a rank without data contributes
    zeros, and Average divides by the number of members with data (at
    least 1), so with nobody's data the result is zeros. A rank outside
    ``process_set`` reduces alone, as the JAX package's singleton groups
    do."""
    return _join_allreduce(grads, have_data, op,
                           process_set=process_set)


def join() -> int:
    """The reference's ``hvd.join()`` return value, the last rank, as the
    JAX package's shim gives it: every rank of a world of processes calls
    each collective of a step, so there is nothing to wait for. For uneven
    data use :func:`join_allreduce` (or ``collectives.join``) in the
    step."""
    return _ctx.size() - 1
