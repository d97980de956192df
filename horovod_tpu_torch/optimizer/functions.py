"""State broadcast helpers.

Counterpart of ``horovod_tpu/optimizer/functions.py`` (reference
``horovod/torch/functions.py``): run once at startup or after a restore so
every rank starts from ``root_rank``'s parameters and optimizer state.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ..collectives import ops as _ops
from ..core import context_api as _ctx


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
    whose state is still empty, has only its hyper-parameters to send."""
    with torch.no_grad():
        for group in optimizer.param_groups:
            for p in group["params"]:
                for value in optimizer.state.get(p, {}).values():
                    if torch.is_tensor(value):
                        _ops.broadcast_(value, root_rank)
    hyper = [{k: v for k, v in g.items() if k != "params"}
             for g in optimizer.param_groups]
    if _ctx.size() > 1:
        box = [hyper]
        dist.broadcast_object_list(box, root_rank,
                                   group=_ops._cpu_group(None))
        hyper = box[0]
    for group, h in zip(optimizer.param_groups, hyper):
        group.update(h)
    return optimizer
