"""Data-parallel training harness — the minimum end-to-end slice.

Counterpart of ``horovod_tpu/train/dp.py``: the loop every Horovod example
assembles by hand — init → broadcast the parameters → per-step forward and
backward → ``DistributedOptimizer`` all-reduce → optimizer step. The JAX
package compiles the whole step into one program; here it runs eagerly, and
the gradient all-reduces overlap backward through the optimizer's hooks.

Each rank passes its own shard of the global batch. This slice leaves out
the reference's ``scan_steps``, ``accum_steps``, ``autotune`` and
``sentinel`` options (listed in ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..collectives import ops as _ops
from ..core import context_api as _ctx
from ..optimizer.functions import (broadcast_optimizer_state,
                                   broadcast_parameters)


class TrainState(NamedTuple):
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def create_train_state(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer,
                       broadcast: bool = True) -> TrainState:
    """Bundle the model and its optimizer; broadcast the parameters and the
    optimizer state from rank 0 so all ranks agree (reference:
    ``hvd.broadcast_parameters`` at startup)."""
    if broadcast:
        broadcast_parameters(model.state_dict())
        broadcast_optimizer_state(optimizer)
    return TrainState(0, model, optimizer)


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    loss_fn: Callable[[Any, Any], torch.Tensor]):
    """Build the DP train step: ``step(state, batch, labels) -> (state,
    loss)``. ``optimizer`` is a ``DistributedOptimizer`` over ``model``'s
    parameters; the returned loss is averaged over the ranks, as the
    reference's ``pmean``."""

    def step(state: TrainState, batch, labels):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(batch), labels)
        loss.backward()
        optimizer.step()
        loss = loss.detach()
        if _ctx.size() > 1:
            loss = _ops.allreduce(loss, _ops.Average)
        return state._replace(step=state.step + 1), loss

    return step
