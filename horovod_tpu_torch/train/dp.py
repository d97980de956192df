"""Data-parallel training harness — the minimum end-to-end slice.

Counterpart of ``horovod_tpu/train/dp.py``: the loop every Horovod example
assembles by hand — init → broadcast the parameters → per-step forward and
backward → ``DistributedOptimizer`` all-reduce → optimizer step. The JAX
package compiles the whole step into one program; here it runs eagerly, and
the gradient all-reduces overlap backward through the optimizer's hooks.

Each rank passes its own shard of the global batch. ``accum_steps`` splits
it into microbatches (:func:`~horovod_tpu_torch.train.step_builder.
accumulate_gradients`). With more than one rank the step averages the loss
and, after the update, the model's BatchNorm running statistics, as the JAX
step does. ``HOROVOD_HIERARCHICAL_ALLREDUCE`` reaches every Average of the
step through ``collectives/ops.py``: the gradient buckets, the loss and the
statistics. This slice leaves out the reference's ``scan_steps``,
``autotune`` and ``sentinel`` options (listed in ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..collectives import ops as _ops
from ..core import context_api as _ctx
from ..optimizer.functions import (broadcast_optimizer_state,
                                   broadcast_parameters)
from .step_builder import _call, accumulate_gradients


class TrainState(NamedTuple):
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def create_train_state(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer,
                       broadcast: bool = True) -> TrainState:
    """Bundle the model and its optimizer; broadcast the parameters, the
    buffers (BatchNorm's running statistics) and the optimizer state from
    rank 0 so all ranks agree (reference: ``hvd.broadcast_parameters`` at
    startup)."""
    if broadcast:
        broadcast_parameters(model.state_dict())
        broadcast_optimizer_state(optimizer)
    return TrainState(0, model, optimizer)


def batch_stats(model: torch.nn.Module):
    """The model's floating-point buffers: the running statistics of its
    BatchNorm layers, the JAX state's ``batch_stats`` (an integer buffer
    such as torch's ``num_batches_tracked`` has no flax counterpart)."""
    return [b for b in model.buffers() if b.is_floating_point()]


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    loss_fn: Callable[[Any, Any], torch.Tensor], *,
                    accum_steps: Optional[int] = None):
    """Build the DP train step: ``step(state, batch, labels) -> (state,
    loss)``. ``batch`` is the model's input, or a tuple of its inputs.
    ``optimizer`` is a ``DistributedOptimizer`` over ``model``'s
    parameters; the returned loss is averaged over the ranks, as the
    reference's ``pmean``.

    ``accum_steps = a`` runs the local batch as ``a`` microbatches before
    the one update. The optimizer must have been made with
    ``backward_passes_per_step = a``: its hooks then reduce each bucket once
    a step, after the last microbatch, and divide by ``a`` once."""
    a = 1 if accum_steps is None else int(accum_steps)
    passes = getattr(optimizer, "backward_passes_per_step", 1)
    if a != passes:
        raise ValueError(
            f"accum_steps={a} needs an optimizer made with "
            f"backward_passes_per_step={a} (it has {passes}): the step runs "
            f"{a} backward passes, and the optimizer reduces and divides "
            f"once every backward_passes_per_step passes")

    def step(state: TrainState, batch, labels):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if a > 1:
            loss = accumulate_gradients(model, loss_fn, batch, labels, a)
        else:
            loss = loss_fn(_call(model, batch), labels)
            loss.backward()
            loss = loss.detach()
        optimizer.step()
        if _ctx.size() > 1:
            loss = _ops.allreduce(loss, _ops.Average)
            stats = batch_stats(model)
            if stats:
                with torch.no_grad():
                    for b, avg in zip(stats, _ops.grouped_allreduce(
                            stats, _ops.Average)):
                        b.copy_(avg)
        return state._replace(step=state.step + 1), loss

    return step
