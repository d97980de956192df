"""Gradient accumulation over microbatches.

Counterpart of ``horovod_tpu/train/step_builder.py::accumulate_gradients``.
The JAX package accumulates inside one compiled step with a ``lax.scan``;
here the microbatches run one after another, each with its own forward and
backward, and ``p.grad`` accumulates their gradients.

Nothing crosses ranks inside the loop. ``DistributedOptimizer`` with
``backward_passes_per_step = accum_steps`` counts the passes in its hooks,
launches each bucket's all-reduce once, after the last microbatch, and
divides by ``accum_steps`` once (its prescale): one all-reduce per bucket
per step, of the mean gradient.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def _split(x, a: int):
    """``x`` (a tensor, or a tuple of tensors sharing the leading dim) as
    ``a`` microbatches."""
    if isinstance(x, (tuple, list)):
        return list(zip(*(t.chunk(a) for t in x)))
    return x.chunk(a)


def _leaves(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _call(model, batch):
    return model(*batch) if isinstance(batch, (tuple, list)) else model(batch)


def accumulate_gradients(model: torch.nn.Module,
                         loss_fn: Callable[[Any, Any], torch.Tensor],
                         batch, labels, accum_steps: int) -> torch.Tensor:
    """Split the local ``batch`` and ``labels`` (shared leading dim; a batch
    may be a tuple of the model's inputs) into ``accum_steps`` microbatches
    and run forward and backward on each in order, so the BatchNorm running
    statistics thread through them as the JAX scan threads them. The
    gradients of the microbatches' losses accumulate in ``p.grad``; returns
    the mean loss, detached."""
    a = int(accum_steps)
    if a < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    for x in _leaves(batch) + _leaves(labels):
        if x.shape[0] % a:
            raise ValueError(
                f"leading batch dim {x.shape[0]} is not divisible by "
                f"accum_steps={a} (shapes are per-device: each rank passes "
                f"its own shard)")
    total = None
    for mb, y in zip(_split(batch, a), _split(labels, a)):
        loss = loss_fn(_call(model, mb), y)
        loss.backward()
        loss = loss.detach().float()
        total = loss if total is None else total + loss
    return total / a
