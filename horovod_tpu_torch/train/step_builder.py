"""Gradient accumulation over microbatches, and the pipeline-parallel step.

Counterpart of ``horovod_tpu/train/step_builder.py::accumulate_gradients``
and of its ``PipelineTrainState``, ``create_pipeline_train_state`` and
``make_pipeline_train_step`` (at the end of this module), with
:class:`Cadence`, the host side of the deferred expert-update pair that
JAX's ``build_program_set`` and ``make_dispatch`` share between its step
kinds.
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

import contextlib
from typing import Any, Callable, NamedTuple, Optional

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


# ------------------------------------------------- the deferred cadence

class Cadence:
    """The host side of a ``optimizer.moe_opt.DeferredPair``, shared by
    ``train.make_gspmd_deferred_train_step`` and
    :func:`make_pipeline_train_step`: a step counter, seeded from the
    state's step on the first call (so a resumed job keeps its phase, as
    JAX's ``make_dispatch`` seeds it), runs ``every - 1`` skip steps, then
    one apply step.

    On a skip step the parameters of every group that ``pair.skip``
    freezes (the expert bank) take no gradient: they are set
    ``requires_grad_(False)`` for the step, so autograd computes no dW for
    them, ``DistributedOptimizer`` reduces nothing for them, their
    ``.grad`` stays None and the optimizer leaves them and their state
    alone. Every other parameter gets its step. This is the port's
    counterpart of JAX's skip program, in which XLA drops the dead dW
    products and aliases the donated bank. An apply step is a normal step
    with the optimizer built from ``pair.apply``."""

    def __init__(self, pair):
        self.pair = pair
        self.n = None

    @contextlib.contextmanager
    def step(self, optimizer, state_step: int):
        """One step of the cadence around the body of the ``with``; yields
        the parameters frozen in it (none on an apply step).
        ``optimizer``'s groups must carry ``pair.apply``'s labels."""
        pair = self.pair
        if self.n is None:
            labels = {g.get("label") for g in optimizer.param_groups}
            if not labels <= set(pair.apply.transforms):
                raise ValueError("the state's optimizer was not built from "
                                 "pair.apply")
            self.n = int(state_step)
        self.n += 1
        frozen = []
        if self.n % pair.every:
            frozen = [p for g in optimizer.param_groups
                      if pair.skip.transforms[g["label"]].get("frozen")
                      for p in g["params"]]
        for p in frozen:
            p.requires_grad_(False)
        try:
            yield frozen
        finally:
            for p in frozen:
                p.requires_grad_(True)


# ------------------------------------------------- pipeline-parallel step

class PipelineTrainState(NamedTuple):
    step: int
    stage_params: Any  # this rank's stage (a module, or tensors)
    optimizer: torch.optim.Optimizer  # over this rank's stage alone


def create_pipeline_train_state(stage_params,
                                optimizer) -> PipelineTrainState:
    """The pipeline state of this rank: its stage's parameters and an
    optimizer over them. JAX stacks every stage's parameters ``[n_stages,
    ...]`` and vmaps the optimizer over that dim, so each stage's moments
    live with its parameters; one process holds one stage here, and its
    optimizer holds that stage's state alone."""
    return PipelineTrainState(0, stage_params, optimizer)


def make_pipeline_train_step(stage_fn: Callable, loss_fn: Callable,
                             optimizer, *, mesh, axis_name: str = "pp",
                             dp_axis_name: Optional[str] = None,
                             schedule: str = "interleaved", pair=None):
    """Pipeline-parallel train step over ``parallel/pipeline.py``:
    ``step(state, x_microbatches, targets) -> (state, loss)``.

    ``schedule="interleaved"`` (alias ``"1f1b"``) is the hand-scheduled
    1F1B; ``"gpipe"`` is autograd through the ticks and takes a
    ``dp_axis_name`` on a (dp, pp) mesh, over which the stage gradients
    and the loss are averaged. The microbatches ``[M, mb, ...]`` are this
    rank's: the same on every rank of the pp axis (stage 0 reads them, the
    last stage's targets score them), this rank's dp shard of the batch on
    a dp axis. ``optimizer`` is a torch optimizer over this rank's stage
    parameters (the state's).

    ``pair`` (an ``optimizer.moe_opt.DeferredPair``) runs the deferred
    cadence (:class:`Cadence`), as JAX's apply and skip programs do:
    ``optimizer`` must then be built from ``pair.apply``
    (``moe_opt.optimizer_for(pair.apply, stage.named_parameters())``), and
    on skip steps the stage parameters that ``pair.skip`` freezes take no
    gradient and do not move, neither they nor their state. JAX's
    sentinel does not compose with pipelines; the port has none."""
    from ..parallel.pipeline import (pipeline_1f1b_value_and_grad,
                                     pipeline_value_and_grad,
                                     stage_parameters)
    cadence = Cadence(pair) if pair is not None else None
    if schedule in ("interleaved", "1f1b"):
        if dp_axis_name is not None:
            raise ValueError(
                "the 1F1B schedule has no dp seam yet — use "
                "schedule='gpipe' with dp_axis_name, or drop the dp axis")
        vg = pipeline_1f1b_value_and_grad(stage_fn, loss_fn,
                                          mesh.axis(axis_name))
    elif schedule == "gpipe":
        dp = mesh.axis(dp_axis_name) if dp_axis_name else None
        vg = pipeline_value_and_grad(stage_fn, loss_fn, mesh.axis(axis_name),
                                     dp_axis=dp)
    else:
        raise ValueError(f"unknown schedule {schedule!r}: expected "
                         "'interleaved' (alias '1f1b') or 'gpipe'")

    def run(state: PipelineTrainState, x_microbatches, targets):
        loss, grads = vg(state.stage_params, x_microbatches, targets)
        for p, g in zip(stage_parameters(state.stage_params), grads):
            p.grad = g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return state._replace(step=state.step + 1), loss

    def step(state: PipelineTrainState, x_microbatches, targets):
        if cadence is None:
            return run(state, x_microbatches, targets)
        with cadence.step(optimizer, state.step):
            return run(state, x_microbatches, targets)

    return step
