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
statistics. ``scan_steps``, ``autotune`` and ``sentinel`` are the
reference's options (:func:`make_train_step`), and the returned step runs
under the step monitor (``core/watchdog.py``), as the reference wraps it
in ``monitored_step``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..collectives import ops as _ops
from ..core import context_api as _ctx
from ..core import sentinel as _sentinel
from ..core import telemetry as _telemetry
from ..core.watchdog import monitored_step
from ..optimizer.functions import (broadcast_optimizer_state,
                                   broadcast_parameters)
from .step_builder import (_call, accumulate_gradients, build_program_set,
                           fold_scan, make_dispatch)


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
                    accum_steps: Optional[int] = None,
                    scan_steps: Optional[int] = None,
                    autotune: Optional[bool] = None,
                    sentinel=None):
    """Build the DP train step: ``step(state, batch, labels) -> (state,
    loss)``. ``batch`` is the model's input, or a tuple of its inputs.
    ``optimizer`` is a ``DistributedOptimizer`` over ``model``'s
    parameters; the returned loss is averaged over the ranks, as the
    reference's ``pmean``.

    ``accum_steps = a`` runs the local batch as ``a`` microbatches before
    the one update. The optimizer must have been made with
    ``backward_passes_per_step = a``: its hooks then reduce each bucket once
    a step, after the last microbatch, and divide by ``a`` once.

    ``scan_steps = k`` runs k steps over the same batch in one call
    (``step_builder.fold_scan``); the loss returned is the last step's.

    ``sentinel``: a ``core.sentinel.Sentinel``, True, or (default) the
    ``HOROVOD_SENTINEL`` config switch. Engaged, the optimizer probes its
    buckets before their all-reduces and each step gathers the ``[n, 3]``
    health vector (one small all-gather and one wait for the card, for the
    step's finite bit). A step whose gradients are not finite on every rank
    changes no parameter, no optimizer state and no BatchNorm buffer (the
    buffers are restored from a copy taken before the forward); while the
    ladder is in containment the step runs with no update at all (the
    reference's probe program). The ladder sees every step's row
    (``step_builder.make_dispatch``); the policy is ``step.sentinel``.

    ``autotune``: True — or by default ``HOROVOD_AUTOTUNE=1`` — returns a
    ``tools.autotune.StepAutotuner`` that tunes the gradient buckets'
    fusion threshold against the measured step rate while training
    (:func:`_autotuned_train_step`); ``step.chosen`` holds the knobs once
    it has converged."""
    sentinel = _sentinel.resolve(sentinel)
    if autotune is None:
        autotune = _ctx.is_initialized() and _ctx.context().config.autotune
    if autotune:
        return _autotuned_train_step(model, optimizer, loss_fn,
                                     accum_steps=accum_steps,
                                     scan_steps=scan_steps,
                                     sentinel=sentinel)
    a = 1 if accum_steps is None else int(accum_steps)
    passes = getattr(optimizer, "backward_passes_per_step", 1)
    if a != passes:
        raise ValueError(
            f"accum_steps={a} needs an optimizer made with "
            f"backward_passes_per_step={a} (it has {passes}): the step runs "
            f"{a} backward passes, and the optimizer reduces and divides "
            f"once every backward_passes_per_step passes")
    # The step owns the optimizer's gate (and its bucket probe): this
    # sentinel, or none at all. Set on each call, so two steps built over
    # one optimizer each run with their own.
    gate = sentinel if sentinel is not None else False

    def make_program(apply_update: bool):
        def step(state: TrainState, batch, labels):
            optimizer.sentinel = gate
            model.train()
            kept = None
            if sentinel is not None:
                kept = [b.detach().clone() for b in model.buffers()]
            optimizer.zero_grad(set_to_none=True)
            if a > 1:
                loss = accumulate_gradients(model, loss_fn, batch, labels, a)
            else:
                loss = loss_fn(_call(model, batch), labels)
                loss.backward()
                loss = loss.detach()
            health = None
            optimizer.synchronize()
            if sentinel is None:
                optimizer.apply_update()
                applied = True
            else:
                health = optimizer.health()
                # The update's guard: every rank's gradients finite (one
                # wait for the card; a probe step needs none).
                applied = apply_update and bool(health[:, 0].min() >= 1.0)
                if applied:
                    optimizer.apply_update()
                else:
                    with torch.no_grad():
                        for b, old in zip(model.buffers(), kept):
                            b.copy_(old)
            if _ctx.size() > 1:
                loss = _ops.allreduce(loss, _ops.Average)
                stats = batch_stats(model)
                if stats and applied:
                    with torch.no_grad():
                        for b, avg in zip(stats, _ops.grouped_allreduce(
                                stats, _ops.Average)):
                            b.copy_(avg)
            out = state._replace(step=state.step + 1)
            if sentinel is not None:
                return out, loss, health
            return out, loss

        if scan_steps is not None:
            step = fold_scan(step, scan_steps, sentinel is not None)
        return step

    programs = build_program_set(make_program, sentinel=sentinel)
    dispatch = make_dispatch(programs, sentinel=sentinel,
                             scan_steps=scan_steps)

    def marked(state, batch, labels):
        _telemetry.inc("hvd_dispatches_total", what="train_step")
        return dispatch(state, batch, labels)

    if sentinel is not None:
        marked.sentinel = sentinel
    return monitored_step(marked, what="train_step")


def _autotuned_train_step(model, optimizer, loss_fn, **build_kw):
    """``HOROVOD_AUTOTUNE=1``: a ``StepAutotuner`` that searches, live, the
    knobs that change only how the gradients travel (the reference tunes
    its fusion buffer the same propose → measure → report way):

    - ``fusion_threshold_bytes`` — the bucket size; each trial re-plans the
      optimizer's buckets under ``fusion_threshold_override``, so a knob
      set rebuilds the step and nothing is recompiled;
    - ``hierarchical`` — staged or flat all-reduce, only on a two-level
      layout of more than one node and more than one rank a node.

    ``scan_steps`` is not searched: it changes how many updates one call
    makes, a contract the caller owns."""
    from ..collectives.ops import (fusion_threshold_override,
                                   hierarchical_override)
    from ..core.logging import get_logger
    from ..tools.autotune import Autotuner, CatDim, LogIntDim, StepAutotuner

    ctx = _ctx.context()
    cfg = ctx.config

    def build(fusion_threshold_bytes, hierarchical=None):
        with fusion_threshold_override(int(fusion_threshold_bytes)):
            optimizer.replan()
        inner = make_train_step(model, optimizer, loss_fn, autotune=False,
                                **build_kw)

        def stepped(*args, **kwargs):
            with hierarchical_override(hierarchical):
                return inner(*args, **kwargs)
        return stepped

    space = {"fusion_threshold_bytes": LogIntDim(1 << 20, 1 << 28)}
    if ctx.two_level and ctx.cross_size > 1 and ctx.local_size > 1:
        space["hierarchical"] = CatDim((False, True))
    tuner = Autotuner(space, warmup_trials=cfg.autotune_warmup_samples,
                      max_trials=cfg.autotune_max_samples,
                      log_path=cfg.autotune_log)
    get_logger().info(
        "HOROVOD_AUTOTUNE: tuning the fusion threshold live (%d warmup / "
        "%d max samples, %d steps each)", cfg.autotune_warmup_samples,
        cfg.autotune_max_samples, cfg.autotune_steps_per_sample)
    return StepAutotuner(build, space,
                         steps_per_trial=cfg.autotune_steps_per_sample,
                         tuner=tuner)
