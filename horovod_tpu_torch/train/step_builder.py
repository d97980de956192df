"""The step machinery the train steps share: the program set, the host
dispatch, scan folding, gradient accumulation and the pipeline step.

Counterpart of ``horovod_tpu/train/step_builder.py``: ``build_program_set``,
``make_dispatch``, ``fold_scan``, ``accumulate_gradients``,
``PipelineTrainState``, ``create_pipeline_train_state``,
``make_pipeline_train_step`` and ``export_decode_params`` (the training to
serving seam), with :class:`Cadence`, the host side of the deferred
expert-update pair.

In torch there are no compiled programs. The JAX package builds up to three
(``apply``, a cadence's ``skip``, the sentinel's no-update ``probe``); here
``apply`` and ``probe`` are one step function called with ``apply_update``,
and :func:`build_program_set` keeps the reference's table of them. The
cadence's ``skip`` is :class:`Cadence`, which the deferred and pipeline
steps run. :func:`make_dispatch` is the reference's dispatcher over the
sentinel's programs, with its counter seeded from ``state.step``. :func:`fold_scan` runs k steps over the same batch in one
call, keeping the losses and the health rows on the card until one fetch
at the end.

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
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from ..core import sentinel as _sentinel


# ------------------------------------------------------------ program set

def build_program_set(make_program: Callable[[bool], Any], *,
                      sentinel=None) -> Dict[str, Any]:
    """The step variants the sentinel needs, as the reference's table:
    ``apply`` always (``make_program(True)``); the sentinel adds ``probe``
    (``make_program(False)``: no update anywhere, the suspect state held).
    ``make_program(apply_update)`` returns a step callable. The
    reference's cadence program (``skip``) is the deferred step's
    :class:`Cadence` here."""
    return {"apply": make_program(True),
            "probe": make_program(False) if sentinel is not None else None}


# --------------------------------------------------------- host dispatch

def make_dispatch(programs: Dict[str, Any], *, sentinel=None,
                  scan_steps: Optional[int] = None):
    """The host-side dispatcher over a program set (the reference's).

    Per call: the sentinel's containment state picks ``probe``, otherwise
    ``apply`` runs. Without a sentinel ``apply`` is returned as it is. The
    step counter is seeded from ``state.step`` on the first call and
    advances by ``scan_steps`` a call. The programs return ``(state, loss,
    health)``, health ``[n, 3]`` or ``[k, n, 3]``; the ladder is fed every
    row in order, stopping at the first rollback, evict or abort, and the
    caller gets ``(state, loss)``."""
    if sentinel is None:
        return programs["apply"]
    k = int(scan_steps or 1)
    step_apply, step_probe = programs["apply"], programs["probe"]
    counter = {"n": None}

    def dispatch(state, *rest):
        if counter["n"] is None:
            counter["n"] = int(state.step)
        base = counter["n"]
        counter["n"] += k
        fn = step_probe if sentinel.in_containment else step_apply
        new_state, loss, health = fn(state, *rest)
        raw = health.detach().cpu().numpy()
        rows = raw if raw.ndim == 3 else raw[None]  # [k, n, 3]
        for i, row in enumerate(rows):
            action = sentinel.observe(_sentinel.decode_health(row),
                                      base + i + 1)
            if action.kind == "rollback":
                new_state = sentinel.do_rollback(new_state)
                break
            if action.kind in ("evict", "abort"):
                sentinel.do_evict(action)
                break
        return new_state, loss

    return dispatch


# ---------------------------------------------------------- scan folding

def fold_scan(inner: Callable, scan_steps: int, with_health: bool):
    """k consecutive calls of ``inner(state, *data)`` over the same batch
    in one call (the reference's ``lax.scan`` fold). Returns the last
    step's loss and, with the sentinel, the ``[k, n, 3]`` stack of the
    steps' health rows; both stay on the card. Each inner step guards its
    own update (``inner`` decides it from its health), so a non-finite
    inner step touches nothing whatever the ladder decides after."""
    k = int(scan_steps)

    def stepped(state, *data):
        healths = []
        for _ in range(k):
            out = inner(state, *data)
            state, loss = out[0], out[1]
            if with_health:
                healths.append(out[2])
        if with_health:
            return state, loss, torch.stack(healths)
        return state, loss
    return stepped


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


# ---------------------------------------------------- training -> serving

def _decode_dtype(key: str, cfg) -> torch.dtype:
    """The dtype the decode functions read the parameter at ``key`` in:
    f32 for the embedding table (rows gathered, then cast), the norm
    scales and the router (the f32 islands), the compute dtype for every
    other matrix."""
    if key == "embedding" or key.endswith((".scale", "router.weight")):
        return torch.float32
    return cfg.dtype


def export_decode_params(source, cfg=None) -> Dict[str, torch.Tensor]:
    """The training -> serving seam: the flat decode parameters that
    ``models/decode.py`` consumes, under the port's ``state_dict`` names.

    ``source`` is a port ``Llama`` or ``Mixtral`` (its ``cfg`` is used), or
    a ``state_dict`` of one with ``cfg`` given. A model built on a mesh
    holds blocks: each is gathered over every axis it is split over except
    a tp split that the decode plan shares (``models.decode.
    decode_leaf_shard_axis``: heads and the MLP or expert width), so the
    result is this rank's decode shard; the vocabulary's tp split of the
    training plan is gathered whole. A plain ``state_dict`` is taken as
    whole (or as a decode shard already).

    Returns detached copies, no optimizer state. The matrix weights are
    cast to the compute dtype once here, where JAX casts them at every
    use (equal values; a cast a step at 8B would add about 16 GB of
    traffic a step); the embedding, the norm scales and the router stay
    f32."""
    from ..models.decode import decode_leaf_shard_axis
    from ..parallel.sharding import _all_gather, placement_of
    if isinstance(source, torch.nn.Module):
        cfg = source.cfg if cfg is None else cfg
        tensors = dict(source.named_parameters())
    else:
        if cfg is None:
            raise ValueError("a state_dict needs its cfg")
        tensors = dict(source)
    out = {}
    with torch.no_grad():
        for key, t in tensors.items():
            place = placement_of(t)
            t = t.detach().to(_decode_dtype(key, cfg), copy=True)
            for dim, a in enumerate(place.axes if place is not None else ()):
                kept = a is not None and a.name == "tp" and \
                    dim == decode_leaf_shard_axis(key, place.shape, a.size)
                if a is not None and not kept:
                    t = _all_gather(t, a, dim)
            out[key] = t.contiguous()
    return out
