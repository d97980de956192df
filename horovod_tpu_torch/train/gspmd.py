"""LM training over a dp x fsdp x ep x sp x tp mesh.

Counterpart of ``horovod_tpu/train/gspmd.py``. The JAX step shards the
tokens ``[B, T]`` batch over the data axes and sequence over ``sp``, lays
the parameters out by ``LOGICAL_RULES`` and lets XLA insert every
collective. Here each rank runs its own shard ``[B/(dp fsdp ep), T/sp]``
(:func:`shard_tokens`, dp-major as JAX's ``batch -> (dp, fsdp)``) on a
model built under the mesh, which holds this rank's block of each
parameter and calls the collectives its placement implies
(``parallel/sharding.py``: fsdp's gather on use and reduce-scatter of the
gradient, tp's Megatron all-reduces and vocab-parallel embedding). The
logits stay split over the vocabulary on tp, and the loss is
vocab-parallel (``train/losses.py``). ``ep`` is a data axis for the dense
layers, and the MoE layers exchange their expert buffers over it
(``parallel/moe.py``). The model's ring or Ulysses attention exchanges K/V
over the ``sp`` axis of the ambient mesh, on its local heads under tp.

One ``DistributedOptimizer`` makes the gradient: each parameter's
gradient summed over the ranks that hold the same block and see different
tokens (its ``replica_set`` group, :func:`mesh_param_groups`), and divided
by the number of ranks that see different tokens, dp x fsdp x ep x sp.

:func:`make_gspmd_deferred_train_step` is the two-program expert-update
deferral of ``optimizer.moe_opt.deferred_pair``. ``make_gspmd_train_step``
takes the reference's ``scan_steps`` and ``sentinel``; its health vector is
the single-row form (JAX passes ``axis=None`` on a mesh, where each rank
holds different blocks): the finite bit, squared norm and digest of the
whole reduced gradient and parameters, each block counted once
(:func:`_mesh_health`). Both steps run under the step monitor with
``what="gspmd_train_step"``.

The objective is the next-token loss, or a ``loss_fn`` that sums a
shard's terms and counts them (BERT's masked-LM loss,
``losses.mlm_loss_sums``), divided by the global count.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..collectives import ops as _ops
from ..core import context_api as _ctx
from ..core import sentinel as _sentinel
from ..core import telemetry as _telemetry
from ..core.watchdog import monitored_step
from ..optimizer.distributed import DistributedOptimizer
from ..optimizer.functions import broadcast_optimizer_state
from ..optimizer.moe_opt import DeferredPair, Partition, param_groups
from ..parallel.mesh import Mesh, axis_size, set_mesh, shift
from ..parallel.sharding import (DATA_AXES, gradient_axes, holder_axes,
                                 placement_of, replica_set, token_shards)
from .dp import TrainState
from .losses import next_token_loss  # noqa: F401  (the JAX module's loss)
from .losses import vocab_parallel_nll
from .step_builder import (Cadence, accumulate_gradients, build_program_set,
                           fold_scan, make_dispatch)


def _data_shards(mesh: Mesh):
    """The number of batch shards (dp x fsdp x ep) and this rank's,
    dp-major."""
    n, i = 1, 0
    for name in DATA_AXES:
        size = axis_size(mesh, name)
        if size > 1:
            n, i = n * size, i * size + mesh.axis(name).index
    return n, i


def shard_tokens(tokens: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the global ``tokens [B, T]``: batch rows by its
    ``(dp, fsdp, ep)`` index, dp-major, sequence positions by its ``sp``
    index."""
    B, T = tokens.shape
    out = tokens
    n, i = _data_shards(mesh)
    if n > 1:
        if B % n:
            raise ValueError(f"batch {B} is not divisible by the data axes "
                             f"{DATA_AXES} of total size {n}")
        out = out.narrow(0, i * (B // n), B // n)
    sp = axis_size(mesh, "sp")
    if sp > 1:
        if T % sp:
            raise ValueError(f"sequence {T} is not divisible by the sp axis "
                             f"size {sp}")
        out = out.narrow(1, mesh.axis("sp").index * (T // sp), T // sp)
    return out.contiguous()


def mesh_param_groups(model: torch.nn.Module, mesh: Mesh,
                      groups: Optional[List[Dict]] = None) -> List[Dict]:
    """``groups`` (default: one group of all of ``model``'s parameters)
    split by the ranks each parameter's gradient is summed over
    (``sharding.gradient_axes``): a part summed over the whole world keeps
    the group as it is; any other carries its ``replica_set`` and the
    divisor ``data_shards`` (``sharding.token_shards``). On a dp x sp mesh
    the groups come back as they are; on an ep mesh the expert banks go
    apart; under fsdp or tp every block does. Collective: every rank calls
    it."""
    if groups is None:
        groups = [{"params": list(model.parameters())}]
    shards = token_shards(mesh)
    out = []
    for g in groups:
        parts: Dict[tuple, list] = {}
        for p in g["params"]:
            parts.setdefault(gradient_axes(mesh, p), []).append(p)
        for axes, params in parts.items():
            rs = replica_set(mesh, axes)
            out.append(dict(g, params=params) if rs is None else
                       dict(g, params=params, replica_set=rs,
                            data_shards=shards))
    return out


def _model_axes(mesh: Optional[Mesh]):
    return {a: axis_size(mesh, a) for a in ("fsdp", "tp")}


def _check_optimizer(optimizer, model: torch.nn.Module, mesh: Mesh) -> None:
    """``optimizer`` must be a ``DistributedOptimizer`` over the whole world
    with ``op=Average`` whose groups are :func:`mesh_param_groups`'s, and
    ``model`` built under a mesh of the same fsdp and tp sizes."""
    if getattr(optimizer, "_op", None) != _ops.Average \
            or getattr(optimizer, "_process_set", None) is not None:
        raise ValueError("make_gspmd_train_step needs a DistributedOptimizer "
                         "over the whole world with op=Average")
    if axis_size(mesh, "pp") > 1:
        raise ValueError("a pp axis of size > 1 takes "
                         "make_pipeline_train_step")
    if _model_axes(getattr(model, "mesh", None)) != _model_axes(mesh):
        raise ValueError(f"the model was built for fsdp x tp "
                         f"{_model_axes(getattr(model, 'mesh', None))}, the "
                         f"mesh has {_model_axes(mesh)}: build it under "
                         "the mesh (parallel.set_mesh)")
    shards = token_shards(mesh)
    for g in optimizer.param_groups:
        for p in g["params"]:
            rs = replica_set(mesh, gradient_axes(mesh, p))
            got = g.get("replica_set")
            if (got is None) != (rs is None) or (
                    rs is not None and (got.ranks != rs.ranks
                                        or g.get("data_shards") != shards)):
                raise ValueError(
                    "on this mesh the optimizer's groups must carry each "
                    "block's replica_set and data_shards: build them with "
                    "train.mesh_param_groups")


def gspmd_shardings(model: torch.nn.Module, optimizer):
    """The placement (``sharding.Placement``) of each parameter by name,
    and of each optimizer-state tensor by (parameter name, state key): a
    state tensor shaped as its parameter's block follows the block; any
    other (AdamW's step, a factored moment whose rank shrank) is whole
    (None), as JAX's ``_fit_rank`` replicates it. A model built under a
    mesh holds its blocks already; this reads them."""
    named = list(model.named_parameters())
    params = {n: placement_of(p) for n, p in named}
    by_id = {id(p): n for n, p in named}
    state = {}
    for p, entries in optimizer.state.items():
        n = by_id[id(p)]
        for k, v in entries.items():
            if torch.is_tensor(v):
                state[(n, k)] = params[n] if v.shape == p.shape else None
    return params, state


def create_gspmd_train_state(model: torch.nn.Module, optimizer,
                             mesh: Mesh) -> TrainState:
    """The train state of the GSPMD steps. ``optimizer`` is a
    ``DistributedOptimizer`` (its groups made with
    :func:`mesh_param_groups`), or a transform of ``optimizer.moe_opt`` (a
    ``deferred_pair``'s ``apply``, a ``moe_adamw``), which is built here
    into a ``DistributedOptimizer`` over a ``MoEOptimizer`` with the mesh's
    groups.

    Every rank starts from the same values: each block from the first of
    the ranks that hold it, over those ranks alone (the whole world for a
    replicated parameter), and its optimizer state from the first rank of
    its group's replica set. Collective."""
    if isinstance(optimizer, (dict, Partition)):
        from ..optimizer.moe_opt import MoEOptimizer
        groups = mesh_param_groups(
            model, mesh, param_groups(optimizer, model.named_parameters()))
        optimizer = DistributedOptimizer(
            MoEOptimizer(groups), named_parameters=model.named_parameters())
    with torch.no_grad():
        for p in model.parameters():
            rs = replica_set(mesh, holder_axes(p))
            if rs is None:
                _ops.broadcast_(p.data, 0)
            elif rs.size() > 1:
                _ops.broadcast_(p.data, rs.ranks[0], process_set=rs)
        for b in model.buffers():
            _ops.broadcast_(b, 0)
    broadcast_optimizer_state(optimizer)
    return TrainState(0, model, optimizer)


def _shard_nll_sum(logits, tokens, mesh: Mesh):
    """Sum of the next-token losses of this shard's targets, from logits
    split over the vocabulary on tp (equal on every tp rank). The shift
    crosses the shard boundary: the target of a shard's last position is
    the next ``sp`` shard's first token, which every rank receives from its
    successor (one exchange on the ``sp`` group, the same on every rank);
    the last shard's last position has no target."""
    sp = axis_size(mesh, "sp")
    targets = tokens[:, 1:]
    if sp > 1:
        axis = mesh.axis("sp")
        (nxt,) = shift(axis, (tokens[:, :1],), -1)
        if axis.index < sp - 1:
            targets = torch.cat([targets, nxt], dim=1)
    tp = mesh.axis("tp") if axis_size(mesh, "tp") > 1 else None
    return vocab_parallel_nll(logits[:, :targets.shape[1]], targets,
                              tp).sum()


def _sown_aux(model: torch.nn.Module) -> Optional[torch.Tensor]:
    """The sum of the aux losses the last forward sowed (a Mixtral's router
    losses, one a layer), taken off the model; None if it sowed none."""
    sown = getattr(model, "sown_losses", None)
    if not sown:
        return None
    model.sown_losses = None
    leaves = [v for vs in sown.values() for v in vs]
    return torch.stack(leaves).sum() if leaves else None


def _owns(mesh: Mesh, p: torch.Tensor) -> bool:
    """Whether this rank is the first holder of ``p``'s block: index 0 on
    every axis of size > 1 that does not split it."""
    held = holder_axes(p)
    return all(mesh.axis(a).index == 0 for a in mesh.axis_names
               if a not in held and axis_size(mesh, a) > 1)


def _mesh_health(model: torch.nn.Module, mesh: Mesh) -> torch.Tensor:
    """The ``[1, 3]`` health row of the whole model on a mesh, from the
    reduced gradients (JAX's GSPMD gradient is the global one): each block
    counted on its first holder alone, the non-finite counts and squared
    norms summed over the world in one all-reduce, and the digests
    XOR-ed after one all-gather — the fold is order-free and the blocks
    partition each tensor, so the result is the digest of the whole
    parameters. Collective."""
    owned = [p for p in model.parameters() if _owns(mesh, p)]
    grads = [p.grad for p in owned if p.grad is not None]
    finite = _sentinel.grads_finite(grads)
    dev = owned[0].device if owned else _ctx.device()
    sums = torch.stack([(~finite).to(dev, torch.float32),
                        _sentinel.grad_sqnorm(grads).to(dev)])
    digest = _sentinel.param_digest(owned).to(dev)
    if _ctx.size() > 1:
        sums = _ops.allreduce(sums, _ops.Sum)
        digests = _ops.allgather(digest.reshape(1))
        digest = torch.zeros_like(digest)
        for d in digests:
            digest = digest ^ d
    row = _sentinel.local_health(sums[0] == 0, sums[1], digest)
    return row.reshape(1, _sentinel.HEALTH_WIDTH)


def _step_body(model: torch.nn.Module, mesh: Mesh, aux_weight: float,
               accum_steps: int = 1, loss_fn: Optional[Callable] = None,
               sentinel=None):
    """The forward, backward and update of one step with ``optimizer``;
    returns the step's loss, or with a sentinel ``(loss, health)`` (module
    doc of :func:`make_gspmd_train_step`). ``apply_update`` False is the
    probe step: no update."""
    shards, world = token_shards(mesh), _ctx.size()
    a = accum_steps
    tp = mesh.axis("tp") if axis_size(mesh, "tp") > 1 else None
    # the ranks that see different tokens with this rank's tp index: a
    # loss_fn's term counts are summed over them
    counted = replica_set(mesh, ("tp", "pp")) if loss_fn is not None \
        else None

    def run(optimizer, batch, apply_update: bool = True):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        tokens = batch[0] if isinstance(batch, (tuple, list)) else batch
        B, T = tokens.shape
        n = (B * _data_shards(mesh)[0]) * (T * axis_size(mesh, "sp") - 1)
        parts = []

        def next_token(logits, b, tp):
            """The default objective: the next-token loss, whose global
            count a microbatch's shape gives (n / a targets)."""
            return _shard_nll_sum(logits, b, mesh), n / a

        def terms(logits, b):
            """This shard's summed loss, the factor its backward takes and
            the divisor of its share of the reported loss."""
            total, count = (loss_fn or next_token)(logits, b, tp)
            if isinstance(count, torch.Tensor):
                # one scalar all-reduce over the data axes and sp, before
                # the backward: the divisor is the microbatch's global count
                count = _ops.allreduce(count.detach().float().reshape(1),
                                       _ops.Sum, process_set=counted)[0]
                count = count.clamp_min(1.0)
            return total, shards / count, count * a

        def objective(logits, b):
            nll, scale, div = terms(logits, b)
            aux = _sown_aux(model)
            obj = nll * scale
            parts.append([nll.detach().float() / div])
            if aux is not None and aux_weight:
                obj = obj + aux_weight * aux
                parts[-1].append(aux.detach().float())
            return obj

        with set_mesh(mesh):
            if a > 1:
                accumulate_gradients(model, objective, tokens, batch, a)
            else:
                objective(model(tokens), batch).backward()
        health = None
        optimizer.synchronize()
        if sentinel is None:
            optimizer.apply_update()
        else:
            health = _mesh_health(model, mesh)
            if apply_update and bool(health[0, 0] >= 1.0):
                optimizer.apply_update()
        tot = _ops.allreduce(torch.stack([sum(x) for x in zip(*parts)]),
                             _ops.Sum)
        # every tp rank holds the same sums
        loss = tot[0] / axis_size(mesh, "tp")
        if len(tot) > 1:
            loss = loss + aux_weight * tot[1] / (world * a)
        if sentinel is not None:
            return loss, health
        return loss

    return run


def make_gspmd_train_step(model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer, mesh: Mesh, *,
                          loss_fn: Optional[Callable] = None,
                          aux_weight: float = 0.0,
                          accum_steps: Optional[int] = None,
                          scan_steps: Optional[int] = None,
                          sentinel=None):
    """The train step over ``mesh``: ``step(state, batch) -> (state,
    loss)``, ``batch`` this rank's ``[B/(dp fsdp ep), T/sp]`` shard of the
    global tokens (:func:`shard_tokens`), or a tuple whose first element
    is that shard and whose others are shaped alike (an MLM's labels and
    mask, each cut by :func:`shard_tokens`). The model reads the tokens.

    The objective is the mean over the ranks of each rank's mean
    next-token loss plus ``aux_weight`` x the sum of its layers' router aux
    losses (a Mixtral sows them; a Llama none), which is the JAX step's
    loss in a world of one. Each rank routes its own tokens (ROADMAP.md,
    section C). With N = B (T - 1) targets over the global batch and S =
    dp x fsdp x ep x sp ranks that see different tokens, each rank
    back-propagates ``(S / N) x`` its shard's summed next-token loss plus
    ``aux_weight x`` its aux sum; ``DistributedOptimizer`` sums each
    gradient over its replica set and divides by S (the world Average
    where the set is the world), which gives every parameter the
    objective's gradient: fsdp's reduce-scatter and the all-to-all's
    backward have already brought the other shards' contributions to a
    block. The returned loss is the objective.

    ``loss_fn`` replaces the next-token loss, as JAX's ``loss_fn(logits,
    tokens)`` does: ``loss_fn(logits, batch, tp) -> (total, count)``, with
    ``logits`` this shard's (split over the vocabulary on the tp axis
    ``tp``, None without one), ``total`` the sum of the shard's loss terms
    (equal on every tp rank) and ``count`` their number, a tensor
    (``losses.mlm_loss_sums``: the masked positions). The loss is the
    global sum over the global count, as JAX's mean over the global batch:
    the counts are summed in one scalar all-reduce over the data axes and
    sp before the backward, which back-propagates ``S / count x total``. A
    mean of the shards' means would miss JAX whenever their counts differ.
    A ``count`` that is a number is the global count already, summed by no
    collective: the built-in next-token loss returns its microbatch's
    ``N / a`` so.

    ``accum_steps = a`` runs this rank's shard as ``a`` microbatches
    (``step_builder.accumulate_gradients``), each back-propagating ``a S /
    N`` times its summed loss (with a ``loss_fn``, ``S / count`` of the
    microbatch's global count); the optimizer must be made with
    ``backward_passes_per_step = a``, so it reduces once, after the last,
    and divides by ``a``: the mean of the microbatches' mean losses, as
    JAX's accumulation takes it.

    ``optimizer`` is a ``DistributedOptimizer`` over the whole world with
    ``op=Average`` and the groups of :func:`mesh_param_groups`. The ring's
    point-to-point exchanges, the MoE all-to-alls, fsdp's reduce-scatters,
    tp's all-reduces and the bucket reductions are posted during backward
    in the graph's order, the same on every rank.

    ``scan_steps = k`` runs k steps over the same batch in one call
    (``step_builder.fold_scan``). ``sentinel`` as in ``train.dp``'s step,
    with the single-row health vector of the whole model
    (:func:`_mesh_health`): a step whose reduced gradient is not finite
    applies no update, the ladder sees every step's row, and fingerprints
    are not compared."""
    _check_optimizer(optimizer, model, mesh)
    sentinel = _sentinel.resolve(sentinel)
    a = 1 if accum_steps is None else int(accum_steps)
    passes = getattr(optimizer, "backward_passes_per_step", 1)
    if a != passes:
        raise ValueError(
            f"accum_steps={a} needs an optimizer made with "
            f"backward_passes_per_step={a} (it has {passes})")
    # The step gates the update itself (it calls synchronize() and
    # apply_update()), and the mesh row reads the reduced gradient: the
    # optimizer feeds no sentinel and probes no bucket.
    optimizer.sentinel = False
    run = _step_body(model, mesh, aux_weight, a, loss_fn, sentinel)

    def make_program(apply_update: bool):
        def step(state: TrainState, batch):
            out = run(optimizer, batch, apply_update)
            state = state._replace(step=state.step + 1)
            if sentinel is not None:
                return (state,) + tuple(out)
            return state, out

        if scan_steps is not None:
            step = fold_scan(step, scan_steps, sentinel is not None)
        return step

    programs = build_program_set(make_program, sentinel=sentinel)
    dispatch = make_dispatch(programs, sentinel=sentinel,
                             scan_steps=scan_steps)

    def marked(state, batch):
        _telemetry.inc("hvd_dispatches_total", what="gspmd_train_step")
        return dispatch(state, batch)

    if sentinel is not None:
        marked.sentinel = sentinel
    return monitored_step(marked, what="gspmd_train_step")


def make_gspmd_deferred_train_step(model: torch.nn.Module, pair: DeferredPair,
                                   mesh: Mesh, *,
                                   loss_fn: Optional[Callable] = None,
                                   aux_weight: float = 0.0):
    """Two-step expert-update deferral: ``pair`` is
    ``optimizer.moe_opt.deferred_pair``'s result, and the state's optimizer
    was built from ``pair.apply`` (:func:`create_gspmd_train_state`). The
    host cadence (``step_builder.Cadence``, shared with the pipeline step)
    runs ``every - 1`` skip steps, then one apply step, its counter seeded
    from ``state.step``. On a skip step the bank that ``pair.skip``
    freezes takes no gradient and does not move, on any mesh: under fsdp
    its gather on use has no backward, so no reduce-scatter is posted for
    it; the dense parameters get their AdamW step on every step. The
    apply step is a normal step with the bank's ``every``-scaled update of
    the current gradient. ``loss_fn`` as :func:`make_gspmd_train_step`'s.
    """
    run = _step_body(model, mesh, aux_weight, 1, loss_fn)
    cadence = Cadence(pair)

    def step(state: TrainState, batch):
        opt = state.optimizer
        if cadence.n is None:
            _check_optimizer(opt, model, mesh)
        with cadence.step(opt, state.step):
            loss = run(opt, batch)
        return state._replace(step=state.step + 1), loss

    return monitored_step(step, what="gspmd_train_step")
