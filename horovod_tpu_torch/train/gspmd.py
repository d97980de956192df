"""LM training over a dp x ep x sp mesh.

Counterpart of ``horovod_tpu/train/gspmd.py`` for the ``dp``, ``ep`` and
``sp`` axes. The JAX step shards the tokens ``[B, T]`` batch over the data
axes and sequence over ``sp`` and lets XLA insert every collective. Here
each rank runs its own shard ``[B/(dp ep), T/sp]`` (:func:`shard_tokens`):
``ep`` is a data axis for the dense layers, and the MoE layers exchange
their expert buffers over it (``parallel/moe.py``). The model's ring or
Ulysses attention exchanges K/V over the ``sp`` axis of the ambient mesh,
and one ``DistributedOptimizer`` makes the gradient: dense parameters
averaged over the world, each expert slice summed over the ranks that hold
it (its ``replica_set`` group, :func:`mesh_param_groups`), never across
``ep``.

:func:`make_gspmd_deferred_train_step` is the two-program expert-update
deferral of ``optimizer.moe_opt.deferred_pair``. The fsdp and tp rules,
``scan_steps``, ``accum_steps`` and the sentinel belong to later slices
(ROADMAP.md, section A).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..collectives import ops as _ops
from ..core import context_api as _ctx
from ..optimizer.distributed import DistributedOptimizer
from ..optimizer.functions import broadcast_optimizer_state
from ..optimizer.moe_opt import DeferredPair, Partition, param_groups
from ..parallel.mesh import Mesh, axis_size, set_mesh, shift
from ..parallel.moe import expert_replica_set
from .dp import TrainState
from .losses import next_token_loss  # noqa: F401  (the JAX module's loss)

#: The axes the batch is split over, in order.
DATA_AXES = ("dp", "ep")


def _data_shards(mesh: Mesh):
    """The number of batch shards (dp x ep) and this rank's, dp-major."""
    n, i = 1, 0
    for name in DATA_AXES:
        size = axis_size(mesh, name)
        if size > 1:
            n, i = n * size, i * size + mesh.axis(name).index
    return n, i


def shard_tokens(tokens: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the global ``tokens [B, T]``: batch rows by its
    ``(dp, ep)`` index, dp-major, sequence positions by its ``sp`` index."""
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


def sharded_parameters(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """The parameters of ``model`` sharded over the ``ep`` axis (the expert
    banks of its MoE layers, when they hold a slice)."""
    return [p for m in model.modules()
            if hasattr(m, "sharded_parameters")
            for p in m.sharded_parameters()]


def mesh_param_groups(model: torch.nn.Module, mesh: Mesh,
                      groups: Optional[List[Dict]] = None) -> List[Dict]:
    """``groups`` (default: one group of all of ``model``'s parameters)
    with each group's ep-sharded parameters split off into a group of
    their own that carries the expert ``replica_set``, the ranks with this
    rank's ep index (``parallel.moe.expert_replica_set``). Without an ep
    axis the groups come back as they are. Collective on an ep mesh: every
    rank calls it."""
    if groups is None:
        groups = [{"params": list(model.parameters())}]
    rs = expert_replica_set(mesh)
    if rs is None:
        return groups
    sharded = {id(p) for p in sharded_parameters(model)}
    out = []
    for g in groups:
        dense = [p for p in g["params"] if id(p) not in sharded]
        bank = [p for p in g["params"] if id(p) in sharded]
        if dense:
            out.append(dict(g, params=dense))
        if bank:
            out.append(dict(g, params=bank, replica_set=rs))
    return out


def _check_optimizer(optimizer, model: torch.nn.Module, mesh: Mesh) -> None:
    """``optimizer`` must be a ``DistributedOptimizer`` over the whole world
    with ``op=Average``, and hold every ep-sharded parameter in a group
    whose ``replica_set`` is this rank's expert set."""
    if getattr(optimizer, "_op", None) != _ops.Average \
            or getattr(optimizer, "_process_set", None) is not None:
        raise ValueError("make_gspmd_train_step needs a DistributedOptimizer "
                         "over the whole world with op=Average")
    world = _ctx.size()
    covered = 1
    for name in ("dp", "ep", "sp"):
        covered *= axis_size(mesh, name)
    if world != covered:
        raise ValueError(f"the mesh {mesh.shape} does not cover the world of "
                         f"{world} ranks with dp, ep and sp")
    sharded = {id(p) for p in sharded_parameters(model)}
    if sharded:
        rs = expert_replica_set(mesh)
        for g in optimizer.param_groups:
            for p in g["params"]:
                if (id(p) in sharded) != (g.get("replica_set") == rs):
                    raise ValueError(
                        "on an ep mesh the optimizer's groups must keep the "
                        "expert banks apart with their replica_set: build "
                        "them with train.mesh_param_groups")


def create_gspmd_train_state(model: torch.nn.Module, optimizer,
                             mesh: Mesh) -> TrainState:
    """The train state of the GSPMD steps. ``optimizer`` is a
    ``DistributedOptimizer`` (its groups made with
    :func:`mesh_param_groups` on an ep mesh), or a transform of
    ``optimizer.moe_opt`` (a ``deferred_pair``'s ``apply``, a
    ``moe_adamw``), which is built here into a ``DistributedOptimizer``
    over a ``MoEOptimizer`` with the mesh's groups.

    Every rank starts from the same values: dense parameters and their
    optimizer state from rank 0 over the world, each expert slice from the
    first rank of its replica set (dp index 0) over that set alone, since
    a world broadcast would overwrite rank e's experts with rank 0's.
    Collective."""
    if isinstance(optimizer, (dict, Partition)):
        from ..optimizer.moe_opt import MoEOptimizer
        groups = mesh_param_groups(
            model, mesh, param_groups(optimizer, model.named_parameters()))
        optimizer = DistributedOptimizer(
            MoEOptimizer(groups), named_parameters=model.named_parameters())
    sets = {id(p): g.get("replica_set") for g in optimizer.param_groups
            for p in g["params"]}
    with torch.no_grad():
        for p in model.parameters():
            rs = sets.get(id(p))
            if rs is None:
                _ops.broadcast_(p.data, 0)
            elif rs.size() > 1:
                _ops.broadcast_(p.data, rs.ranks[0], process_set=rs)
        for b in model.buffers():
            _ops.broadcast_(b, 0)
    broadcast_optimizer_state(optimizer)
    return TrainState(0, model, optimizer)


def _shard_nll_sum(logits, tokens, mesh: Mesh):
    """Sum of the next-token losses of this shard's targets. The shift
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
    logits = logits[:, :targets.shape[1]].float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None]).squeeze(-1)
    return (lse - tgt).sum()


def _sown_aux(model: torch.nn.Module) -> Optional[torch.Tensor]:
    """The sum of the aux losses the last forward sowed (a Mixtral's router
    losses, one a layer), taken off the model; None if it sowed none."""
    sown = getattr(model, "sown_losses", None)
    if not sown:
        return None
    model.sown_losses = None
    leaves = [v for vs in sown.values() for v in vs]
    return torch.stack(leaves).sum() if leaves else None


def _step_body(model: torch.nn.Module, mesh: Mesh, aux_weight: float):
    """The forward, backward and update of one step with ``optimizer``;
    returns the step's loss (module doc of :func:`make_gspmd_train_step`).
    """
    world = _ctx.size()

    def run(optimizer, tokens: torch.Tensor) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        B, T = tokens.shape
        shards, _ = _data_shards(mesh)
        n = (B * shards) * (T * axis_size(mesh, "sp") - 1)
        with set_mesh(mesh):
            nll = _shard_nll_sum(model(tokens), tokens, mesh)
            aux = _sown_aux(model)
            objective = nll * (world / n)
            if aux is not None and aux_weight:
                objective = objective + aux_weight * aux
            objective.backward()
        optimizer.step()
        parts = [nll.detach()]
        if aux is not None and aux_weight:
            parts.append(aux.detach().float())
        tot = _ops.allreduce(torch.stack(parts), _ops.Sum)
        loss = tot[0] / n
        if len(parts) > 1:
            loss = loss + aux_weight * tot[1] / world
        return loss

    return run


def make_gspmd_train_step(model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer, mesh: Mesh, *,
                          aux_weight: float = 0.0):
    """The LM train step over ``mesh``: ``step(state, tokens) -> (state,
    loss)``, ``tokens`` this rank's ``[B/(dp ep), T/sp]`` shard of the
    global batch (:func:`shard_tokens`).

    The objective is the mean over the ranks of each rank's mean
    next-token loss plus ``aux_weight`` x the sum of its layers' router aux
    losses (a Mixtral sows them; a Llama none), which is the JAX step's
    loss in a world of one. Each rank routes its own tokens (ROADMAP.md,
    section C). With N = B (T - 1) targets over the global batch and W =
    dp x ep x sp ranks, each rank back-propagates ``(W / N) x`` its shard's
    summed next-token loss plus ``aux_weight x`` its aux sum; the world
    Average of ``DistributedOptimizer`` then gives every replicated
    parameter the objective's gradient, and the replica-set sum over W
    gives each expert slice its own (the all-to-all's backward has already
    brought the other ep ranks' cotangents to it). The returned loss is
    the objective.

    ``optimizer`` is a ``DistributedOptimizer`` over the whole world with
    ``op=Average``; on an ep mesh its groups keep the expert banks apart
    (:func:`mesh_param_groups`). The ring's point-to-point exchanges and
    the MoE all-to-alls, the world bucket all-reduces and the expert
    reductions over the replica sets are posted during backward in the
    graph's order, the same on every rank."""
    _check_optimizer(optimizer, model, mesh)
    run = _step_body(model, mesh, aux_weight)

    def step(state: TrainState, tokens: torch.Tensor):
        return state._replace(step=state.step + 1), run(optimizer, tokens)

    return step


def make_gspmd_deferred_train_step(model: torch.nn.Module, pair: DeferredPair,
                                   mesh: Mesh, *, aux_weight: float = 0.0):
    """Two-step expert-update deferral: ``pair`` is
    ``optimizer.moe_opt.deferred_pair``'s result, and the state's optimizer
    was built from ``pair.apply`` (:func:`create_gspmd_train_state`). A
    step counter on the host, seeded from ``state.step``, runs ``every -
    1`` skip steps, then one apply step.

    On a skip step the parameters of every group that ``pair.skip``
    freezes (the expert banks) take no gradient: they are set
    ``requires_grad_(False)`` for the step, so autograd computes no dW for
    them, ``DistributedOptimizer`` reduces nothing for them, their
    ``.grad`` stays None and the optimizer leaves them and their state
    alone. The dense parameters get their AdamW step on every step. This
    is the port's counterpart of the JAX skip program, in which XLA drops
    the dead dW products and aliases the donated bank. The apply step is a
    normal step with the bank's ``every``-scaled update of the current
    gradient."""
    run = _step_body(model, mesh, aux_weight)
    counter = {"n": None}

    def step(state: TrainState, tokens: torch.Tensor):
        opt = state.optimizer
        if counter["n"] is None:
            _check_optimizer(opt, model, mesh)
            labels = {g.get("label") for g in opt.param_groups}
            if not labels <= set(pair.apply.transforms):
                raise ValueError("the state's optimizer was not built from "
                                 "pair.apply")
            counter["n"] = int(state.step)
        counter["n"] += 1
        frozen = []
        if counter["n"] % pair.every:
            frozen = [p for g in opt.param_groups
                      if pair.skip.transforms[g["label"]].get("frozen")
                      for p in g["params"]]
        for p in frozen:
            p.requires_grad_(False)
        try:
            loss = run(opt, tokens)
        finally:
            for p in frozen:
                p.requires_grad_(True)
        return state._replace(step=state.step + 1), loss

    return step
