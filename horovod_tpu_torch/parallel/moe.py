"""Expert parallelism: capacity-based MoE dispatch over the ``ep`` axis.

Counterpart of ``horovod_tpu/parallel/moe.py``:

- tokens are routed top-k with a capacity per expert. Two routers: the
  GShard one-hot form (:func:`topk_router`, the readable oracle) and the
  sort-based plan (:func:`topk_router_sorted`) that the model runs, whose
  dispatch and combine are row GATHERS forward and backward
  (:func:`sorted_dispatch`, :func:`sorted_combine`);
- the experts are sharded over the ``ep`` axis of a mesh, and the token
  buffers cross it in ONE all-to-all each way (:func:`expert_alltoall`,
  :func:`expert_alltoall_back`);
- the combine applies the renormalised router weights on the way back.

Where a port goes wrong, kept as it computes:

- ``lax.top_k`` breaks ties by the lower index; ``torch.topk`` on CUDA
  promises no order among ties, so the router takes a stable descending
  sort.
- A dropped entry's ``dest`` is the sentinel ``E * C``, which JAX reads as a
  zero row (``.at[dest].get(mode="fill", fill_value=0)``). Here one zero row
  is appended and indexed, never clamped.
- Both backward passes are gathers too (``torch.autograd.Function`` s): a
  plain ``index_select`` would back-propagate through ``index_add_``, whose
  atomics make CUDA's result depend on the order of arrival. Two backward
  passes on the same inputs are bit-identical.
- ``lax.all_to_all(split_axis=0, concat_axis=1, tiled=True)`` puts the chunk
  from ep rank ``j`` in columns ``j C : (j + 1) C``; ``all_to_all_single``
  concatenates on dim 0, so the received rows are permuted after it.

One process drives one GPU, so each function runs on the rank's own tokens,
as the JAX functions run inside ``shard_map``.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import Axis, Mesh, axis_size
from .sharding import replica_set


class RouterOutput(NamedTuple):
    dispatch: torch.Tensor  # [T, E, C] one-hot routing tensor
    combine: torch.Tensor   # [T, E, C] probability-weighted combine tensor
    aux_loss: torch.Tensor  # load-balancing auxiliary loss (scalar)


def _aux_loss(probs: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch's load-balancing loss, ``E * sum(frac_tokens * frac_probs)``."""
    top1 = probs.argmax(-1)
    frac_tokens = F.one_hot(top1, num_experts).float().mean(0)
    return num_experts * (frac_tokens * probs.mean(0)).sum()


def topk_router(router_logits: torch.Tensor, num_experts: int,
                capacity: int, top_k: int = 2) -> RouterOutput:
    """GShard-style top-k router with a capacity per expert. Tokens beyond
    an expert's capacity are dropped (combine weight 0)."""
    T = router_logits.shape[0]
    probs = torch.softmax(router_logits.float(), dim=-1)
    aux = _aux_loss(probs, num_experts)
    dispatch = probs.new_zeros((T, num_experts, capacity))
    combine = probs.new_zeros((T, num_experts, capacity))
    # claimed positions per expert accumulate across the k choices
    base = torch.zeros(num_experts, dtype=torch.long, device=probs.device)
    p_rem = probs
    for _ in range(top_k):
        choice = p_rem.argmax(-1)
        gate = p_rem.gather(1, choice[:, None])[:, 0]
        onehot = F.one_hot(choice, num_experts)
        pos = onehot.cumsum(0) - 1 + base[None, :]
        pos_in_choice = pos.gather(1, choice[:, None])[:, 0]
        keep = pos_in_choice < capacity
        d = (onehot.float()[:, :, None]
             * F.one_hot(pos_in_choice.clamp(0, capacity - 1),
                         capacity).float()[:, None, :])
        d = d * keep[:, None, None]
        dispatch = dispatch + d
        combine = combine + d * gate[:, None, None]
        base = base + onehot.sum(0)
        p_rem = p_rem * (1.0 - onehot.float())
    # renormalise the combine weights over the selected experts (Mixtral)
    combine = combine / combine.sum((1, 2), keepdim=True).clamp_min(1e-9)
    return RouterOutput(dispatch, combine, aux)


class SortedRouting(NamedTuple):
    """Sort-based routing plan (no ``[T, E, C]`` one-hot tensors).

    ``k T`` flattened (round, token) entries in ROUND-MAJOR order (index
    ``r T + t``), :func:`topk_router`'s claim priority: every first choice
    claims capacity before any second choice. It carries both directions of
    the token <-> slot mapping, so dispatch, combine and both their backward
    passes are row gathers."""
    token_idx: torch.Tensor   # [k T] long: source token of each entry
    dest: torch.Tensor        # [k T] long: expert * C + slot, or E * C if
    #                           dropped (the sentinel of the zero row)
    weight: torch.Tensor      # [k T] f32: renormalised gate (0 if dropped)
    slot_entry: torch.Tensor  # [E C] long: entry filling each slot (clipped)
    slot_valid: torch.Tensor  # [E C] bool: slot actually claimed
    aux_loss: torch.Tensor    # the load-balancing loss of topk_router


def topk_router_sorted(router_logits: torch.Tensor, num_experts: int,
                       capacity: int, top_k: int = 2) -> SortedRouting:
    """Top-k router producing a gather-based plan: the same expert choices,
    capacity claims, renormalised weights and aux loss as
    :func:`topk_router`, with O(k T D) memory traffic."""
    T = router_logits.shape[0]
    kT = top_k * T
    dev = router_logits.device
    probs = torch.softmax(router_logits.float(), dim=-1)
    aux = _aux_loss(probs, num_experts)
    # lax.top_k: descending, ties to the lower index (a stable sort)
    gate, choice = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, choice = gate[:, :top_k], choice[:, :top_k]
    # round-major flatten: entry r*T + t (claim priority = round, token)
    e_flat = choice.t().reshape(-1)
    g_flat = gate.t().reshape(-1)
    token_idx = torch.arange(T, device=dev).repeat(top_k)

    # stable sort by expert: within an expert, entries keep round-major
    # order, topk_router's claim sequence
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    counts = torch.bincount(e_flat, minlength=num_experts)
    start = counts.cumsum(0) - counts            # exclusive cumsum
    pos = torch.arange(kT, device=dev) - start[e_sorted]
    keep_sorted = pos < capacity
    dest_sorted = torch.where(
        keep_sorted, e_sorted * capacity + pos.clamp(max=capacity - 1),
        num_experts * capacity)                  # sentinel = dropped
    # un-sort to (round, token) order: a small int permutation scatter
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(kT, device=dev))
    dest = dest_sorted[inv]
    kept = g_flat * (dest < num_experts * capacity)
    # the entries of token t sit at {r T + t}: a reshape-sum, and the
    # per-token denominator repeats per round (no gather to back-propagate)
    denom = kept.reshape(top_k, T).sum(0)
    weight = kept / denom.clamp_min(1e-9).repeat(top_k)

    # slot-side view: slot (e, p) is filled by sorted entry start[e] + p
    slots = torch.arange(capacity, device=dev)
    grid = (start[:, None] + slots[None, :]).reshape(-1)
    slot_valid = (slots[None, :]
                  < counts.clamp(max=capacity)[:, None]).reshape(-1)
    slot_entry = order[grid.clamp(0, kT - 1)]
    return SortedRouting(token_idx, dest, weight, slot_entry, slot_valid,
                         aux)


def _with_zero_row(rows: torch.Tensor, dtype=None) -> torch.Tensor:
    """``rows [N, D]`` and one zero row at index N (the dropped entries'
    sentinel), in ``dtype``."""
    out = rows.new_zeros((rows.shape[0] + 1, rows.shape[1]),
                         dtype=dtype or rows.dtype)
    out[:-1] = rows
    return out


class _DispatchRows(torch.autograd.Function):
    """``buf[s] = x[token(slot_entry[s])] * valid[s]``: a gather. Its
    backward ``dx[t] = sum_r dbuf[dest[r T + t]]`` is a gather too, plus a
    reshape-sum: the mirror of the combine forward."""

    @staticmethod
    def forward(ctx, x, slot_entry, slot_valid, dest, top_k):
        T = x.shape[0]
        ctx.save_for_backward(dest)
        ctx.top_k = top_k
        return x[slot_entry % T] * slot_valid[:, None].to(x.dtype)

    @staticmethod
    def backward(ctx, dbuf):
        (dest,) = ctx.saved_tensors
        rows = _with_zero_row(dbuf)[dest]
        dx = rows.reshape(ctx.top_k, -1, rows.shape[-1]).sum(0)
        return dx, None, None, None, None


def sorted_dispatch(x: torch.Tensor, r: SortedRouting, num_experts: int,
                    capacity: int) -> torch.Tensor:
    """``[T, D]`` tokens -> ``[E, C, D]`` expert buffers, gathers only
    forward and backward. Unclaimed slots are zero."""
    k = r.dest.shape[0] // x.shape[0]
    buf = _DispatchRows.apply(x, r.slot_entry, r.slot_valid, r.dest, k)
    return buf.reshape(num_experts, capacity, x.shape[-1])


class _CombineRows(torch.autograd.Function):
    """``y[t] = sum_r flat[dest[r T + t]] * weight[r T + t]`` in f32 over
    ``flat = out`` cast to f32: a gather. Backward: ``dflat[s] =
    dy[token(slot_entry[s])] * weight[slot_entry[s]] * valid[s]`` and
    ``dweight[j] = <dy[token(j)], flat[dest[j]]>``, gathers again;
    ``dflat`` goes back to ``out`` in ``out``'s dtype, as the transpose of
    JAX's cast."""

    @staticmethod
    def forward(ctx, out, weight, dest, slot_entry, slot_valid, num_tokens):
        flat = _with_zero_row(out, torch.float32)
        rows = flat[dest]
        k = dest.shape[0] // num_tokens
        ctx.save_for_backward(flat, weight, dest, slot_entry, slot_valid)
        ctx.num_tokens, ctx.out_dtype = num_tokens, out.dtype
        return (rows.reshape(k, num_tokens, -1)
                * weight.reshape(k, num_tokens, 1)).sum(0)

    @staticmethod
    def backward(ctx, dy):
        flat, weight, dest, slot_entry, slot_valid = ctx.saved_tensors
        T = ctx.num_tokens
        w_slot = weight[slot_entry] * slot_valid
        dflat = (dy[slot_entry % T] * w_slot[:, None]).to(ctx.out_dtype)
        k = dest.shape[0] // T
        dweight = (flat[dest].reshape(k, T, -1)
                   * dy.reshape(1, T, -1)).sum(-1).reshape(-1)
        return dflat, dweight, None, None, None, None


def sorted_combine(out: torch.Tensor, r: SortedRouting,
                   num_tokens: int) -> torch.Tensor:
    """``[E, C, D]`` expert outputs -> ``[T, D]`` weighted combine, gathers
    only forward and backward; accumulates in f32, returns ``out``'s
    dtype."""
    E, C, D = out.shape
    y = _CombineRows.apply(out.reshape(E * C, D), r.weight, r.dest,
                           r.slot_entry, r.slot_valid, num_tokens)
    return y.to(out.dtype)


# ------------------------------------------------------------- the exchange

#: The ep axes the exchange op has seen, by key: a custom op takes no
#: process group, so it takes the key of its axis.
_AXES: Dict[int, Axis] = {}
_AXIS_KEYS: Dict[Tuple[Tuple[int, ...], int], int] = {}
_next_key = itertools.count()


def _axis_key(axis: Axis) -> int:
    key = _AXIS_KEYS.get((axis.ranks, id(axis.group)))
    if key is None:
        key = next(_next_key)
        _AXIS_KEYS[(axis.ranks, id(axis.group))] = key
        _AXES[key] = axis
    return key


def _exchange(x: torch.Tensor, axis: Axis, back: bool) -> torch.Tensor:
    n = axis.size
    if not back:
        E, C, D = x.shape
        send = x.contiguous()  # [n, E/n, C, D]: chunk j goes to ep rank j
    else:
        El, nC, D = x.shape
        C = nC // n
        send = x.reshape(El, n, C, D).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=axis.group)
    expert_alltoall.launches += 1
    if not back:
        # rank j's chunk goes to columns j C : (j + 1) C
        return recv.reshape(n, E // n, C, D).transpose(0, 1).reshape(
            E // n, n * C, D)
    return recv.reshape(n * El, C, D)


@torch.library.custom_op("hvd::expert_alltoall", mutates_args=())
def _expert_alltoall_op(x: torch.Tensor, axis_key: int,
                        back: bool) -> torch.Tensor:
    return _exchange(x, _AXES[axis_key], back)


def _alltoall_setup(ctx, inputs, output):
    ctx.axis_key, ctx.back = inputs[1], inputs[2]


def _alltoall_backward(ctx, g):
    # the backward of each exchange is the other one
    return (torch.ops.hvd.expert_alltoall(g, ctx.axis_key, not ctx.back),
            None, None)


_expert_alltoall_op.register_autograd(_alltoall_backward,
                                      setup_context=_alltoall_setup)


def expert_alltoall(expert_inputs: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``[E, C, D]`` (every expert's buffer on this rank) -> ``[E/n, n C,
    D]`` (this rank's experts, tokens from every rank of the ep row): ONE
    ``all_to_all_single`` on the axis's group. Differentiable; its backward
    is :func:`expert_alltoall_back`. It runs as the torch custom op
    ``hvd::expert_alltoall``, so a remat policy can save its output rather
    than exchange again in the recompute. ``expert_alltoall.launches``
    counts the exchanges handed to ``torch.distributed``, either way."""
    E = expert_inputs.shape[0]
    if E % axis.size:
        raise ValueError(f"experts {E} not divisible by ep axis size "
                         f"{axis.size}")
    return torch.ops.hvd.expert_alltoall(expert_inputs, _axis_key(axis),
                                         False)


expert_alltoall.launches = 0


def expert_alltoall_back(expert_outputs: torch.Tensor,
                         axis: Axis) -> torch.Tensor:
    """Inverse of :func:`expert_alltoall`: ``[E/n, n C, D]`` -> ``[E, C,
    D]``."""
    return torch.ops.hvd.expert_alltoall(expert_outputs, _axis_key(axis),
                                         True)


def _route(x: torch.Tensor, router_logits: torch.Tensor, expert_fn, axis,
           num_experts: int, capacity_factor: float, top_k: int):
    """:func:`routed_experts`'s body; also returns the plan and the
    capacity (the model reads its routing counts from them)."""
    T = x.shape[0]
    capacity = max(1, int(capacity_factor * top_k * T / num_experts))
    r = topk_router_sorted(router_logits, num_experts, capacity, top_k)
    dispatched = sorted_dispatch(x, r, num_experts, capacity)  # [E, C, D]
    exchange = axis is not None and axis.size > 1
    if exchange:
        dispatched = expert_alltoall(dispatched, axis)  # [E/n, n C, D]
    out = expert_fn(dispatched)
    if exchange:
        out = expert_alltoall_back(out, axis)           # [E, C, D]
    return sorted_combine(out, r, T), r, capacity


def routed_experts(x: torch.Tensor, router_logits: torch.Tensor,
                   expert_fn: Callable[[torch.Tensor], torch.Tensor], *,
                   axis: Optional[Axis], num_experts: int,
                   capacity_factor: float = 1.25, top_k: int = 2
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE layer body: route -> all-to-all -> experts -> all-to-all ->
    combine. ``x [T, D]`` this rank's tokens, ``router_logits [T, E]``;
    ``expert_fn`` maps ``[E_local, tokens, D]`` to the same shape. Returns
    ``(y [T, D], aux_loss)``. ``axis=None`` (or an axis of size 1) runs with
    every expert local. The capacity comes from this rank's ``T``."""
    y, r, _ = _route(x, router_logits, expert_fn, axis, num_experts,
                     capacity_factor, top_k)
    return y, r.aux_loss


def expert_replica_set(mesh: Mesh):
    """The process set of the ranks that hold this rank's experts: those
    with its ``ep`` index (its row over every other axis). Every rank makes
    every ep index's set, in order (``new_group`` is collective). None when
    the mesh has no ``ep`` axis of size > 1: every rank holds every
    expert."""
    return replica_set(mesh, ("ep",))
