"""Parameter placement over fsdp and tp, and the collectives it implies.

The JAX package has no such file. There a parameter carries logical axis
names (``nn.with_logical_partitioning``), :data:`LOGICAL_RULES` maps them
onto mesh axes, and XLA's SPMD partitioner inserts every collective the
placement implies. In the port, one process holds one block of each
parameter and the model calls those collectives itself; this module is
the explicit counterpart of what the partitioner inserts:

- :func:`placement` turns a parameter's logical names into its
  :class:`Placement`: which dims are split over which mesh axes (one axis
  a dim, up to one dim an axis: an expert bank ``[E, D, M]`` is
  ``[E/ep, D/fsdp, M/tp]``), and this rank's block;
  :func:`kernel_placement` does it for a dense weight named in flax's
  order, and :func:`bias_placement` for its bias;
- fsdp (ZeRO-3): :func:`gather_param` all-gathers a weight over its fsdp
  row where it is used, and the backward reduce-scatters (sums) its
  gradient back to the shards (:class:`_FsdpGather`). A weight the module
  casts to the compute dtype anyway is gathered in that dtype: bit-equal
  to gathering in f32 and casting after, at half the bytes. The gradient
  is reduce-scattered in f32, the parameter's dtype, as the gradient of
  the f32 parameter is summed in JAX;
- tp (Megatron): :func:`copy_to_tp` (``f``: identity forward, all-reduce
  of the cotangent over tp backward) before the column-parallel products,
  :func:`reduce_from_tp` (``g``: all-reduce of the partial sums forward,
  identity backward) after the row-parallel ones, and
  :func:`vocab_parallel_embedding`, a masked lookup of this rank's rows of
  the table and one all-reduce over tp. The partial sums after ``wo`` and
  ``w2`` are all-reduced in the compute dtype, bf16 on the card: XLA sums
  JAX's bf16 partial products in bf16 too.

:data:`counts` counts each collective where it is handed to
``torch.distributed``: ``all_gather``, ``reduce_scatter`` and
``tp_all_reduce`` (``f``, ``g``, the embedding and the vocab-parallel
loss of ``train/losses.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core import context_api as _ctx
from .mesh import Axis, Mesh, axis_size

#: Logical -> mesh axis rules, as ``horovod_tpu/models/llama.py``'s: the
#: batch over the data axes, the vocabulary, heads and MLP width over tp,
#: the embedding width of the weights over fsdp (ZeRO-3). The table's
#: width (``embed_table``) stays whole: its rows feed a gather.
LOGICAL_RULES = (
    ("batch", ("dp", "fsdp")),
    ("seq", "sp"),
    ("vocab", "tp"),
    ("embed", "fsdp"),
    ("embed_fsdp", "fsdp"),
    ("embed_table", None),
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("head_dim", None),
    ("mlp", "tp"),
    ("experts", "ep"),
    ("layers", None),
)

#: The axes a batch is split over (the gradient is summed over them and
#: over ``sp``); every other axis splits parameters.
DATA_AXES = ("dp", "fsdp", "ep")

counts: Dict[str, int] = {"all_gather": 0, "reduce_scatter": 0,
                          "tp_all_reduce": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def rules_for_mesh(mesh: Mesh, rules=LOGICAL_RULES):
    """Drop the mesh axes a rule names that ``mesh`` lacks, so one table
    serves every mesh (``horovod_tpu/train/gspmd.py::rules_for_mesh``)."""
    out = []
    for logical, target in rules:
        if target is None:
            out.append((logical, None))
            continue
        t = target if isinstance(target, tuple) else (target,)
        t = tuple(a for a in t if a in mesh.axis_names)
        out.append((logical, t if len(t) > 1 else (t[0] if t else None)))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A parameter's whole ``shape`` and, per dim, the mesh axis it is
    split over (None: whole). Only axes of size > 1 appear."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[Axis], ...]

    def local_shape(self) -> Tuple[int, ...]:
        return tuple(n // a.size if a is not None else n
                     for n, a in zip(self.shape, self.axes))

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``full``."""
        for dim, a in enumerate(self.axes):
            if a is not None:
                n = full.shape[dim] // a.size
                full = full.narrow(dim, a.index * n, n)
        return full

    def dim_of(self, name: str) -> Optional[int]:
        """The dim split over mesh axis ``name``, or None."""
        for dim, a in enumerate(self.axes):
            if a is not None and a.name == name:
                return dim
        return None

    @property
    def sharded_axes(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes if a is not None)


def placement(mesh: Optional[Mesh], names: Sequence[Optional[str]],
              shape: Sequence[int], rules=LOGICAL_RULES) -> Placement:
    """The placement of a parameter of ``shape`` whose dims carry the
    logical ``names``, on ``mesh`` (None: whole). As flax does, an axis
    already taken by an earlier dim leaves a later one whole. A dim that
    the axis does not divide raises ``ValueError``."""
    shape = tuple(int(n) for n in shape)
    if mesh is None:
        return Placement(shape, (None,) * len(shape))
    table = dict(rules_for_mesh(mesh, rules))
    used, axes = set(), []
    for n, name in zip(shape, names):
        target = table.get(name)
        if isinstance(target, tuple):
            raise ValueError(f"logical axis {name!r} maps to several mesh "
                             f"axes {target}; a parameter dim takes one")
        if target is None or target in used \
                or axis_size(mesh, target) == 1:
            axes.append(None)
            continue
        a = mesh.axis(target)
        if n % a.size:
            raise ValueError(f"dim {name!r} of size {n} is not divisible by "
                             f"mesh axis {target!r} of size {a.size}")
        used.add(target)
        axes.append(a)
    return Placement(shape, tuple(axes))


def kernel_placement(mesh: Optional[Mesh], names: Sequence[Optional[str]],
                     fan_in: int, fan_out: int,
                     rules=LOGICAL_RULES) -> Placement:
    """The placement of a port dense weight ``[out, in]`` whose flax kernel
    ``[in, out]`` carries the logical ``names`` (flax's order). The rules
    run in flax's dim order, so flax's first-use rule picks the same dim:
    BERT's ``mlm_transform`` kernel ``("embed", "embed_fsdp")``, both
    names on fsdp, is split on its ``in`` dim (flax dim 0, the port's dim
    1) and whole on the other."""
    k = placement(mesh, names, (fan_in, fan_out), rules)
    return Placement(k.shape[::-1], k.axes[::-1])


def bias_placement(weight: Placement) -> Placement:
    """The placement of the bias of a dense weight placed as ``weight``
    (``[out, in]``). JAX names no bias, so XLA replicates every one. A
    column-parallel layer's output (its ``out`` dim split over tp) is split
    over tp, and so is the gradient of a bias added to it: whole only
    after the tp ranks' slices are joined. The port holds such a bias split
    with the output, each tp rank its slice: its gradient is then whole
    where it is computed, and since AdamW is elementwise the slices take
    the same steps as JAX's replicated bias. Any other bias is whole (a
    row-parallel layer adds it once, after the all-reduce of the partial
    products)."""
    a = weight.axes[0]
    split = a is not None and a.name == "tp"
    return Placement(weight.shape[:1], (a if split else None,))


def set_placement(p: torch.nn.Parameter, place: Placement) -> None:
    p.placement = place


def placement_of(p: torch.Tensor) -> Optional[Placement]:
    return getattr(p, "placement", None)


def replica_set(mesh: Mesh, fixed: Sequence[str]):
    """The process set of the ranks that share this rank's coordinates on
    the axes ``fixed`` (its row over every other axis), or None when that
    is the whole world. Every rank makes every coordinate's set, in one
    order (``new_group`` is collective)."""
    fixed = [a for a in mesh.axis_names if a in fixed and mesh.shape[a] > 1]
    if not fixed:
        return None
    grid = mesh.grid()
    dims = [mesh.axis_names.index(a) for a in fixed]
    rest = [d for d in range(grid.dim()) if d not in dims]
    moved = grid.permute(dims + rest).reshape(
        math.prod(mesh.shape[a] for a in fixed), -1)
    sets = [_ctx.add_process_set(row.tolist()) for row in moved]
    mine = 0
    for a in fixed:
        mine = mine * mesh.shape[a] + mesh.axis(a).index
    return sets[mine]


def token_shards(mesh: Mesh) -> int:
    """The number of ranks that see different tokens: the data shards
    dp x fsdp x ep times the sequence shards sp (the world over tp and
    pp). A replicated parameter's gradient is summed over them and
    divided by this count."""
    return math.prod(axis_size(mesh, a) for a in DATA_AXES + ("sp",))


def gradient_axes(mesh: Mesh, p: torch.Tensor) -> Tuple[str, ...]:
    """The axes along which the ranks that sum ``p``'s gradient agree:
    those ``p`` is split over, and tp and pp, whose ranks hold different
    blocks or equal copies. A tp-replicated gradient is already whole on
    every tp rank: the tp ranks compute it from equal values (the input of
    a layer after ``copy_to_tp``'s all-reduce backward, or the output after
    ``reduce_from_tp``), which holds for every replicated parameter of the
    port's models because a column-parallel bias, whose gradient would be
    a tp slice, is held split (:func:`bias_placement`)."""
    place = placement_of(p)
    own = place.sharded_axes if place is not None else ()
    return tuple(a for a in mesh.axis_names
                 if a in own or a in ("tp", "pp"))


def holder_axes(p: torch.Tensor) -> Tuple[str, ...]:
    """The axes along which the ranks holding ``p``'s block agree."""
    place = placement_of(p)
    return place.sharded_axes if place is not None else ()


# ------------------------------------------------------------------- fsdp

def _all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    n, shape = axis.size, tuple(x.shape)
    out = torch.empty((n * shape[0],) + shape[1:], dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=axis.group)
    counts["all_gather"] += 1
    if dim == 0:
        return out
    return torch.cat(out.view((n,) + shape).unbind(0), dim=dim)


def _reduce_scatter(g: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    n = axis.size
    chunks = g.chunk(n, dim=dim)
    send = torch.cat(chunks) if dim else g.contiguous()
    out = torch.empty_like(chunks[0], memory_format=torch.contiguous_format)
    dist.reduce_scatter_tensor(out, send, op=dist.ReduceOp.SUM,
                               group=axis.group)
    counts["reduce_scatter"] += 1
    return out


class _FsdpGather(torch.autograd.Function):
    """This rank's shard of a weight, cast to ``dtype`` and gathered over
    the fsdp row along ``dim``; the backward reduce-scatters the gradient
    of the whole weight, summed in the shard's dtype."""

    @staticmethod
    def forward(ctx, shard, axis: Axis, dim: int, dtype):
        ctx.axis, ctx.dim, ctx.shard_dtype = axis, dim, shard.dtype
        return _all_gather(shard.to(dtype), axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g.to(ctx.shard_dtype), ctx.axis, ctx.dim),
                None, None, None)


def gather_param(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``p`` as the module uses it, in ``dtype``: this rank's tp and ep
    block, gathered over fsdp along whichever dim fsdp splits (an expert
    bank's ``embed``: dim 1 of ``w1``, dim 2 of ``w2``)."""
    place = placement_of(p)
    dim = place.dim_of("fsdp") if place is not None else None
    if dim is None:
        return p.to(dtype)
    return _FsdpGather.apply(p, place.axes[dim], dim, dtype)


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s parameters as whole tensors, each gathered from its
    blocks over the axes it is split over (``convert.llama_params_to_flax``
    takes this). Collective over those axes: every rank calls it."""
    out = {}
    for name, p in model.named_parameters():
        t = p.detach()
        place = placement_of(p)
        for dim, a in enumerate(place.axes if place is not None else ()):
            if a is not None:
                t = _all_gather(t, a, dim)
        out[name] = t
    return out


# --------------------------------------------------------------------- tp

def _all_reduce(x: torch.Tensor, axis: Axis,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=op, group=axis.group)
    counts["tp_all_reduce"] += 1
    return x


class _CopyToTp(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, axis: Axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _ReduceFromTp(torch.autograd.Function):
    """Megatron's ``g``: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, axis: Axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """``x``, replicated over tp, as the input of column-parallel
    products: their partial cotangents are summed over tp backward."""
    return x if axis is None else _CopyToTp.apply(x, axis)


def reduce_from_tp(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The sum over tp of the row-parallel partial products ``x``."""
    return x if axis is None else _ReduceFromTp.apply(x, axis)


def vocab_parallel_embedding(table: torch.Tensor, tokens: torch.Tensor,
                             axis: Optional[Axis]) -> torch.Tensor:
    """Rows ``tokens`` of the table whose block ``table`` this rank holds
    (rows ``[i V/tp, (i + 1) V/tp)`` at tp index i): the local rows, zero
    where a token lies outside them, summed over tp. Exact: each row has
    one nonzero contribution."""
    if axis is None:
        return table[tokens]
    n = table.shape[0]
    local = tokens - axis.index * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)] * inside[..., None]
    return _ReduceFromTp.apply(rows, axis)
