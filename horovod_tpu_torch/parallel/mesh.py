"""Named meshes over a ``torch.distributed`` world: pp, dp, fsdp, ep, sp, tp.

Counterpart of ``horovod_tpu/parallel/mesh.py``. A JAX mesh is an array of
devices with named axes, and ``shard_map`` binds each axis name for the
collectives inside it. Here one process drives one GPU, so a mesh is this
rank's view of the same array: for each axis of size > 1, the
``torch.distributed`` process group of the ranks that differ from this one
only along that axis (its row), and this rank's index on every axis.

Ranks are laid out row-major over the axes in :data:`AXIS_ORDER`, so the
inner axes get contiguous global ranks: ``sp`` neighbours are the cards
next to each other, as JAX's ``create_mesh`` gives the innermost axes the
most contiguous placement. Making a group is collective, so every rank
makes every row's group of every axis, in one order, including the groups
it is not in.

Every canonical axis runs: ``dp``, ``fsdp`` and ``tp`` (the Llama's
parameter placement, ``parallel/sharding.py``), ``ep`` (the MoE experts,
``parallel/moe.py``), ``sp`` (ring attention and Ulysses) and ``pp``
(``parallel/pipeline.py``). :func:`create_hybrid_mesh` lays the axes over
the world's two-level layout (``core/context_api.py``): the DCN factors
across nodes, the ICI factors within one.

:func:`set_mesh` makes a mesh ambient, the counterpart of
``jax.sharding.set_mesh``: the Llama's attention and the GSPMD step read it
through :func:`get_mesh`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core import context_api as _ctx

AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a mesh as this rank sees it: its size, this rank's index
    on it, the global ranks of its row in axis order, and the row's process
    group (None for an axis of size 1)."""

    name: str
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Optional[dist.ProcessGroup]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named mesh over the world: ``axis_names`` in layout order, their
    sizes (``shape``), this rank's :class:`Axis` on each, and the global
    rank at every coordinate (``ranks``, row-major over the axes)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    axes: Dict[str, Axis]
    ranks: Tuple[int, ...]

    def axis(self, name: str) -> Axis:
        return self.axes[name]

    def grid(self) -> torch.Tensor:
        """The global ranks as an array shaped by the axes."""
        return torch.tensor(self.ranks).reshape(
            [self.shape[a] for a in self.axis_names])


def _ordered(axis_sizes: Dict[str, int]) -> List[str]:
    names = [a for a in AXIS_ORDER if a in axis_sizes]
    return names + [a for a in axis_sizes if a not in names]  # extras last


def create_mesh(axis_sizes: Dict[str, int]) -> Mesh:
    """Build a named mesh over the initialised world. Axes of size 1 are
    kept, so code can name them unconditionally; the product of the sizes
    must be the world size. Collective: every rank calls it with the same
    sizes."""
    names = _ordered(axis_sizes)
    sizes = [int(axis_sizes[a]) for a in names]
    world = _ctx.size()
    total = math.prod(sizes)
    if total != world:
        raise ValueError(
            f"mesh axes {dict(zip(names, sizes))} require {total} devices, "
            f"have {world}")
    return _mesh_from_grid(names, torch.arange(world).reshape(sizes))


def create_hybrid_mesh(ici_axes: Dict[str, int],
                       dcn_axes: Dict[str, int]) -> Mesh:
    """A mesh over the two-level layout of the world (``cross_size`` nodes
    of ``local_size`` ranks, rank = cross_rank * local_size + local_rank):
    ``dcn_axes`` across the nodes, ``ici_axes`` within each. An axis of
    both has size ``dcn * ici``, and a rank's coordinate on axis ``a`` is
    ``dcn_index_a * ici_a + ici_index_a``, the node's index outer, as in
    JAX's ``create_hybrid_device_mesh``. Axes with a DCN factor sort
    outermost, a user's axis too, so the axes within a node stay inner.
    The product of the ICI sizes must be the local size and that of the
    DCN sizes the node count, else ``ValueError``. Collective."""
    names = _ordered(dcn_axes) + [a for a in _ordered(ici_axes)
                                  if a not in dcn_axes]
    ici = [int(ici_axes.get(a, 1)) for a in names]
    dcn = [int(dcn_axes.get(a, 1)) for a in names]
    nodes, local = _ctx.cross_size(), _ctx.local_size()
    if math.prod(ici) != local or math.prod(dcn) != nodes:
        raise ValueError(
            f"hybrid mesh ici {dict(ici_axes)} x dcn {dict(dcn_axes)} needs "
            f"{math.prod(dcn)} nodes of {math.prod(ici)} ranks; the world "
            f"has {nodes} of {local}")
    grid = torch.empty([i * d for i, d in zip(ici, dcn)], dtype=torch.long)
    for node in range(nodes):
        outer = torch.unravel_index(torch.tensor(node), dcn)
        for lr in range(local):
            inner = torch.unravel_index(torch.tensor(lr), ici)
            coord = tuple(int(o) * i + int(n)
                          for o, i, n in zip(outer, ici, inner))
            grid[coord] = node * local + lr
    return _mesh_from_grid(names, grid)


def _mesh_from_grid(names: List[str], grid: torch.Tensor) -> Mesh:
    """The mesh whose coordinate ``c`` is global rank ``grid[c]``; makes
    every row's group of every axis of size > 1, on every rank, in one
    order."""
    sizes = list(grid.shape)
    rank = _ctx.rank()
    coords = ([int(c) for c in
               torch.nonzero(grid == rank, as_tuple=False)[0]]
              if sizes else [])
    axes = {}
    for i, (a, n) in enumerate(zip(names, sizes)):
        row = tuple(int(r) for r in grid.movedim(i, -1)[
            tuple(coords[:i] + coords[i + 1:])])
        group = None
        if n > 1:
            for other in _rows(grid, i):  # every row, on every rank
                g = dist.new_group(list(other))
                if other == row:
                    group = g
        axes[a] = Axis(a, n, coords[i], row, group)
    return Mesh(tuple(names), dict(zip(names, sizes)), axes,
                tuple(int(r) for r in grid.reshape(-1)))


def _rows(grid: torch.Tensor, i: int) -> List[Tuple[int, ...]]:
    """Every row of axis ``i``, in one order on every rank."""
    moved = grid.movedim(i, -1).reshape(-1, grid.shape[i])
    return [tuple(int(r) for r in row) for row in moved]


def axis_size(mesh: Optional[Mesh], name: str) -> int:
    """The size of axis ``name`` on ``mesh``; 1 if it lacks it or if there
    is no mesh."""
    return 1 if mesh is None else mesh.shape.get(name, 1)


def _exchange(axis: Axis, tensors: Sequence[torch.Tensor],
              step: int) -> List[torch.Tensor]:
    to = axis.ranks[(axis.index + step) % axis.size]
    frm = axis.ranks[(axis.index - step) % axis.size]
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, to, axis.group) for t in tensors]
           + [dist.P2POp(dist.irecv, o, frm, axis.group) for o in outs])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


class _Shift(torch.autograd.Function):
    """:func:`shift` under autograd: the backward shifts the cotangents
    ``-step`` places, the transpose of the cyclic permutation."""

    @staticmethod
    def forward(ctx, axis: Axis, step: int, *tensors):
        ctx.axis, ctx.step = axis, step
        return tuple(_exchange(axis, tensors, step))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_exchange(ctx.axis, grads, -ctx.step))


def shift(axis: Axis, tensors: Sequence[torch.Tensor],
          step: int) -> List[torch.Tensor]:
    """Send each tensor to the rank ``step`` places on along ``axis`` and
    return what the rank ``step`` places back sent: one
    ``batch_isend_irecv`` on the axis's group, every rank posting the same
    sends and receives (``lax.ppermute`` with the cyclic permutation
    ``r -> r + step``). Differentiable, as ``ppermute`` is: the backward
    sends each cotangent back the way its tensor came."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return list(_Shift.apply(axis, step, *tensors))
    return _exchange(axis, tensors, step)


# The ambient mesh is process-wide, not thread-local: autograd runs the
# backward of CUDA tensors, and with it a checkpoint's recompute of the
# forward, on its own device threads, and the recompute must see the mesh
# the forward saw.
_ambient: Optional[Mesh] = None


@contextlib.contextmanager
def set_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the ambient mesh inside the ``with`` block."""
    global _ambient
    before, _ambient = _ambient, mesh
    try:
        yield mesh
    finally:
        _ambient = before


def get_mesh() -> Optional[Mesh]:
    """The ambient mesh, or None outside :func:`set_mesh`."""
    return _ambient
