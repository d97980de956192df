"""Named meshes over a ``torch.distributed`` world: dp, ep and sp.

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

The port runs ``dp``, ``ep`` (the MoE experts, ``parallel/moe.py``) and
``sp``. The other canonical axes (``pp``, ``fsdp``, ``tp``) belong to the
model-parallel slice; a size > 1 for one of them raises
``NotImplementedError``. ``create_hybrid_mesh`` waits for the same slice
(ROADMAP.md, section A).

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

#: The axes a later slice ports, and the slice that does.
_LATER = {"pp": "the pipeline", "fsdp": "the model-parallel (FSDP)",
          "tp": "the tensor-parallel"}


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
    sizes (``shape``) and this rank's :class:`Axis` on each."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    axes: Dict[str, Axis]

    def axis(self, name: str) -> Axis:
        return self.axes[name]


def create_mesh(axis_sizes: Dict[str, int]) -> Mesh:
    """Build a named mesh over the initialised world. Axes of size 1 are
    kept, so code can name them unconditionally; the product of the sizes
    must be the world size. Collective: every rank calls it with the same
    sizes."""
    names = [a for a in AXIS_ORDER if a in axis_sizes]
    names += [a for a in axis_sizes if a not in names]  # user extras last
    sizes = [int(axis_sizes[a]) for a in names]
    world, rank = _ctx.size(), _ctx.rank()
    total = math.prod(sizes)
    if total != world:
        raise ValueError(
            f"mesh axes {dict(zip(names, sizes))} require {total} devices, "
            f"have {world}")
    for a, n in zip(names, sizes):
        if n > 1 and a in _LATER:
            raise NotImplementedError(
                f"mesh axis {a!r} of size {n}: the port runs dp, ep and "
                f"sp; {a} comes with {_LATER[a]} slice (ROADMAP.md, "
                f"section A)")
    grid = torch.arange(world).reshape(sizes) if sizes else None
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
    return Mesh(tuple(names), dict(zip(names, sizes)), axes)


def _rows(grid: torch.Tensor, i: int) -> List[Tuple[int, ...]]:
    """Every row of axis ``i``, in one order on every rank."""
    moved = grid.movedim(i, -1).reshape(-1, grid.shape[i])
    return [tuple(int(r) for r in row) for row in moved]


def axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def shift(axis: Axis, tensors: Sequence[torch.Tensor],
          step: int) -> List[torch.Tensor]:
    """Send each tensor to the rank ``step`` places on along ``axis`` and
    return what the rank ``step`` places back sent: one
    ``batch_isend_irecv`` on the axis's group, every rank posting the same
    sends and receives (``lax.ppermute`` with the cyclic permutation
    ``r -> r + step``)."""
    to = axis.ranks[(axis.index + step) % axis.size]
    frm = axis.ranks[(axis.index - step) % axis.size]
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, to, axis.group) for t in tensors]
           + [dist.P2POp(dist.irecv, o, frm, axis.group) for o in outs])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


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
