"""``hvd.join()`` — graceful exit for ranks with uneven data.

Counterpart of ``horovod_tpu/collectives/join.py``. In the reference a rank
that runs out of data calls ``join()``, and the runtime answers collectives
on its behalf with zero contributions until every rank has joined. The JAX
package turns that into data: each rank carries an ``active`` flag, joined
ranks contribute zeros, and an Average divides by the active count. The
port keeps that design and runs it eagerly: each process passes its own
flag (a bool, or a 0-d tensor) every step, and every rank keeps calling the
collectives, joined or not.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..core import context_api as _ctx
from ..core.process_sets import ProcessSet
from . import ops as _ops
from .compression import Compression, Compressor
from .ops import Average, Sum


def _flag(active) -> torch.Tensor:
    return torch.as_tensor(bool(active), device=_ctx.device())


def _sum(t: torch.Tensor, process_set: Optional[ProcessSet]) -> torch.Tensor:
    """In-place sum over ``process_set``'s members; a rank outside the set
    keeps its own value, as the JAX package's singleton groups do."""
    if _ops._member(process_set):
        dist.all_reduce(t, group=_ops._group(process_set))
    return t


def join_count(active, *,
               process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """The number of ranks not yet joined: an int32 0-d tensor, the same
    on every rank (of ``process_set``)."""
    return _sum(_flag(active).to(torch.int32), process_set)


def join(active) -> Tuple[torch.Tensor, torch.Tensor]:
    """The join poll: ``(any_active, last_joined_rank)``.

    ``any_active`` (a bool 0-d tensor) is True while some rank still has
    data, the loop's continue flag; ``last_joined_rank`` (int32) is the
    highest rank still active, the rank whose state is freshest, or the
    reference's -1 once nobody is."""
    n = join_count(active)
    mine = torch.tensor(_ctx.rank() if bool(active) else -1,
                        dtype=torch.int32, device=_ctx.device())
    dist.all_reduce(mine, dist.ReduceOp.MAX)
    return n > 0, mine


Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def join_allreduce(tensor: Tensors, active, op: str = Average, *,
                   compression: Compressor = Compression.none,
                   process_set: Optional[ProcessSet] = None) -> Tensors:
    """All-reduce in which joined (inactive) ranks contribute zeros, of one
    tensor or of each of a list.

    ``op=Average`` divides by the number of active ranks (at least 1), the
    reference's JoinOp: gradients of exhausted ranks neither shift the mean
    nor stall the step, and with nobody active the result is zeros.
    Floating results keep their dtype; integers come back as float32. A
    rank outside ``process_set`` reduces alone."""
    if op not in (Sum, Average):
        raise ValueError(f"join_allreduce supports Sum and Average, got {op}")
    denom = max(int(join_count(active, process_set=process_set)), 1)
    act = bool(active)

    def leaf(x):
        cx, cctx = compression.compress(x)
        y = _sum(cx.clone() if act else torch.zeros_like(cx), process_set)
        if op == Average:
            y = y / denom
        return compression.decompress(y, cctx)

    if isinstance(tensor, torch.Tensor):
        return leaf(tensor)
    return [leaf(t) for t in tensor]


def iterate_with_join(batches: Sequence[Any],
                      total_steps: Optional[int] = None,
                      per_rank_lengths: Optional[Sequence[int]] = None
                      ) -> Iterable[Tuple[Any, bool]]:
    """Loop helper for uneven per-rank data. ``batches`` is this rank's
    list of batches. Yields ``(batch, active)`` for every step of the
    longest rank's data: ``active`` is this rank's flag, and a rank past
    its own data is fed its last batch (masked to no effect by
    :func:`join_allreduce`), and a rank with no batches at all is fed
    None, so that it still takes part in every step's collectives.

    The lengths are ``per_rank_lengths`` (or a ``batches.per_rank_lengths``
    attribute) where given, as in the JAX package; else each rank's
    ``len(batches)``, gathered across the ranks (one collective). The step
    count is ``total_steps``, else the longest length."""
    lengths = per_rank_lengths if per_rank_lengths is not None \
        else getattr(batches, "per_rank_lengths", None)
    if lengths is None:
        mine = torch.tensor([len(batches)], device=_ctx.device())
        lengths = [mine.clone() for _ in range(_ctx.size())]
        dist.all_gather(lengths, mine)
        lengths = [int(n) for n in lengths]
    total = total_steps if total_steps is not None else max(lengths)
    own = lengths[_ctx.rank()]
    for step in range(total):
        yield (batches[min(step, len(batches) - 1)] if len(batches)
               else None), step < own
