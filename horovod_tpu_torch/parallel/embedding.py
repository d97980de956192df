"""Embedding tables split table-wise over ``ep``, and the exchange of rows.

The JAX package's DLRM places its tables ``[T, R, D]`` on the logical axis
``"experts"`` (``horovod_tpu/models/dlrm.py``) and constrains the looked-up
rows to a batch-major layout; XLA derives the all-to-all between the two.
Here one process holds one ep rank's tables and this module writes the
exchange out, three ``all_to_all_single`` calls a step on the ep axis's
group:

1. :meth:`TableExchange.ids_to_owners`: each rank sends each owner the
   columns of its ``[b, T]`` ids that belong to the owner's tables;
2. :meth:`TableExchange.rows_to_batch`: each owner sends back the rows it
   gathered, and every rank assembles ``[b, T, D]`` in table order;
3. its backward, :meth:`TableExchange.grads_to_owners`: the reverse
   exchange brings each row's gradient to the owner of its table.

Each ep rank owns a contiguous run of whole tables (:func:`table_split`),
the first ``T % ep`` ranks one more, so ``T`` need not divide ``ep``. The
split sizes are known when the model is built and every rank holds the
same local batch, so the sizes of every exchange are static: no size is
exchanged and the host never waits for the card.

:data:`counts` counts each exchange where it is handed to
``torch.distributed`` (``all_to_all``) and each gather of a table block's
rows over its replicas (``all_gather``, the dp half of the sparse step in
``models/dlrm.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..collectives import ops as _ops
from .mesh import Axis

counts: Dict[str, int] = {"all_to_all": 0, "all_gather": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def table_split(num_tables: int, n: int) -> Tuple[int, ...]:
    """The tables each of ``n`` ep ranks owns, in order: contiguous runs,
    the first ``num_tables % n`` ranks one more (26 over 4: 7, 7, 6, 6)."""
    if num_tables < n:
        raise ValueError(f"{num_tables} tables cannot be split over {n} ep "
                         f"ranks: each owns at least one")
    q, r = divmod(num_tables, n)
    return tuple(q + (i < r) for i in range(n))


def by_owner(x: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """``[b, T, ...]`` -> the columns of each owner's tables, owner-major:
    ``[sum_j b T_j, ...]``, owner ``j``'s block ``[b, T_j, ...]`` flat."""
    rest = tuple(x.shape[2:])
    return torch.cat([part.reshape((-1,) + rest)
                      for part in x.split(list(sizes), dim=1)])


def from_owners(buf: torch.Tensor, sizes: Sequence[int],
                b: int) -> torch.Tensor:
    """Inverse of :func:`by_owner`: ``[b, T, ...]`` in table order."""
    rest = tuple(buf.shape[1:])
    return torch.cat([part.reshape((b, -1) + rest)
                      for part in buf.split([b * s for s in sizes])], dim=1)


def _all_to_all(x: torch.Tensor, send: Sequence[int], recv: Sequence[int],
                axis: Axis) -> torch.Tensor:
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), list(recv), list(send),
                           group=axis.group)
    counts["all_to_all"] += 1
    return out


class TableExchange:
    """The exchange of one table split over an ep ``axis`` (None, or an
    axis of size 1: every table local, nothing exchanged). ``sizes`` are
    the tables each ep rank owns; this rank owns ``local`` tables from
    table ``first`` on."""

    def __init__(self, num_tables: int, axis: Optional[Axis]):
        self.axis = axis if axis is not None and axis.size > 1 else None
        n, index = (self.axis.size, self.axis.index) if self.axis \
            else (1, 0)
        self.sizes = table_split(num_tables, n)
        self.first = sum(self.sizes[:index])
        self.local = self.sizes[index]

    def ids_to_owners(self, ids: torch.Tensor) -> torch.Tensor:
        """This rank's ids ``[b, T]`` -> the ids of its tables from every
        rank of the ep row, source-major: ``[ep b, T_local]``."""
        if self.axis is None:
            return ids
        b = ids.shape[0]
        got = _all_to_all(by_owner(ids, self.sizes),
                          [b * s for s in self.sizes],
                          [b * self.local] * self.axis.size, self.axis)
        return got.reshape(-1, self.local)

    def rows_to_batch(self, rows: torch.Tensor, b: int) -> torch.Tensor:
        """The rows this rank gathered for :meth:`ids_to_owners`' ids,
        ``[ep b T_local, D]`` -> this rank's looked-up rows ``[b, T, D]``
        in table order. Differentiable: the backward is
        :meth:`grads_to_owners`."""
        if self.axis is None:
            return rows.reshape(b, self.local, -1)
        return _RowsToBatch.apply(rows, self, b)

    def _rows_to_batch(self, rows: torch.Tensor, b: int) -> torch.Tensor:
        got = _all_to_all(rows, [b * self.local] * self.axis.size,
                          [b * s for s in self.sizes], self.axis)
        return from_owners(got, self.sizes, b)

    def grads_to_owners(self, g: torch.Tensor) -> torch.Tensor:
        """``[b, T, D]`` gradients of the looked-up rows -> those of this
        rank's tables, laid out as :meth:`rows_to_batch`'s input."""
        b = g.shape[0]
        return _all_to_all(by_owner(g, self.sizes),
                           [b * s for s in self.sizes],
                           [b * self.local] * self.axis.size, self.axis)


def gather_replicas(ids: torch.Tensor, grads: torch.Tensor, process_set
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-gather the flat ids ``[K]`` and row gradients ``[K, D]`` of one
    table block over the ranks that hold it (``process_set``, None: the
    world): Horovod's sparse all-reduce, whose sum the duplicate collapse
    of ``sparse_adagrad_update`` then takes. Every replica gets the same
    rows in the same order."""
    counts["all_gather"] += 2
    return (_ops.allgather(ids, process_set=process_set),
            _ops.allgather(grads, process_set=process_set))


class _RowsToBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, exchange: TableExchange, b: int):
        ctx.exchange = exchange
        return exchange._rows_to_batch(rows, b)

    @staticmethod
    def backward(ctx, g):
        return ctx.exchange.grads_to_owners(g), None, None
