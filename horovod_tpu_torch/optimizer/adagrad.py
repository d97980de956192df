"""Adagrad with optax's rule, dense and restricted to the rows a batch touched.

Counterpart of ``optax.adagrad`` (``scale_by_rss``, then the learning rate)
and of ``horovod_tpu/models/dlrm.py::sparse_adagrad_update``, the two halves
of the JAX package's DLRM optimizer. ``torch.optim.Adagrad`` is another
rule: it divides by ``sqrt(acc) + eps`` and starts its accumulator at 0,
where optax takes ``rsqrt(acc + eps)`` wherever ``acc > 0`` and starts at
``initial_accumulator_value`` (0.1). A factor off there is not absorbed
later, so the port carries optax's rule in one place (:func:`_rss`) for
both halves:

- :class:`Adagrad`, a ``torch.optim.Optimizer`` (the dense MLPs; it can
  be wrapped by ``DistributedOptimizer``). A parameter whose gradient is
  sparse (``F.embedding(..., sparse=True)``) takes the row-restricted
  update below, on its accumulator;
- :func:`sparse_adagrad_update`, which touches only the looked-up rows of
  flat ``[N, D]`` tables. Untouched rows have a gradient of exactly zero,
  so it equals dense Adagrad over the whole table, provided duplicate ids
  are summed before the accumulator update, as the dense gradient sums
  them.

The row update keeps the reference's fixed-shape formulation (a sort, head
flags, a cumulative sum, a ``[K, D]`` segment sum and ``uid`` with
out-of-range tail ids) and no ``unique``, boolean-mask indexing or
``nonzero``, which would make the card wait for the host inside the step.
Its sums are ``index_put_(..., accumulate=True)``, which sorts its indices
and sums each run of duplicates in order on the card (``index_add_`` and
``scatter_add_`` use atomics there, whose order of arrival would move the
last bits): two calls on the same inputs are bit-identical, so the
replicas of a table block that apply the same rows stay equal.
"""

from __future__ import annotations

import torch


def _rss(acc: torch.Tensor, eps: float) -> torch.Tensor:
    """optax ``scale_by_rss``'s factor: ``rsqrt(acc + eps)`` where ``acc >
    0``, else 0."""
    return torch.where(acc > 0, torch.rsqrt(acc + eps),
                       torch.zeros_like(acc))


@torch.no_grad()
def sparse_adagrad_update(tables_flat: torch.Tensor,
                          accum_flat: torch.Tensor, flat_idx: torch.Tensor,
                          row_grads: torch.Tensor, lr: float,
                          eps: float = 1e-7):
    """Adagrad on flat tables ``[N, D]`` (table t's row r at ``t R + r``)
    touching only the rows ``flat_idx [K]`` whose gradients are
    ``row_grads [K, D]``, ids repeating as they like. Updates
    ``tables_flat`` and ``accum_flat`` in place and returns them.

    Duplicates are summed first (one stable sort, flat ids never collide
    across tables), into a compact ``[K, D]`` workspace; segment ``s``
    holds the ``s``-th distinct id, and the ``K - S`` tail segments the
    out-of-range id ``N``. A tail segment's sum is 0: it reads and writes
    the row numbered by its own position (mod N), adding ``-lr * 0 * inv
    = -0.0`` to the table (the identity of IEEE addition) and ``+0.0`` to
    the accumulator (never negative), which leaves that row as it was, as
    the reference's ``mode="drop"`` does. Each tail gets a row of its own
    because ``index_put_`` sums a run of equal indices serially: thousands
    of tails on one row would queue behind each other."""
    N = tables_flat.shape[0]
    ids_s, order = torch.sort(flat_idx, stable=True)
    g_s = row_grads[order]
    head = torch.ones_like(ids_s, dtype=torch.bool)
    head[1:] = ids_s[1:] != ids_s[:-1]
    seg = torch.cumsum(head, 0) - 1
    gsum = torch.zeros_like(g_s).index_put_((seg,), g_s, accumulate=True)
    uid = torch.full_like(ids_s, N).index_put_((seg,), ids_s)
    rows = torch.where(uid < N, uid, torch.arange(
        uid.shape[0], device=uid.device) % N)
    sq = gsum * gsum
    acc_new = accum_flat[rows] + sq
    tables_flat.index_put_((rows,), -lr * gsum * _rss(acc_new, eps),
                           accumulate=True)
    accum_flat.index_put_((rows,), sq, accumulate=True)
    return tables_flat, accum_flat


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad(lr, initial_accumulator_value, eps)``: per element
    ``acc += g * g``, ``p += -lr * g * rsqrt(acc + eps)`` where ``acc >
    0``. A parameter with a sparse gradient takes
    :func:`sparse_adagrad_update` on its rows (a row-sparse gradient of a
    2-D parameter, as ``F.embedding(..., sparse=True)`` gives, coalesced
    or not). The accumulator is ``state[p]["sum"]``."""

    def __init__(self, params, lr: float = 1e-2,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        if initial_accumulator_value < 0:
            raise ValueError("initial_accumulator_value must be >= 0")
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, eps = group["lr"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if "sum" not in state:
                    state["sum"] = torch.full_like(
                        p, group["initial_accumulator_value"],
                        memory_format=torch.preserve_format)
                g, acc = p.grad, state["sum"]
                if g.is_sparse:
                    if g.sparse_dim() != 1 or p.dim() != 2:
                        raise ValueError(
                            "Adagrad takes row-sparse gradients of 2-D "
                            f"parameters; got sparse_dim {g.sparse_dim()} "
                            f"of a {p.dim()}-D parameter")
                    sparse_adagrad_update(p, acc, g._indices()[0],
                                          g._values(), lr, eps)
                    continue
                # optax's order of operations: acc = g**2 + acc, then
                # (-lr) * (inv * g) added to p
                acc.add_(g * g)
                p.add_(_rss(acc, eps) * g * -lr)
        return loss
