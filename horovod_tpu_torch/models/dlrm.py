"""DLRM: the deep learning recommendation model, its tables split over ep.

Counterpart of ``horovod_tpu/models/dlrm.py`` (BASELINE.md config 5): a
bottom MLP over the dense features, one embedding row looked up per table,
the pairwise dot products of the bottom MLP's output and the rows (upper
triangle, no diagonal), and a top MLP over those and the bottom output.

Parallelism, as the JAX model's hybrid:

- The tables ``[T, R, D]`` are split table-wise over the mesh's ``ep``
  axis; each rank holds its tables flat, ``[T_local R, D]`` (table ``t``'s
  row ``r`` at ``(t - first) R + r``). The looked-up rows reach the ranks
  that own the examples through ``parallel/embedding.py``'s exchange,
  whose backward brings each row gradient back to its table's owner.
- The MLPs are replicated; their gradients are averaged over every data
  rank (dp x ep) by ``DistributedOptimizer``.
- A mesh with ``dp > 1`` replicates each table block over dp.

Two ways to train the tables, as in the reference:

- :func:`make_sparse_dlrm_step` (:func:`build_sparse_training` sets it
  up): the rows are gathered outside autograd and passed as ``looked``,
  so the tables never get a dense gradient; their gradients exist only
  for the rows, which :func:`sparse_adagrad_update` applies. On a mesh
  with ``dp > 1`` the replicas of a block first all-gather their (flat
  ids, row gradients), Horovod's sparse all-reduce.
- Horovod's own DLRM recipe on ``{"dp": n}``: ``DLRM(...,
  sparse_grad=True)`` gives the whole, replicated table a sparse
  gradient (``F.embedding(..., sparse=True)``), which
  ``DistributedOptimizer`` reduces with ``sparse_allreduce`` and
  ``optimizer.adagrad.Adagrad`` applies to the rows it names.

Where a port goes wrong, kept as it computes:

- The interaction keeps ``jnp.triu_indices(n, k=1)``'s row-major order
  (``torch.triu_indices(n, n, 1)`` gives the same): the top MLP's first
  kernel is laid out in it. At Criteo width n = 27, 351 pairs, a top input
  of 64 + 351 = 415.
- The loss is the global batch's mean. Each rank back-propagates its local
  mean, so its row gradients are divided by the number of data shards
  before the update: Adagrad would not absorb a factor there (its
  accumulator starts at 0.1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..collectives import ops as _ops
from ..optimizer.adagrad import Adagrad, sparse_adagrad_update
from ..optimizer.distributed import DistributedOptimizer
from ..parallel.embedding import TableExchange, gather_replicas
from ..parallel.mesh import Mesh, axis_size, get_mesh
from ..parallel.sharding import replica_set, token_shards
from .llama import _default_device, _lecun_normal_

@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    num_tables: int = 26
    rows_per_table: int = 100000
    embed_dim: int = 64
    dense_features: int = 13
    bottom_mlp: Sequence[int] = (512, 256, 64)
    top_mlp: Sequence[int] = (512, 256, 1)


def dlrm_criteo() -> DLRMConfig:
    return DLRMConfig()


def dlrm_tiny() -> DLRMConfig:
    return DLRMConfig(num_tables=8, rows_per_table=64, embed_dim=8,
                      dense_features=4, bottom_mlp=(16, 8),
                      top_mlp=(16, 1))


class _Dense(nn.Module):
    """``nn.Dense`` with a bias, in f32: weight ``[out, in]``."""

    def __init__(self, fan_in: int, fan_out: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fan_out, fan_in,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(fan_out, device=device))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class MLPStack(nn.Module):
    """Dense layers ``fc0``, ``fc1``, ... of ``sizes`` over ``fan_in``
    inputs, a ReLU after each (after the last only with ``final_act``)."""

    def __init__(self, fan_in: int, sizes: Sequence[int], device,
                 final_act: bool = True):
        super().__init__()
        self.final_act = final_act
        self.n = len(sizes)
        for i, s in enumerate(sizes):
            self.add_module(f"fc{i}", _Dense(fan_in, s, device))
            fan_in = s

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(x)
            if i < self.n - 1 or self.final_act:
                x = F.relu(x)
        return x


class DLRM(nn.Module):
    """Inputs: ``dense [B, dense_features]`` float, ``sparse [B,
    num_tables]`` int (one categorical id per table). Output: logits
    ``[B]``.

    Parameters are made on ``device`` (the context's device, else
    ``"cuda"``) from a ``torch.Generator`` seeded with ``seed``: the whole
    tables (normal, std 0.01), then each dense kernel (lecun-normal; zero
    biases), bottom then top. Under ``mesh`` (default: the ambient mesh;
    only ``dp`` and ``ep`` may exceed 1) the rank keeps its ep block of the
    tables, so its values are the whole model's. ``sparse_grad`` makes the
    tables' gradient sparse (Horovod's recipe; see the module doc)."""

    def __init__(self, cfg: DLRMConfig, *, device=None, seed: int = 0,
                 mesh: Optional[Mesh] = None, sparse_grad: bool = False):
        super().__init__()
        if cfg.bottom_mlp[-1] != cfg.embed_dim:
            raise ValueError("bottom_mlp must end at embed_dim")
        device = _default_device(device)
        mesh = get_mesh() if mesh is None else mesh
        if mesh is not None:
            other = [a for a in mesh.axis_names
                     if mesh.shape[a] > 1 and a not in ("dp", "ep")]
            if other:
                raise ValueError(f"DLRM splits its batch over dp and ep "
                                 f"only; the mesh has {other}")
        self.cfg, self.mesh, self.sparse_grad = cfg, mesh, sparse_grad
        T, R, D = cfg.num_tables, cfg.rows_per_table, cfg.embed_dim
        self.exchange = TableExchange(
            T, mesh.axes.get("ep") if mesh is not None else None)
        local, first = self.exchange.local, self.exchange.first
        self.embedding_tables = nn.Parameter(torch.empty(local * R, D,
                                                         device=device))
        self.bottom = MLPStack(cfg.dense_features, cfg.bottom_mlp, device)
        n = T + 1
        self.top = MLPStack(D + n * (n - 1) // 2, cfg.top_mlp, device,
                            final_act=False)
        iu, ju = torch.triu_indices(n, n, 1, device=device)
        self.register_buffer("_pairs", iu * n + ju, persistent=False)
        self.register_buffer("_row_base",
                             torch.arange(local, device=device) * R,
                             persistent=False)
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            if local == T:
                self.embedding_tables.normal_(0.0, 0.01, generator=gen)
            else:
                whole = torch.empty(T * R, D, device=device)
                whole.normal_(0.0, 0.01, generator=gen)
                self.embedding_tables.copy_(whole[first * R:
                                                  (first + local) * R])
                del whole
            for stack in (self.bottom, self.top):
                for i in range(stack.n):
                    _lecun_normal_(getattr(stack, f"fc{i}").weight, gen)

    def owner_ids(self, sparse: torch.Tensor) -> torch.Tensor:
        """The flat rows of this rank's tables that every rank of its ep
        row looks up for its ``sparse [b, T]`` ids, source-major: ``[ep b
        T_local]`` (one exchange of ids; none without an ep split)."""
        ids = self.exchange.ids_to_owners(sparse)
        return (ids + self._row_base).reshape(-1)

    def lookup(self, sparse: torch.Tensor) -> torch.Tensor:
        """This rank's looked-up rows ``[b, T, D]``, through the exchange,
        differentiable in the tables."""
        rows = F.embedding(self.owner_ids(sparse), self.embedding_tables,
                           sparse=self.sparse_grad)
        return self.exchange.rows_to_batch(rows, sparse.shape[0])

    def forward(self, dense: torch.Tensor, sparse: torch.Tensor,
                looked: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``looked [b, T, D]``, rows the caller gathered itself (the
        sparse step), stands in for the lookup."""
        d = self.bottom(dense)
        if looked is None:
            looked = self.lookup(sparse)
        feats = torch.cat([d[:, None, :], looked], dim=1)
        inter = torch.bmm(feats, feats.transpose(1, 2))  # [b, n, n]
        inter = inter.flatten(1).index_select(1, self._pairs)
        out = self.top(torch.cat([d, inter], dim=1))
        return out[:, 0]


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy on click labels (the DLRM objective), the
    reference's formula."""
    logits = logits.float()
    return torch.mean(logits.clamp_min(0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def make_sparse_dlrm_step(model: DLRM, opt_dense: torch.optim.Optimizer, *,
                          lr: float, eps: float = 1e-7, loss=bce_loss):
    """The train step with the reference's sparse-embedding semantics:
    ``step(tables_flat, accum_flat, dense, sparse, labels) -> loss``, this
    rank's ``[b, ...]`` shard of the global batch in, the global batch's
    mean loss out. The MLPs step through ``opt_dense`` (a
    ``DistributedOptimizer`` on a mesh), the tables (``model``'s, updated
    in place) through :func:`sparse_adagrad_update` on the rows this step
    looked up: one exchange of ids, one of rows and, in backward, one of
    row gradients over ep; over dp an all-gather of each block's (ids,
    gradients); one all-reduce of the loss with more than one data
    shard."""
    mesh = model.mesh
    shards = token_shards(mesh) if mesh is not None else 1
    replicas = axis_size(mesh, "dp") > 1
    holders = replica_set(mesh, ("ep",)) if replicas else None

    def step(tables_flat, accum_flat, dense, sparse, labels):
        model.train()
        opt_dense.zero_grad(set_to_none=True)
        fid = model.owner_ids(sparse)
        with torch.no_grad():
            rows = tables_flat[fid]
        rows.requires_grad_(True)
        looked = model.exchange.rows_to_batch(rows, sparse.shape[0])
        lval = loss(model(dense, sparse, looked=looked), labels)
        lval.backward()
        opt_dense.step()
        grads = rows.grad / shards if shards > 1 else rows.grad
        if replicas:
            fid, grads = gather_replicas(fid, grads, holders)
        sparse_adagrad_update(tables_flat, accum_flat, fid, grads, lr, eps)
        lval = lval.detach()
        return _ops.allreduce(lval, _ops.Average) if shards > 1 else lval

    return step


def build_sparse_training(model: DLRM, *, lr: float = 1e-2,
                          eps: float = 1e-7, acc0: float = 0.1):
    """The whole sparse-embedding training setup, in one place: Adagrad
    with optax's rule (``initial_accumulator_value = acc0``) over the MLPs,
    wrapped in ``DistributedOptimizer`` when the model has a mesh, the
    tables' accumulator (``acc0`` everywhere) and the step. Returns
    ``(step, tables_flat, accum_flat)``; call ``step(tables_flat,
    accum_flat, dense, sparse, labels)``. The tables are the model's
    parameter, updated in place. There is no layout to pin, unlike the
    reference's XLA entry layouts."""
    named = [(k, p) for k, p in model.named_parameters()
             if k != "embedding_tables"]
    opt = Adagrad([p for _, p in named], lr=lr,
                  initial_accumulator_value=acc0, eps=eps)
    if model.mesh is not None:
        opt = DistributedOptimizer(opt, named_parameters=named)
    tables = model.embedding_tables
    accum = torch.full_like(tables, acc0, requires_grad=False)
    return (make_sparse_dlrm_step(model, opt, lr=lr, eps=eps),
            tables, accum)
