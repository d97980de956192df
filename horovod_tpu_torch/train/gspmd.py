"""Context-parallel LM training over a dp x sp mesh.

Counterpart of ``horovod_tpu/train/gspmd.py`` for the ``dp`` and ``sp``
axes. The JAX step shards the tokens ``[B, T]`` batch over the data axes
and sequence over ``sp`` and lets XLA insert every collective. Here each
rank runs its own shard ``[B/dp, T/sp]`` (:func:`shard_tokens`), the
model's ring or Ulysses attention exchanges K/V over the ``sp`` axis of the
ambient mesh, and one ``DistributedOptimizer`` all-reduce over the world
makes the gradient. The fsdp and tp rules, ``scan_steps``, ``accum_steps``,
the sentinel and the deferred (two-program) step belong to later slices
(ROADMAP.md, section A).
"""

from __future__ import annotations

import torch

from ..collectives import ops as _ops
from ..core import context_api as _ctx
from ..parallel.mesh import Mesh, axis_size, set_mesh, shift
from .dp import TrainState
from .losses import next_token_loss  # noqa: F401  (the JAX module's loss)


def shard_tokens(tokens: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the global ``tokens [B, T]``: batch rows by its
    ``dp`` index, sequence positions by its ``sp`` index."""
    B, T = tokens.shape
    out = tokens
    for name, dim in (("dp", 0), ("sp", 1)):
        n = axis_size(mesh, name)
        if n > 1:
            size = (B, T)[dim]
            if size % n:
                raise ValueError(f"{('batch', 'sequence')[dim]} {size} is "
                                 f"not divisible by the {name} axis size {n}")
            i = mesh.axis(name).index
            out = out.narrow(dim, i * (size // n), size // n)
    return out.contiguous()


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


def make_gspmd_train_step(model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer, mesh: Mesh):
    """The LM train step over ``mesh``: ``step(state, tokens) -> (state,
    loss)``, ``tokens`` this rank's ``[B/dp, T/sp]`` shard of the global
    batch (:func:`shard_tokens`), ``loss`` the global mean next-token loss
    over the ``B (T - 1)`` targets, as the JAX step returns it.

    ``optimizer`` is a ``DistributedOptimizer`` over the whole world with
    ``op=Average`` (the default). The parameters are replicated over dp and
    sp, so the gradient of the global mean L is the sum over all ranks of
    the gradient each rank's shard contributes; the ring's and Ulysses'
    backward already carry each rank's share of the others' K/V back to
    them. With N = B (T - 1) targets and W = dp x sp ranks, each rank
    back-propagates ``(W / N) x`` its shard's summed loss, and the world
    Average (sum / W) of those gradients is exactly dL/dtheta.

    The ring's point-to-point exchanges on the sp group and the
    optimizer's bucket all-reduces on the world group are launched during
    backward in an order fixed by the graph, the same on every rank."""
    if getattr(optimizer, "_op", None) != _ops.Average \
            or getattr(optimizer, "_process_set", None) is not None:
        raise ValueError("make_gspmd_train_step needs a DistributedOptimizer "
                         "over the whole world with op=Average")
    world = _ctx.size()
    if world != axis_size(mesh, "dp") * axis_size(mesh, "sp"):
        raise ValueError(f"the mesh {mesh.shape} does not cover the world of "
                         f"{world} ranks with dp and sp")

    def step(state: TrainState, tokens: torch.Tensor):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        B, T = tokens.shape
        n = (B * axis_size(mesh, "dp")) * (T * axis_size(mesh, "sp") - 1)
        with set_mesh(mesh):
            nll = _shard_nll_sum(model(tokens), tokens, mesh)
            (nll * (world / n)).backward()
        optimizer.step()
        loss = _ops.allreduce(nll.detach(), _ops.Sum) / n
        return state._replace(step=state.step + 1), loss

    return step
