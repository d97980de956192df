"""Training losses.

Counterparts of ``horovod_tpu/train/gspmd.py::next_token_loss``,
``horovod_tpu/models/bert.py::mlm_loss`` and the masked cross entropy of
``benchmarks/bert.py``, and :func:`vocab_parallel_nll`, the loss over
logits split over the vocabulary on a tp axis, which XLA derives in JAX
from the vocab-sharded logits. :func:`mlm_loss_sums` is the masked-LM
loss in the form the GSPMD step's ``loss_fn`` takes: a shard's sum and
count, divided there by the global count.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.mesh import Axis
from ..parallel.sharding import _all_reduce


class _VocabParallelNll(torch.autograd.Function):
    """``lse - target logit`` over logits whose last dim is this rank's
    block ``[i V/tp, (i + 1) V/tp)`` of the vocabulary: the max (no
    gradient), the sum of exponentials and the target logit are each
    all-reduced over tp (the last two in one call). The backward is
    ``softmax - onehot`` on the local block, with nothing to exchange."""

    @staticmethod
    def forward(ctx, logits, targets, axis: Axis):
        n = logits.shape[-1]
        m = _all_reduce(logits.amax(-1), axis, dist.ReduceOp.MAX)
        local = targets - axis.index * n
        inside = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        tgt = torch.gather(logits, -1, local[..., None]).squeeze(-1)
        sums = _all_reduce(torch.stack(
            [torch.exp(logits - m[..., None]).sum(-1),
             torch.where(inside, tgt, 0.0)]), axis)
        lse = m + torch.log(sums[0])
        ctx.save_for_backward(logits, lse, local, inside)
        return lse - sums[1]

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, inside = ctx.saved_tensors
        grad = torch.exp(logits - lse[..., None])
        grad.scatter_add_(-1, local[..., None],
                          -inside.to(grad.dtype)[..., None])
        return grad.mul_(g[..., None]), None, None


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                       axis: Optional[Axis] = None) -> torch.Tensor:
    """``logsumexp - target logit`` in f32 at every position of ``logits
    [..., V]``, or, on a tp ``axis``, of its vocab block ``[..., V/tp]``
    (the logits are never gathered whole)."""
    logits = logits.float()
    if axis is None:
        tgt = torch.gather(logits, -1, targets[..., None]).squeeze(-1)
        return torch.logsumexp(logits, dim=-1) - tgt
    return _VocabParallelNll.apply(logits, targets, axis)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    mask: torch.Tensor = None,
                    axis: Optional[Axis] = None) -> torch.Tensor:
    """Shifted next-token cross entropy, written as ``logsumexp - target
    logit`` so the full ``[B, T, V]`` log-probabilities are never kept.
    ``mask`` ``[B, T]`` weights the target positions. On a tp ``axis`` the
    logits are this rank's vocab block (:func:`vocab_parallel_nll`)."""
    nll = vocab_parallel_nll(logits[:, :-1], tokens[:, 1:], axis)
    if mask is not None:
        m = mask[:, 1:].to(nll.dtype)
        return (nll * m).sum() / m.sum().clamp_min(1.0)
    return nll.mean()


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor, axis: Optional[Axis] = None) -> torch.Tensor:
    """Masked-LM cross entropy over the positions where ``mask`` is set
    (``horovod_tpu/models/bert.py::mlm_loss``); on a tp ``axis`` the
    logits are this rank's vocab block (:func:`vocab_parallel_nll`)."""
    total, count = mlm_loss_sums(logits, (None, labels, mask), axis)
    return total / count.clamp_min(1.0)


def mlm_loss_sums(logits: torch.Tensor, batch,
                  axis: Optional[Axis] = None):
    """The masked-LM loss as the GSPMD step's ``loss_fn`` takes it
    (``train.make_gspmd_train_step``): ``batch`` is ``(tokens, labels,
    mask)``, this rank's shards, and the result ``(total, count)``, the
    f32 cross entropy summed over the positions where ``mask`` is set and
    their number. The step divides by the count summed over the data
    shards, as JAX's ``mlm_loss`` divides by the global batch's."""
    _, labels, mask = batch
    nll = vocab_parallel_nll(logits, labels, axis)
    m = mask.to(nll.dtype)
    return (nll * m).sum(), m.sum()


def masked_label_loss(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy over the positions whose label is not -1, the labels
    carrying their own mask (``benchmarks/bert.py``'s ``loss_fn``)."""
    valid = labels >= 0
    return mlm_loss(logits, labels.clamp_min(0), valid)
