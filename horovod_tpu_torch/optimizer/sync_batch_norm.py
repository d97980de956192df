"""SyncBatchNorm — batch normalisation with statistics taken across ranks.

Counterpart of ``horovod_tpu/optimizer/sync_batch_norm.py``, which is
``flax.linen.BatchNorm`` with ``axis_name`` set to the rank axis. The port
follows flax 0.12's arithmetic (``flax.linen.normalization._compute_stats``
and ``_normalize``), not ``torch.nn.BatchNorm2d``'s:

- the statistics are f32 whatever the input's dtype, with the fast variance
  ``max(0, E[x^2] - E[x]^2)``;
- across ranks each rank's per-channel pair ``(E[x], E[x^2])`` is stacked
  and averaged in ONE all-reduce, flax's single ``pmean``: every rank
  weighs alike, which is the global mean when the ranks hold equal batches;
- the input is normalised in f32, ``(x - mean) * (rsqrt(var + eps) *
  scale) + bias``, and the result cast to the compute dtype;
- the running statistics move as ``momentum * running + (1 - momentum) *
  batch`` with the BIASED batch variance (torch's BatchNorm keeps the
  unbiased one); momentum 0.9 and eps 1e-5 as the JAX ResNet sets them;
- no collective where the JAX package has none: in eval mode, and in a
  world of one, where the JAX model drops the axis
  (``horovod_tpu/models/resnet.py:107-109``).

The backward crosses ranks too. The statistics' cotangent is averaged
across the ranks (the transpose of ``pmean``), again in one all-reduce:
:class:`_AverageAcrossRanks` is a ``torch.autograd.Function`` with one
collective each way, and autograd does the rest.

Layout: channels in dim 1 (``[N, C, ...]``), torch's convention.
"""

from __future__ import annotations

import torch
from torch import nn

from ..collectives import ops as _ops
from ..core import context_api as _ctx


class _AverageAcrossRanks(torch.autograd.Function):
    """The per-channel statistics ``[2, C]`` averaged across the ranks; the
    backward averages their cotangent the same way."""

    @staticmethod
    def forward(ctx, stats):
        return _ops.allreduce(stats, _ops.Average)

    @staticmethod
    def backward(ctx, grad):
        return _ops.allreduce(grad.contiguous(), _ops.Average)


class SyncBatchNorm(nn.Module):
    """Batch normalisation over every dim but dim 1, with flax's statistics,
    synchronised across all ranks when ``sync`` and in training mode.

    ``weight`` and ``bias`` are flax's ``scale`` and ``bias`` (f32);
    ``running_mean`` and ``running_var`` its ``batch_stats``. The output is
    in ``dtype``. ``scale_init`` is the initial value of ``weight`` (the JAX
    ResNet starts each block's last one at zero)."""

    def __init__(self, num_features: int, *, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 sync: bool = True, scale_init: float = 1.0, device=None):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.sync = sync
        self.weight = nn.Parameter(torch.full((num_features,),
                                              float(scale_init),
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))
        #: False while a checkpointed block recomputes its forward, so the
        #: running statistics move once a step (``models/resnet.py``).
        self.update_stats = True

    def _synced(self) -> bool:
        return self.sync and _ctx.is_initialized() and _ctx.size() > 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            dims = [0, *range(2, x.dim())]
            stats = torch.stack([x32.mean(dims), x32.square().mean(dims)])
            if self._synced():
                stats = _AverageAcrossRanks.apply(stats)
            mean = stats[0]
            var = torch.clamp_min(stats[1] - mean.square(), 0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean
                                            + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)
