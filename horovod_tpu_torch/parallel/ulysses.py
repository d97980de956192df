"""Ulysses-style sequence parallelism: all-to-all head scatter.

Counterpart of ``horovod_tpu/parallel/ulysses.py`` (DeepSpeed-Ulysses):
activations arrive sequence-sharded ``[B, T/n, H, D]``; one all-to-all
re-shards them head-sharded ``[B, T, H/n, D]`` so each rank runs
full-sequence attention for its heads, and a second all-to-all restores the
sequence sharding. ``lax.all_to_all`` is differentiable; here each
all-to-all is an autograd Function whose backward is the inverse
all-to-all, on ``all_to_all_single`` over the axis's group.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .mesh import Axis
from .ring import local_attention


def _all_to_all(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x [n, ...]``: slice j goes to the rank at index j on ``axis``;
    slice j of the result came from it."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=axis.group)
    return out


def _seq_to_heads(x, axis: Axis):
    B, t, H, D = x.shape
    n = axis.size
    parts = x.reshape(B, t, n, H // n, D).permute(2, 0, 1, 3, 4)
    got = _all_to_all(parts, axis)  # [n: sequence shard, B, t, H/n, D]
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * t, H // n, D)


def _heads_to_seq(x, axis: Axis):
    B, T, h, D = x.shape
    n = axis.size
    parts = x.reshape(B, n, T // n, h, D).permute(1, 0, 2, 3, 4)
    got = _all_to_all(parts, axis)  # [n: head group, B, T/n, h, D]
    return got.permute(1, 2, 0, 3, 4).reshape(B, T // n, n * h, D)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: Axis):
        ctx.axis = axis
        return _seq_to_heads(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.axis), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: Axis):
        ctx.axis = axis
        return _heads_to_seq(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.axis), None


def seq_to_heads(x, axis: Axis):
    """``[B, T_local, H, D] -> [B, T_global, H_local, D]`` via one
    all-to-all."""
    H, n = x.shape[2], axis.size
    if H % n:
        raise ValueError(f"head count {H} not divisible by sp axis size {n}")
    return _SeqToHeads.apply(x, axis)


def heads_to_seq(x, axis: Axis):
    """``[B, T_global, H_local, D] -> [B, T_local, H, D]`` (the inverse)."""
    return _HeadsToSeq.apply(x, axis)


def ulysses_attention(q, k, v, axis: Axis, *, causal: bool = True,
                      scale: Optional[float] = None,
                      attn_fn: Optional[Callable] = None):
    """Sequence-parallel attention by head scatter over the mesh axis
    ``axis``. q, k, v ``[B, T_local, H, D]``; returns the same shape.
    ``attn_fn(q, k, v, causal=..., scale=...)`` defaults to the exact
    full-sequence attention, :func:`~.ring.local_attention`."""
    attn = attn_fn or local_attention
    qh = seq_to_heads(q, axis)
    kh = seq_to_heads(k, axis)
    vh = seq_to_heads(v, axis)
    oh = attn(qh, kh, vh, causal=causal, scale=scale)
    return heads_to_seq(oh, axis)
