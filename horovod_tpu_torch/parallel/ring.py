"""Ring attention: blockwise causal attention over a sequence-parallel axis.

Counterpart of ``horovod_tpu/parallel/ring.py``. The sequence is sharded
over an ``sp`` axis; K/V blocks rotate around the ring while each rank
accumulates flash-attention-style partial results (running max and
denominator) for its local Q block, so no rank ever holds the full
``[T, T]`` scores (Liu et al. 2023, "Ring Attention with Blockwise
Transformers").

Where JAX rotates with ``lax.ppermute``, which is differentiable, a rank
here sends and receives with ``torch.distributed``, which is not: the
rotation is :class:`_Rotate`, whose backward sends the cotangent back the
way the block came. Without it the gradients of K and V from the other
ranks' queries would be lost. Every rank posts the same sends and receives
at every step, forward and backward; in a causal ring each rank takes its
own branch (the blocks of higher ranks are skipped), and a skipped block
still takes part in the graph (:class:`_Skipped`), so that every rank runs
the backward of every rotation.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import NEG_INF, flash_attention, merge_partials
from .mesh import Axis, shift


class _Rotate(torch.autograd.Function):
    """K and V one step round the ring, ``r -> r + 1`` on ``axis``; the
    backward sends their cotangents ``r -> r - 1``."""

    @staticmethod
    def forward(ctx, axis: Axis, k, v):
        ctx.axis = axis
        return tuple(shift(axis, (k, v), 1))

    @staticmethod
    def backward(ctx, dk, dv):
        return (None, *shift(ctx.axis, (dk, dv), -1))


class _Skipped(torch.autograd.Function):
    """The partial of a key block no query of this rank sees: nothing
    (o = 0, m = NEG_INF, l = 0), with zero cotangents for the block, so
    that the rotation that brought it still gets its backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        B, T, H, D = q.shape
        ctx.like = (k.shape, k.dtype, v.shape, v.dtype)
        f32 = dict(dtype=torch.float32, device=q.device)
        return (torch.zeros((B, T, H, D), **f32),
                torch.full((B, H, T), NEG_INF, **f32),
                torch.zeros((B, H, T), **f32))

    @staticmethod
    def backward(ctx, do, dm, dl):
        ks, kt, vs, vt = ctx.like
        return (None, torch.zeros(ks, dtype=kt, device=do.device),
                torch.zeros(vs, dtype=vt, device=do.device))


def _block_attn(q, k, v, o, m, l, q_off, k_off, scale, causal):
    """One blockwise-softmax accumulation step (flash-attention update).

    q ``[B, Tq, H, D]``; k, v ``[B, Tk, H, D]``; o the running output, m the
    running max and l the running denominator, both ``[B, H, Tq]``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        q_pos = q_off + torch.arange(q.shape[1], device=q.device)
        k_pos = k_off + torch.arange(k.shape[1], device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, -torch.inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # Guard fully-masked blocks: exp(-inf - -inf) -> use a safe max.
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isneginf(s), 0.0, p)
    corr = torch.exp(torch.where(torch.isneginf(m), 0.0, m) - m_safe)
    corr = torch.where(torch.isneginf(m), 0.0, corr)
    l_new = l * corr + p.sum(dim=-1)
    o_new = (o * corr.transpose(1, 2)[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", p, v))
    return o_new, m_new, l_new


def ring_attention(q, k, v, axis: Axis, *, causal: bool = True,
                   scale: Optional[float] = None,
                   impl: Optional[str] = None):
    """Blockwise ring attention over the mesh axis ``axis``.

    q, k, v ``[B, T_local, H, D]``: this rank's shard of the sequence
    (global sequence = n x T_local, the rank at index i on ``axis`` holding
    positions ``[i T_local, (i + 1) T_local)``). Returns ``[B, T_local, H,
    D]``.

    ``impl``: ``"kernel"`` computes each shard's partial with B1
    (:func:`~horovod_tpu_torch.ops.flash_attention.flash_attention` with
    its residuals) and folds it in with ``merge_partials``, the JAX
    package's ``"pallas"``; ``"blockwise"`` is the plain torch
    accumulation, JAX's ``"jnp"``. The default is the kernel for CUDA
    tensors and the blockwise path on the CPU, as JAX chooses by backend.
    """
    if impl is None:
        impl = "kernel" if q.is_cuda else "blockwise"
    if impl == "kernel":
        return _ring_attention_kernel(q, k, v, axis, causal=causal,
                                      scale=scale)
    if impl != "blockwise":
        raise ValueError(f"ring attention impl {impl!r}: use 'kernel' or "
                         "'blockwise'")
    n, idx = axis.size, axis.index
    B, Tq, H, D = q.shape
    if scale is None:
        scale = 1.0 / D ** 0.5
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.zeros((B, Tq, H, D), **f32)
    m = torch.full((B, H, Tq), -torch.inf, **f32)
    l = torch.zeros((B, H, Tq), **f32)
    qf = q.float()
    kb, vb = k, v
    for i in range(n):
        if i:
            kb, vb = _Rotate.apply(axis, kb, vb)
        # After i rotations this rank holds the block of rank (idx - i).
        src = (idx - i) % n
        o, m, l = _block_attn(qf, kb.float(), vb.float(), o, m, l,
                              idx * Tq, src * kb.shape[1], scale, causal)
    l = torch.where(l == 0.0, 1.0, l)  # rows with no visible keys stay 0
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def _ring_attention_kernel(q, k, v, axis: Axis, *, causal: bool,
                           scale: Optional[float]):
    """Ring attention where each shard's partial is B1.

    At each step the resident K/V block came from rank ``src``; under
    causal masking only three cases exist, so no position offset ever
    reaches the kernel: src == self is the causal diagonal block, src <
    self is fully visible (B1 not causal), src > self is fully masked and
    skipped, the half of the products a causal ring need not do. B1's
    residual backward is autograd over the plain recompute, as JAX's."""
    n, idx = axis.size, axis.index
    D = q.shape[-1]
    if scale is None:
        scale = float(D) ** -0.5
    acc = None
    kb, vb = k, v
    for i in range(n):
        if i:
            kb, vb = _Rotate.apply(axis, kb, vb)
        src = (idx - i) % n
        if causal and src > idx:
            part = _Skipped.apply(q, kb, vb)
        else:
            o, (m, l) = flash_attention(q, kb, vb,
                                        causal=causal and src == idx,
                                        scale=scale, return_residuals=True)
            part = (o.float(), m, l)
        # Folding the first partial into an empty one gives it back
        # exactly, so the fold starts from it.
        acc = part if acc is None else merge_partials(acc, part)
    return acc[0].to(q.dtype)


def local_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """Single-device attention over the full sequence, the same signature:
    the oracle :func:`ring_attention` is held to, and Ulysses' default
    attention. Materialises the f32 softmax."""
    B, T, H, D = q.shape
    if scale is None:
        scale = 1.0 / D ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
