"""Adasum: scale-invariant gradient combination as a butterfly of pair swaps.

Counterpart of ``horovod_tpu/collectives/adasum.py``. The reference combines
gradient pairs with the projection formula

    g = (1 - g1·g2 / (2·‖g1‖²)) · g1  +  (1 - g1·g2 / (2·‖g2‖²)) · g2

over a log₂(n) butterfly: at level *d* every member exchanges its whole
working vector with the member at position ``pos XOR d`` and both apply the
(symmetric) combine, so all members end with the same vector. The JAX
package swaps with ``lax.ppermute`` inside the compiled graph; here each
level is one ``torch.distributed.batch_isend_irecv`` pair between two
processes: NCCL for CUDA tensors, gloo for CPU tensors, one code path.

All tensors of a call are concatenated into ONE flat working vector in the
accumulate dtype (f32, or f64 under ``HOROVOD_ADASUM_ACCUMULATE_FP64``), so a
call gets one ``(ca, cb)`` pair per level over all of them. Large f32
working vectors on the card take the fused kernels of ``ops/fused.py`` (B4
and B5), everything else the plain combine.

:func:`hierarchical_adasum` is the reference's GPU Adasum shape over the
context's two-level layout: a sum within the node, the butterfly across the
nodes, a gather within the node. Nothing calls it implicitly:
``op=Adasum`` stays on the flat butterfly, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..core import context_api as _ctx
from ..core.process_sets import ProcessSet
from ..ops.fused import adasum_coefficients
from .compression import Compression, Compressor

#: Working vectors of at least this many f32 elements on the card take the
#: fused kernels (the JAX package's Pallas dispatch threshold).
_FUSED_COMBINE_MIN_SIZE = 1 << 16


def _combine(a: torch.Tensor, b: torch.Tensor, eps: float = 0.0
             ) -> torch.Tensor:
    """The Adasum pairwise operator in the operands' dtype; symmetric, so
    both partners compute the identical result. Zero-norm inputs degrade to
    plain sum."""
    a, b = a.reshape(-1), b.reshape(-1)
    dot = torch.dot(a, b)
    na = torch.dot(a, a)
    nb = torch.dot(b, b)
    ca, cb = adasum_coefficients(dot, na, nb, eps)
    return ca * a + cb * b


def _uses_fused(t) -> bool:
    """Whether :func:`_combine_dispatch` sends ``t`` to the fused kernels:
    an f32 CUDA tensor of at least ``_FUSED_COMBINE_MIN_SIZE`` elements."""
    return (t.device.type == "cuda" and t.dtype == torch.float32
            and t.numel() >= _FUSED_COMBINE_MIN_SIZE)


def _combine_dispatch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The fused combine (B4 then B5, written into ``a`` in place) for large
    f32 working vectors on the card; the plain :func:`_combine` for CPU
    tensors, small ones and the f64 accumulate option, whose extra
    precision the f32 kernels would defeat."""
    if _uses_fused(a):
        from ..ops.fused import fused_combine
        return fused_combine(a, b, out=a)
    return _combine(a, b)


def _butterfly(x: torch.Tensor, ranks: Sequence[int], group=None,
               compression: Compressor = Compression.none) -> torch.Tensor:
    """log₂(n) XOR-partner exchange and combine of this rank's working
    vector ``x`` over ``ranks`` (global ranks, this rank among them, a
    power of 2 of them).

    The wire carries ``compression.compress(x)``; the working copy stays in
    the accumulate dtype. ``x`` is the caller's to give up: the fused
    combine overwrites it."""
    n = len(ranks)
    pos = list(ranks).index(dist.get_rank())
    d = 1
    while d < n:
        peer = ranks[pos ^ d]
        send, cctx = compression.compress(x)
        recv = torch.empty_like(send)
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, peer, group),
                dist.P2POp(dist.irecv, recv, peer, group)]):
            work.wait()
        x = _combine_dispatch(x, compression.decompress(recv, cctx)
                              .to(x.dtype))
        d *= 2
    return x


Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def adasum_allreduce(tensor: Tensors, *,
                     process_set: Optional[ProcessSet] = None,
                     compression: Compressor = Compression.none,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0) -> Tensors:
    """``hvd.allreduce(op=hvd.Adasum)``: Adasum of one tensor, or of a list
    of tensors as one flat vector, across the ranks of ``process_set``.

    The working vector is f32, or f64 under
    ``HOROVOD_ADASUM_ACCUMULATE_FP64``. Returns the same structure with each
    tensor's shape and dtype. In a world of one the result is the input,
    scaled by ``prescale_factor * postscale_factor`` (the input itself when
    that is 1). The set's size must be a power of 2, on every rank. Ranks
    outside a process set do not take part, as with ``torch.distributed``
    groups; if they call, they get their input back."""
    leaves: List[torch.Tensor] = ([tensor] if isinstance(tensor, torch.Tensor)
                                  else list(tensor))

    def rebuild(out):
        return out[0] if isinstance(tensor, torch.Tensor) else out

    ctx = _ctx.context()
    glob = process_set is None or process_set.process_set_id == 0
    if glob and ctx.size == 1:
        f = prescale_factor * postscale_factor
        return rebuild([x if f == 1.0 else (x * f).to(x.dtype)
                        for x in leaves])
    ranks = tuple(range(ctx.size)) if glob else tuple(process_set.ranks)
    if len(ranks) & (len(ranks) - 1):
        raise ValueError(
            f"Adasum butterfly needs a power-of-2 participant count, got "
            f"{len(ranks)} (the reference's recursive-halving tree has the "
            "same shape constraint); use hierarchical_adasum over a layout "
            "with a power-of-2 node count, or pad the process set")
    if ctx.rank not in ranks or not leaves:
        return tensor
    acc = (torch.float64 if ctx.config.adasum_accumulate_dtype == "float64"
           else torch.float32)
    x = torch.cat([t.reshape(-1).to(acc) for t in leaves])
    if prescale_factor != 1.0:
        x.mul_(prescale_factor)
    x = _butterfly(x, ranks, ctx.process_sets.group(process_set),
                   compression)
    if postscale_factor != 1.0:
        x.mul_(postscale_factor)
    out, off = [], 0
    for t in leaves:
        out.append(x[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return rebuild(out)


def hierarchical_adasum(tensor: Tensors, *,
                        accumulate_dtype: torch.dtype = torch.float32
                        ) -> Tensors:
    """The reference's GPU Adasum over the context's two-level layout
    (parity: ``hvd.hierarchical_adasum``; the layout groups stand in for
    the JAX function's ``intra_axis`` and ``cross_axis``): for each tensor,
    its flat ``accumulate_dtype`` copy padded to a multiple of the intra
    size, reduce-scattered (summed) within the node, combined by the Adasum
    butterfly across the nodes (B4 and B5 once a level on large f32 shards
    on the card; the coefficients are the shard's, as in the JAX
    function), and all-gathered within the node. Every rank takes part;
    the node count must be a power of 2. Returns each tensor's shape and
    dtype, the same structure as ``tensor``."""
    leaves: List[torch.Tensor] = ([tensor] if isinstance(tensor, torch.Tensor)
                                  else list(tensor))
    ctx = _ctx.context()
    intra, node, cross, peers = ctx.layout_groups()
    if len(peers) & (len(peers) - 1):
        raise ValueError(f"hierarchical Adasum needs a power-of-2 node "
                         f"count, got {len(peers)}")
    out = []
    for x in leaves:
        flat = x.reshape(-1).to(accumulate_dtype)
        sz = flat.numel()
        pad = (-sz) % len(node)
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        shard = flat.new_empty(flat.numel() // len(node))
        dist.reduce_scatter_tensor(shard, flat.contiguous(), group=intra)
        del flat
        shard = _butterfly(shard, peers, cross)
        full = shard.new_empty(shard.numel() * len(node))
        dist.all_gather_into_tensor(full, shard, group=intra)
        out.append(full[:sz].view(x.shape).to(x.dtype))
    return out[0] if isinstance(tensor, torch.Tensor) else out
