"""Collective primitives over ``torch.distributed`` — the data plane.

Counterpart of ``horovod_tpu/collectives/ops.py``. The JAX package lowers
every op to an XLA collective inside the compiled graph; the port issues
NCCL (CUDA tensors) or gloo (CPU tensors) collectives eagerly, one process
per rank, as the original Horovod did.

Fusion: ``grouped_allreduce`` and ``DistributedOptimizer`` pack tensors into
flat per-wire-dtype buckets of at most ``HOROVOD_FUSION_THRESHOLD`` bytes,
walking the tensors in REVERSE order (:func:`plan_buckets`, the reference's
``_fused_reduce`` packing), so the last layer's gradients — the first that
backward produces — fill the first bucket. One all-reduce per bucket.

This module ports ``allreduce``, ``grouped_allreduce``, ``broadcast`` and
``barrier``; ``op=Adasum`` routes to the butterfly of ``adasum.py``. The
other collectives come with a later slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core import context_api as _ctx
from ..core.process_sets import ProcessSet
from .compression import Compression, Compressor

# --- Reduce-op constants, parity with hvd.Sum/Average/Min/Max/Product
Sum = "sum"
Average = "average"
Min = "min"
Max = "max"
Product = "product"
Adasum = "adasum"

_DIST_OP = {
    Sum: dist.ReduceOp.SUM,
    Average: dist.ReduceOp.SUM,  # summed, then divided: gloo has no AVG
    Min: dist.ReduceOp.MIN,
    Max: dist.ReduceOp.MAX,
    Product: dist.ReduceOp.PRODUCT,
}


def _group(process_set: Optional[ProcessSet]):
    return _ctx.context().process_sets.group(process_set)


def _set_size(process_set: Optional[ProcessSet]) -> int:
    if process_set is None or process_set.process_set_id == 0:
        return _ctx.size()
    return process_set.size()


def _fusion_threshold() -> Optional[int]:
    """Fusion threshold (``HOROVOD_FUSION_THRESHOLD``, bytes) of the
    initialised context: ``0`` disables fusion (one collective per tensor), a
    positive value caps each bucket, None (no context, or a negative value)
    means one uncapped bucket per dtype."""
    if not _ctx.is_initialized():
        return None
    t = _ctx.context().config.fusion_threshold_bytes
    return int(t) if t is not None and t >= 0 else None


def plan_buckets(sizes: Sequence[tuple], max_bucket_bytes: Optional[int]
                 ) -> List[List[int]]:
    """Pack tensors into all-reduce buckets; ``sizes`` is one ``(nbytes,
    wire dtype)`` per tensor, in flatten order. Returns the buckets as lists
    of tensor indices, in launch order.

    The packing of the reference's ``_fused_reduce``: ``0`` gives one bucket
    per tensor; a positive cap packs greedily per dtype walking the tensors
    IN REVERSE (backward produces the last layer's gradients first), and a
    tensor larger than the cap goes alone, unsplit; ``None`` gives one bucket
    per dtype."""
    n = len(sizes)
    if max_bucket_bytes == 0:
        return [[i] for i in range(n)]
    if not max_bucket_bytes:
        per_dtype: dict = {}
        for i, (_, dtype) in enumerate(sizes):
            per_dtype.setdefault(dtype, []).append(i)
        return list(per_dtype.values())
    cap = int(max_bucket_bytes)
    buckets: List[List[int]] = []
    open_bucket: dict = {}  # dtype -> (bucket position, bytes packed)
    for i in reversed(range(n)):
        nbytes, dtype = sizes[i]
        cur = open_bucket.get(dtype)
        if cur is not None and cur[1] + nbytes <= cap:
            buckets[cur[0]].append(i)
            open_bucket[dtype] = (cur[0], cur[1] + nbytes)
        else:
            buckets.append([i])
            open_bucket[dtype] = (len(buckets) - 1, nbytes)
    return buckets


class Handle:
    """An all-reduce in flight. :meth:`wait` blocks on it and returns the
    reduced buffer, averaged and post-scaled, still in the wire dtype."""

    def __init__(self, buf: torch.Tensor, work, op: str, n: int,
                 postscale_factor: float):
        self._buf, self._work = buf, work
        self._op, self._n, self._post = op, n, postscale_factor

    def wait(self) -> torch.Tensor:
        self._work.wait()
        y = self._buf
        if self._op == Average:
            y = y.div_(self._n) if y.is_floating_point() else y / self._n
        if self._post != 1.0:
            y = y.mul_(self._post)
        return y


def allreduce_async_(buf: torch.Tensor, op: str = Average, *,
                     process_set: Optional[ProcessSet] = None,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0) -> Handle:
    """Start an all-reduce of ``buf`` IN PLACE (the caller hands the buffer
    over until :meth:`Handle.wait`). Scale factors apply in ``buf``'s dtype,
    as the reference applies them to the wire tensor."""
    if op not in _DIST_OP:
        raise ValueError(f"unsupported reduce op: {op}")
    if prescale_factor != 1.0:
        buf.mul_(prescale_factor)
    work = dist.all_reduce(buf, _DIST_OP[op], group=_group(process_set),
                           async_op=True)
    allreduce_async_.launches += 1
    return Handle(buf, work, op, _set_size(process_set), postscale_factor)


#: All-reduces handed to ``torch.distributed`` — every all-reduce of this
#: module goes through :func:`allreduce_async_`. A plain count; reset it by
#: assignment.
allreduce_async_.launches = 0


def allreduce(tensor: torch.Tensor, op: str = Average, *,
              process_set: Optional[ProcessSet] = None,
              compression: Compressor = Compression.none,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """All-reduce one tensor across the ranks of ``process_set`` (parity:
    ``hvd.allreduce``). The input is left untouched. ``op=Adasum`` routes to
    :func:`~horovod_tpu_torch.collectives.adasum.adasum_allreduce`."""
    if op == Adasum:
        from .adasum import adasum_allreduce
        return adasum_allreduce(tensor, process_set=process_set,
                                compression=compression,
                                prescale_factor=prescale_factor,
                                postscale_factor=postscale_factor)
    wire, cctx = compression.compress(tensor)
    if wire is tensor:
        wire = tensor.clone()
    out = allreduce_async_(wire, op, process_set=process_set,
                           prescale_factor=prescale_factor,
                           postscale_factor=postscale_factor).wait()
    return compression.decompress(out, cctx)


def _fused_reduce(tensors: Sequence[torch.Tensor], compression: Compressor,
                  op: str, process_set: Optional[ProcessSet],
                  prescale_factor: float, postscale_factor: float,
                  max_bucket_bytes: Optional[int]) -> List[torch.Tensor]:
    """The fusion buffer: compress each tensor, pack the wire tensors into
    buckets (:func:`plan_buckets`), launch one all-reduce per flat bucket,
    then split and decompress. Returns new tensors; the inputs are left
    untouched."""
    compressed = [compression.compress(t) for t in tensors]
    buckets = plan_buckets(
        [(w.numel() * w.element_size(), w.dtype) for w, _ in compressed],
        max_bucket_bytes)
    flats = [torch.cat([compressed[i][0].reshape(-1) for i in idxs])
             for idxs in buckets]
    handles = [allreduce_async_(f, op, process_set=process_set,
                                prescale_factor=prescale_factor,
                                postscale_factor=postscale_factor)
               for f in flats]
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idxs, handle in zip(buckets, handles):
        red = handle.wait()
        off = 0
        for i in idxs:
            wire, cctx = compressed[i]
            out[i] = compression.decompress(
                red[off:off + wire.numel()].view(wire.shape), cctx)
            off += wire.numel()
    return out


def grouped_allreduce(tensors: Sequence[torch.Tensor], op: str = Average, *,
                      process_set: Optional[ProcessSet] = None,
                      compression: Compressor = Compression.none,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0) -> List[torch.Tensor]:
    """All-reduce a list of tensors through the fusion buckets sized by
    ``HOROVOD_FUSION_THRESHOLD`` (parity: ``hvd.grouped_allreduce``).
    ``op=Adasum`` combines all of them as one flat vector (one coefficient
    pair per butterfly level), as the JAX package does."""
    if op == Adasum:
        from .adasum import adasum_allreduce
        return adasum_allreduce(list(tensors), process_set=process_set,
                                compression=compression,
                                prescale_factor=prescale_factor,
                                postscale_factor=postscale_factor)
    if op not in _DIST_OP:
        raise ValueError(f"unsupported reduce op: {op}")
    return _fused_reduce(list(tensors), compression, op, process_set,
                         prescale_factor, postscale_factor,
                         _fusion_threshold())


def broadcast_(tensor: torch.Tensor, root_rank: int = 0, *,
               process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Broadcast ``tensor`` in place from ``root_rank`` (parity:
    ``hvd.broadcast_``). A CPU tensor in an NCCL world goes over gloo."""
    ctx = _ctx.context()
    if not 0 <= root_rank < ctx.size:
        raise ValueError(f"root rank {root_rank} out of range for world "
                         f"size {ctx.size}")
    if process_set is not None and process_set.process_set_id != 0 \
            and root_rank not in process_set.ranks:
        raise ValueError(
            f"root rank {root_rank} not in process set {process_set.ranks}")
    group = _group(process_set)
    if tensor.device.type == "cpu" and ctx.device.type == "cuda":
        group = _cpu_group(process_set)
    dist.broadcast(tensor, root_rank, group=group)
    return tensor


def broadcast(tensor: torch.Tensor, root_rank: int = 0, *,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Out-of-place :func:`broadcast_` (parity: ``hvd.broadcast``)."""
    return broadcast_(tensor.clone(), root_rank, process_set=process_set)


def _cpu_group(process_set: Optional[ProcessSet]):
    """A gloo group over the same ranks, for CPU tensors in an NCCL world
    (optimizer step counters). Made once per set and context; collective
    like every ``new_group``."""
    ctx = _ctx.context()
    ranks = tuple(process_set.ranks) if process_set is not None \
        else tuple(range(ctx.size))
    if ranks not in ctx.cpu_groups:
        ctx.cpu_groups[ranks] = dist.new_group(list(ranks), backend="gloo")
    return ctx.cpu_groups[ranks]


def barrier(*, process_set: Optional[ProcessSet] = None) -> None:
    """Synchronisation barrier (parity: ``hvd.barrier``): a tiny all-reduce
    on the context's device, like the reference's tiny psum."""
    allreduce(torch.zeros((), device=_ctx.device()), Sum,
              process_set=process_set)
