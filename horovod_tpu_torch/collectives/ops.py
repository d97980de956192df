"""Collective primitives over ``torch.distributed`` — the data plane.

Counterpart of ``horovod_tpu/collectives/ops.py``. The JAX package lowers
every op to an XLA collective inside the compiled graph; the port issues
NCCL (CUDA tensors) or gloo (CPU tensors) collectives eagerly, one process
per rank, as the original Horovod did. Each process calls an op on its own
tensor, so this module is also the counterpart of
``horovod_tpu/collectives/eager.py``: the JAX package's stacked ``[size,
...]`` per-rank view exists for a single controller, and a world of one
process per GPU has no use for it.

Fusion: ``grouped_allreduce`` and ``DistributedOptimizer`` pack tensors into
flat per-wire-dtype buckets of at most ``HOROVOD_FUSION_THRESHOLD`` bytes,
walking the tensors in REVERSE order (:func:`plan_buckets`, the reference's
``_fused_reduce`` packing), so the last layer's gradients — the first that
backward produces — fill the first bucket. One all-reduce per bucket.

Hierarchical all-reduce (``HOROVOD_HIERARCHICAL_ALLREDUCE``, or
:func:`hierarchical_override`): a Sum or Average over the global set takes
three stages over the context's two-level layout (``core/context_api.py``)
— reduce-scatter within the node, all-reduce across the nodes, all-gather
within the node — the reference's NCCL hierarchical path. Min, Max and
Product, and process sets, stay flat. On the card the three stages are
chained on a side stream (:func:`hierarchical_allreduce_async_`), so the
gradient hooks of ``DistributedOptimizer`` launch all of them while backward
goes on.

Process sets: torch groups of exactly the members take the place of the JAX
package's padded ``axis_index_groups``, so a ragged set such as 3 of 4
needs nothing special. Ranks outside a set take no part in its collectives;
if they call one, they get their input back. Argument errors (dim 0 not
divisible by the member count, a root outside the set, an op a collective
does not take) are raised on every rank, members or not, before anything is
sent.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, List, Optional, Sequence

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


def _is_global(process_set: Optional[ProcessSet]) -> bool:
    """The explicit global set (id 0) is equivalent to passing None."""
    return process_set is None or process_set.process_set_id == 0


def _group(process_set: Optional[ProcessSet]):
    return _ctx.context().process_sets.group(process_set)


def _set_size(process_set: Optional[ProcessSet]) -> int:
    if _is_global(process_set):
        return _ctx.size()
    return process_set.size()


def _member(process_set: Optional[ProcessSet]) -> bool:
    return _is_global(process_set) or _ctx.rank() in process_set.ranks


_fusion_override = threading.local()


@contextlib.contextmanager
def fusion_threshold_override(bytes_: Optional[int]):
    """Thread-locally scope the fusion threshold (bytes) to the bucket plans
    made inside this context — the autotuner's trial value reaches the
    ``DistributedOptimizer`` it re-plans and nothing else, and nothing leaks
    if the loop ends before convergence. None follows the config."""
    prev = getattr(_fusion_override, "value", None)
    _fusion_override.value = bytes_
    try:
        yield
    finally:
        _fusion_override.value = prev


def _fusion_threshold() -> Optional[int]:
    """Fusion threshold (``HOROVOD_FUSION_THRESHOLD``, bytes) of the
    initialised context: ``0`` disables fusion (one collective per tensor), a
    positive value caps each bucket, None (no context, or a negative value)
    means one uncapped bucket per dtype. An active
    :func:`fusion_threshold_override` wins over the config."""
    ov = getattr(_fusion_override, "value", None)
    if ov is not None:
        return int(ov)
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


# --- Hierarchical all-reduce -------------------------------------------------

_hier_override: Optional[bool] = None


@contextlib.contextmanager
def hierarchical_override(value: Optional[bool]):
    """Force ``HOROVOD_HIERARCHICAL_ALLREDUCE`` on or off inside this
    context (None: follow the config). Process-wide, unlike the JAX
    package's thread-local override: ``DistributedOptimizer`` launches its
    all-reduces from gradient hooks, which run on autograd's threads."""
    global _hier_override
    prev = _hier_override
    _hier_override = value
    try:
        yield
    finally:
        _hier_override = prev


def _hierarchical(process_set: Optional[ProcessSet], op: str) -> bool:
    """Whether an all-reduce takes the hierarchical path: Sum or Average,
    the global set, a world of more than one rank with a two-level layout,
    and the flag or the override on."""
    if op not in (Sum, Average) or not _is_global(process_set):
        return False
    ctx = _ctx.context()
    if ctx.size == 1 or not ctx.two_level:
        return False
    if _hier_override is not None:
        return bool(_hier_override)
    return bool(ctx.config.hierarchical_allreduce)


def _cross_compressor() -> Optional[Compressor]:
    """The config-engaged cross-node compressor
    (``HOROVOD_HIERARCHICAL_COMPRESSION``: none | bf16 | fp16), or None."""
    name = _ctx.context().config.hierarchical_compression
    return {"bf16": Compression.bf16, "fp16": Compression.fp16}.get(name)


#: The stages of the hierarchical all-reduce, in launch order.
HIER_STAGES = ("intra_reduce_scatter", "cross_allreduce", "intra_allgather")

_side_streams: dict = {}  # CUDA device -> the stream the stages chain on


class _ChainHandle:
    """A hierarchical all-reduce whose stages are chained on a side stream
    (CUDA) or done (CPU). :meth:`wait` makes the current stream wait for
    the chain and returns the reduced buffer."""

    def __init__(self, out: torch.Tensor, stream, keep):
        self._out, self._stream, self._keep = out, stream, keep

    def wait(self) -> torch.Tensor:
        if self._stream is not None:
            cur = torch.cuda.current_stream(self._out.device)
            cur.wait_stream(self._stream)
            # Allocated on the side stream, read on this one from now on.
            self._out.record_stream(cur)
        self._keep = None
        return self._out


def hierarchical_allreduce_async_(buf: torch.Tensor, op: str = Average, *,
                                  cross_compression: Optional[Compressor]
                                  = None, prescale_factor: float = 1.0,
                                  postscale_factor: float = 1.0
                                  ) -> _ChainHandle:
    """Start the hierarchical Sum or Average of the flat buffer ``buf``
    (handed over until :meth:`wait`) across every rank; the reference's
    ``_hier_reduce_flat``: pre-scale; pad to a multiple of the intra size;
    reduce-scatter (sum) within the node; all-reduce across the nodes, with
    only that hop's payload cast by ``cross_compression``; divide by the
    world size for Average and post-scale, on the shard; all-gather within
    the node; slice the padding off. The result is a new tensor.

    ``cross_compression`` None takes ``HOROVOD_HIERARCHICAL_COMPRESSION``;
    ``Compression.none`` turns it off.

    On the card the three stages are queued on a side stream that first
    waits for the current one, each stage's ``work.wait()`` making the side
    stream, not the caller's, wait. Called from a gradient hook, the whole
    chain then runs while backward goes on; launching only the first stage
    in the hook and the rest in :meth:`wait` would leave two of three
    stages after backward."""
    if op not in (Sum, Average):
        raise ValueError("hierarchical allreduce supports Sum and Average; "
                         f"got {op!r}")
    if cross_compression is None:
        cross_compression = _cross_compressor()
    elif cross_compression is Compression.none:
        cross_compression = None
    ctx = _ctx.context()
    intra, node, cross, _ = ctx.layout_groups()
    stream = None
    if buf.is_cuda:
        stream = _side_streams.get(buf.device)
        if stream is None:
            stream = _side_streams[buf.device] = torch.cuda.Stream(buf.device)
        stream.wait_stream(torch.cuda.current_stream(buf.device))
    launches = hierarchical_allreduce_async_.launches
    with torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext():
        if prescale_factor != 1.0:
            buf.mul_(prescale_factor)
        flat = buf.reshape(-1)
        sz = flat.numel()
        pad = (-sz) % len(node)
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        shard = flat.new_empty(flat.numel() // len(node))
        dist.reduce_scatter_tensor(shard, flat, group=intra,
                                   async_op=True).wait()
        launches["intra_reduce_scatter"] += 1
        wire, cctx = (cross_compression.compress(shard)
                      if cross_compression is not None else (shard, None))
        dist.all_reduce(wire, group=cross, async_op=True).wait()
        launches["cross_allreduce"] += 1
        red = (cross_compression.decompress(wire, cctx)
               if cross_compression is not None else wire)
        if op == Average:
            red = red / ctx.size
        if postscale_factor != 1.0:
            red = red * postscale_factor
        full = red.new_empty(flat.numel())
        dist.all_gather_into_tensor(full, red, group=intra,
                                    async_op=True).wait()
        launches["intra_allgather"] += 1
    return _ChainHandle((full[:sz] if pad else full).view(buf.shape), stream,
                        (buf, flat, shard, wire, red))


#: Stages handed to ``torch.distributed`` by the hierarchical all-reduce,
#: by stage (:data:`HIER_STAGES`). Plain counts; reset by assignment.
hierarchical_allreduce_async_.launches = dict.fromkeys(HIER_STAGES, 0)


def allreduce_async_(buf: torch.Tensor, op: str = Average, *,
                     process_set: Optional[ProcessSet] = None,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0):
    """Start an all-reduce of ``buf`` IN PLACE (the caller hands the buffer
    over until :meth:`Handle.wait`). Scale factors apply in ``buf``'s dtype,
    as the reference applies them to the wire tensor. Where the
    hierarchical path engages (module doc) this is
    :func:`hierarchical_allreduce_async_`, whose result is a new tensor."""
    if op not in _DIST_OP:
        raise ValueError(f"unsupported reduce op: {op}")
    if _hierarchical(process_set, op):
        return hierarchical_allreduce_async_(
            buf, op, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor)
    if prescale_factor != 1.0:
        buf.mul_(prescale_factor)
    work = dist.all_reduce(buf, _DIST_OP[op], group=_group(process_set),
                           async_op=True)
    allreduce_async_.launches += 1
    return Handle(buf, work, op, _set_size(process_set), postscale_factor)


#: Flat all-reduces handed to ``torch.distributed`` — every flat all-reduce
#: of this module goes through :func:`allreduce_async_`. A plain count;
#: reset it by assignment.
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
                  launch: Callable, max_bucket_bytes: Optional[int]
                  ) -> List[torch.Tensor]:
    """The fusion buffer: compress each tensor, pack the wire tensors into
    buckets (:func:`plan_buckets`), ``launch`` each flat bucket (it returns
    a handle), then split and decompress. Returns new tensors; the inputs
    are left untouched."""
    compressed = [compression.compress(t) for t in tensors]
    buckets = plan_buckets(
        [(w.numel() * w.element_size(), w.dtype) for w, _ in compressed],
        max_bucket_bytes)
    flats = [torch.cat([compressed[i][0].reshape(-1) for i in idxs])
             for idxs in buckets]
    handles = [launch(f) for f in flats]
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
    launch = functools.partial(allreduce_async_, op=op,
                               process_set=process_set,
                               prescale_factor=prescale_factor,
                               postscale_factor=postscale_factor)
    return _fused_reduce(list(tensors), compression, launch,
                         _fusion_threshold())


def hierarchical_allreduce(tensor, op: str = Average, *,
                           compression: Compressor = Compression.none,
                           cross_compression: Optional[Compressor] = None,
                           prescale_factor: float = 1.0,
                           postscale_factor: float = 1.0):
    """The two-level all-reduce whatever the config says (parity:
    ``hvd.hierarchical_allreduce``), over every rank: one tensor, or a list
    of tensors packed into the fusion buckets. The layout groups stand in
    for the JAX function's ``intra_axis`` and ``cross_axes``.
    ``cross_compression`` as in :func:`hierarchical_allreduce_async_`."""
    if op not in (Sum, Average):
        raise ValueError("hierarchical allreduce supports Sum and Average; "
                         f"got {op!r}")
    launch = functools.partial(hierarchical_allreduce_async_, op=op,
                               cross_compression=cross_compression,
                               prescale_factor=prescale_factor,
                               postscale_factor=postscale_factor)
    single = isinstance(tensor, torch.Tensor)
    out = _fused_reduce([tensor] if single else list(tensor), compression,
                        launch, _fusion_threshold())
    return out[0] if single else out


# --- Broadcast ---------------------------------------------------------------

def broadcast_(tensor: torch.Tensor, root_rank: int = 0, *,
               process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Broadcast ``tensor`` in place from ``root_rank`` (parity:
    ``hvd.broadcast_``). A CPU tensor in an NCCL world goes over gloo.
    Ranks outside ``process_set`` keep their value."""
    ctx = _ctx.context()
    if not 0 <= root_rank < ctx.size:
        raise ValueError(f"root rank {root_rank} out of range for world "
                         f"size {ctx.size}")
    if not _is_global(process_set) and root_rank not in process_set.ranks:
        raise ValueError(
            f"root rank {root_rank} not in process set {process_set.ranks}")
    if not _member(process_set):
        return tensor
    group = _group(process_set)
    if tensor.device.type == "cpu" and ctx.device.type == "cuda":
        group = _cpu_group(process_set)
    dist.broadcast(tensor, root_rank, group=group)
    return tensor


def broadcast(tensor: torch.Tensor, root_rank: int = 0, *,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Out-of-place :func:`broadcast_` (parity: ``hvd.broadcast``)."""
    return broadcast_(tensor.clone(), root_rank, process_set=process_set)


def grouped_broadcast(tensors: Sequence[torch.Tensor], root_rank: int = 0, *,
                      process_set: Optional[ProcessSet] = None
                      ) -> List[torch.Tensor]:
    """:func:`broadcast` of each tensor (parity: ``hvd.grouped_broadcast``)."""
    return [broadcast(t, root_rank, process_set=process_set)
            for t in tensors]


# --- Shape-changing collectives ----------------------------------------------

def _gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def allgather(tensor: torch.Tensor, *,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Gather dim 0 from every member, concatenated in rank order (parity:
    ``hvd.allgather``). Every member passes the same shape; for first dims
    that differ use :func:`~horovod_tpu_torch.collectives.dynamic.
    allgather_v`.

    ``HOROVOD_HIERARCHICAL_ALLGATHER`` over the global set gathers within
    the node first, then across the nodes: the same rows in the same order
    (node-major ranks make the staged order the rank order)."""
    ctx = _ctx.context()
    if (_is_global(process_set) and ctx.size == 1) \
            or not _member(process_set):
        return tensor
    if (_is_global(process_set) and ctx.config.hierarchical_allgather
            and ctx.two_level):
        intra, node, cross, peers = ctx.layout_groups()
        return _gather(_gather(tensor, intra, len(node)), cross, len(peers))
    return _gather(tensor, _group(process_set), _set_size(process_set))


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])


def sparse_allreduce(tensor: torch.Tensor, op: str = Average, *,
                     process_set: Optional[ProcessSet] = None
                     ) -> torch.Tensor:
    """All-reduce a sparse COO tensor as the reference does
    (``horovod_tpu/torch/mpi_ops.py::sparse_allreduce_async``, upstream
    Horovod's gather-based scheme): all-gather every member's indices and
    values, then coalesce, whose sum over duplicate coordinates is the
    reduction. Sum or Average (the values divided by the member count
    first). Members may hold different numbers of entries: their counts are
    all-gathered first (a wait for the card), and each side is padded to
    the largest, as :func:`~horovod_tpu_torch.collectives.dynamic.
    allgather_v` pads. Returns a new coalesced tensor; the input is left
    untouched. A rank outside ``process_set`` gets its input back,
    coalesced. ``sparse_allreduce.launches`` counts the all-gathers handed
    to ``torch.distributed``."""
    if op not in (Sum, Average):
        raise ValueError(f"sparse allreduce supports Sum and Average, got "
                         f"{op}")
    if not tensor.is_sparse:
        raise ValueError("sparse_allreduce needs a sparse COO tensor")
    t = tensor.coalesce()
    n = _set_size(process_set)
    if not _member(process_set):
        return t
    idx = t.indices().t().contiguous()  # [nnz, sparse_dim]
    vals = t.values() / n if op == Average else t.values()
    if n > 1:
        from .dynamic import compact_gathered
        sizes = allgather(torch.tensor([idx.shape[0]], device=idx.device),
                          process_set=process_set)
        most = int(sizes.max())
        idx = compact_gathered(allgather(_pad_rows(idx, most),
                                         process_set=process_set), sizes)
        vals = compact_gathered(allgather(_pad_rows(vals, most),
                                          process_set=process_set), sizes)
        sparse_allreduce.launches += 3
    return torch.sparse_coo_tensor(idx.t(), vals, t.shape).coalesce()


sparse_allreduce.launches = 0


def grouped_allgather(tensors: Sequence[torch.Tensor], *,
                      process_set: Optional[ProcessSet] = None
                      ) -> List[torch.Tensor]:
    """:func:`allgather` of each tensor (parity: ``hvd.grouped_allgather``)."""
    return [allgather(t, process_set=process_set) for t in tensors]


def alltoall(tensor: torch.Tensor, splits=None, *,
             process_set: Optional[ProcessSet] = None):
    """All-to-all exchange (parity: ``hvd.alltoall``): dim 0 is cut into one
    equal chunk per member, chunk *i* goes to the *i*-th member, and the
    result is the received chunks in member order. With ``splits`` it is
    :func:`~horovod_tpu_torch.collectives.dynamic.alltoall_v`, which returns
    ``(received, recv_splits)``."""
    if splits is not None:
        from .dynamic import alltoall_v
        return alltoall_v(tensor, splits, process_set=process_set)
    if _is_global(process_set) and _ctx.size() == 1:
        return tensor
    n = _set_size(process_set)
    if tensor.shape[0] % n:
        raise ValueError(
            f"alltoall dim0 ({tensor.shape[0]}) must be divisible by the "
            f"participant count ({n}); pass explicit splits for uneven "
            "exchange")
    if not _member(process_set):
        return tensor
    out = torch.empty_like(tensor, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, tensor.contiguous(),
                           group=_group(process_set))
    return out


def reducescatter(tensor: torch.Tensor, op: str = Sum, *,
                  process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Reduce across the members, then scatter dim-0 chunks: the *i*-th
    member keeps chunk *i* (parity: ``hvd.reducescatter``; the ZeRO
    building block). Sum or Average."""
    if op not in (Sum, Average):
        raise ValueError("reducescatter supports Sum and Average")
    if _is_global(process_set) and _ctx.size() == 1:
        return tensor
    n = _set_size(process_set)
    if tensor.shape[0] % n:
        raise ValueError(
            f"reducescatter dim0 ({tensor.shape[0]}) must be divisible by {n}")
    if not _member(process_set):
        return tensor
    out = tensor.new_empty((tensor.shape[0] // n,) + tuple(tensor.shape[1:]))
    dist.reduce_scatter_tensor(out, tensor.contiguous(),
                               group=_group(process_set))
    return out / n if op == Average else out


def grouped_reducescatter(tensors: Sequence[torch.Tensor], op: str = Sum, *,
                          process_set: Optional[ProcessSet] = None
                          ) -> List[torch.Tensor]:
    """:func:`reducescatter` of each tensor (parity:
    ``hvd.grouped_reducescatter``)."""
    return [reducescatter(t, op, process_set=process_set) for t in tensors]


def _cpu_group(process_set: Optional[ProcessSet]):
    """A gloo group over the same ranks, for CPU tensors and objects in an
    NCCL world (optimizer step counters). Made once per set and context;
    collective like every ``new_group``."""
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
