"""``DistributedOptimizer`` — gradient-averaging optimizer wrapper.

Counterpart of ``horovod_tpu/optimizer/distributed.py`` with the API of
``horovod_tpu/torch/optimizer.py`` (reference ``horovod/torch/optimizer.py``):
it wraps any ``torch.optim.Optimizer``, and a hook on every parameter fires
as backward accumulates its gradient. The gradients are packed into the
fusion buckets of :func:`~horovod_tpu_torch.collectives.ops.plan_buckets`
(per wire dtype, reverse parameter order, capped at
``HOROVOD_FUSION_THRESHOLD``), and the moment a bucket's last gradient is
ready its all-reduce is launched asynchronously — NCCL on the GPU — while
backward goes on. ``step()`` waits for every bucket, writes the reduced
gradients back and applies the wrapped optimizer.

The all-reduces go through ``torch.distributed`` in every initialised world,
a world of one rank included. Under ``HOROVOD_HIERARCHICAL_ALLREDUCE`` each
bucket takes the three-stage hierarchical path instead
(:func:`~horovod_tpu_torch.collectives.ops.allreduce_async_` routes it, as
the JAX optimizer gets it through ``grouped_allreduce``): the hook queues
all three stages on a side stream, so they run during backward as the flat
all-reduce does, and the result, a new tensor, is copied back into the
gradient in ``synchronize()``.

A parameter group may carry a ``replica_set`` (a ``ProcessSet``): the
ranks whose gradients of its parameters are summed, those that hold the
same block and see different tokens (an expert bank over the ``ep`` axis,
``parallel/moe.py``; a block over ``fsdp`` or ``tp``,
``parallel/sharding.py``). The other ranks' contributions reached them
through the model's own exchanges (the expert all-to-all, fsdp's
reduce-scatter), and a tp-replicated gradient is equal on every tp rank
already, so it is not summed over tp. The sum is divided by the group's
``data_shards``, the number of ranks that see different tokens
(``sharding.token_shards``), or by default by the optimizer's rank count:
under tp or pp the world holds more ranks than token shards, and the
world size would shrink every gradient by tp. A bucket never mixes groups. A
group whose parameters do not require a gradient on a step (a bank frozen
by ``train.make_gspmd_deferred_train_step``) is not reduced, and its
``.grad`` stays None.

With ``op=Adasum`` all gradients form ONE bucket: the JAX result has one
``(ca, cb)`` pair per butterfly level over the concatenation of every
gradient, not one per bucket or per tensor. The hooks then only count, and
``synchronize()`` runs :func:`~horovod_tpu_torch.collectives.adasum.
adasum_allreduce` over all gradients once they are ready.
"""

from __future__ import annotations

import weakref
from typing import List, Optional

import torch

from ..collectives import ops as _ops
from ..collectives.adasum import adasum_allreduce
from ..collectives.compression import Compression, Compressor
from ..core import context_api as _ctx
from ..core.config import resolve_fusion_threshold_bytes
from ..core.process_sets import ProcessSet


class _Bucket:
    """Parameters of one group whose gradients ride one all-reduce, and the
    group's replica set (None: the optimizer's ranks)."""

    def __init__(self, params: List[torch.nn.Parameter],
                 replica_set: Optional[ProcessSet] = None,
                 divisor: Optional[int] = None):
        self.params = params
        self.replica_set = replica_set
        self.divisor = divisor  # of the replica-set sum; None: the world
        self.pending = len(params)  # gradients not yet ready this step
        self.inflight = None        # (handle, [(param, wire shape, ctx)])


class _Done:
    """The handle of a reduction over one rank: nothing to wait for."""

    def __init__(self, buf: torch.Tensor):
        self.buf = buf

    def wait(self) -> torch.Tensor:
        return self.buf


def _weak_hook(opt):
    """The gradient hook of ``opt``, holding it weakly. A parameter keeps its
    hooks in the autograd engine, out of the garbage collector's sight, so a
    hook that held the optimizer would keep it, its state and every
    parameter alive for the rest of the process."""
    ref = weakref.ref(opt)

    def hook(p):
        live = ref()
        if live is not None:
            live._hook(p)
    return hook


class _DistributedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, named_parameters, compression: Compressor,
                 backward_passes_per_step: int, op: str,
                 gradient_predivide_factor: float,
                 process_set: Optional[ProcessSet]):
        super(self.__class__, self).__init__(params)
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self._compression = compression
        self._process_set = process_set
        self.backward_passes_per_step = backward_passes_per_step
        if named_parameters is not None:
            names = [k for k, _ in named_parameters]
            if len(set(names)) != len(names):
                dups = sorted({n for n in names if names.count(n) > 1})
                raise ValueError(f"parameter names must be unique; "
                                 f"duplicates: {dups}")
        n = _ops._set_size(process_set)
        k = backward_passes_per_step
        # The reference's split (optimizer/distributed.py): with a predivide
        # factor f the gradients are pre-divided by f * n, summed on the
        # wire, and post-multiplied by f — an average taken in two stages.
        if gradient_predivide_factor != 1.0:
            self._op = _ops.Sum
            self._prescale = 1.0 / (gradient_predivide_factor * n * k)
            self._postscale = gradient_predivide_factor
        else:
            self._op = op
            self._prescale = 1.0 / k
            self._postscale = 1.0
        self._world = n
        ordered = [(i, p) for i, g in enumerate(self.param_groups)
                   for p in g["params"] if p.requires_grad]
        sets = [g.get("replica_set") for g in self.param_groups]
        divisors = [g.get("data_shards") for g in self.param_groups]
        if op == _ops.Adasum:
            if any(s is not None for s in sets):
                raise ValueError("op=Adasum takes no replica_set groups")
            self._buckets = [_Bucket([p for _, p in ordered])]
        else:
            # One bucket never mixes groups: a group may have its own
            # replica set, and a step may freeze a group (no gradient).
            sizes = [(p.numel() * compression.wire_dtype_for(p.dtype)
                      .itemsize, (compression.wire_dtype_for(p.dtype), i))
                     for i, p in ordered]
            plan = _ops.plan_buckets(sizes, resolve_fusion_threshold_bytes())
            self._buckets = [_Bucket([ordered[j][1] for j in idxs],
                                     sets[ordered[idxs[0]][0]],
                                     divisors[ordered[idxs[0]][0]])
                             for idxs in plan]
        ordered = [p for _, p in ordered]
        self._bucket_of = {p: b for b in self._buckets for p in b.params}
        self._passes = {p: 0 for p in ordered}
        for p in ordered:
            p.register_post_accumulate_grad_hook(_weak_hook(self))

    @property
    def buckets(self) -> List[List[torch.nn.Parameter]]:
        """The fusion buckets, in launch order."""
        return [b.params for b in self._buckets]

    def _hook(self, p: torch.nn.Parameter) -> None:
        self._passes[p] += 1
        if self._passes[p] < self.backward_passes_per_step:
            return
        self._passes[p] = 0
        bucket = self._bucket_of[p]
        bucket.pending -= 1
        if bucket.pending == 0 and self._op != _ops.Adasum:
            self._launch(bucket)

    def _launch(self, bucket: _Bucket) -> None:
        wires = [(p, self._compression.compress(p.grad)) for p in bucket.params]
        if len(wires) == 1 and wires[0][1][0] is bucket.params[0].grad:
            # Reduced in place on the flat path; the hierarchical path pads
            # a copy and returns a new tensor.
            buf = bucket.params[0].grad.reshape(-1)
        else:
            buf = torch.cat([w.reshape(-1) for _, (w, _) in wires])
        rs = bucket.replica_set
        if rs is None:
            handle = _ops.allreduce_async_(
                buf, self._op, process_set=self._process_set,
                prescale_factor=self._prescale,
                postscale_factor=self._postscale)
        else:
            # The replica set's sum holds every contribution (module
            # doc); its Average is that sum over the ranks that see
            # different tokens.
            divisor = bucket.divisor or self._world
            pre = self._prescale / (divisor if self._op == _ops.Average
                                    else 1)
            if rs.size() == 1:
                buf.mul_(pre * self._postscale)
                handle = _Done(buf)
            else:
                handle = _ops.allreduce_async_(
                    buf, _ops.Sum, process_set=rs, prescale_factor=pre,
                    postscale_factor=self._postscale)
        bucket.inflight = (handle, [(p, w.shape, c) for p, (w, c) in wires])

    def synchronize(self) -> None:
        """Wait for every bucket's all-reduce and write the reduced gradients
        back. A bucket whose hooks did not all fire (a parameter unused this
        step) is launched here with zero gradients, so every rank issues the
        same collectives."""
        if self._op == _ops.Adasum:
            return self._synchronize_adasum()
        for bucket in self._buckets:
            if bucket.inflight is None and not any(
                    p.requires_grad for p in bucket.params):
                continue  # a group frozen for this step: no gradient
            if bucket.inflight is None:
                for p in bucket.params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                self._launch(bucket)
            handle, parts = bucket.inflight
            red = handle.wait()
            off = 0
            for p, shape, cctx in parts:
                n = shape.numel()
                g = self._compression.decompress(red[off:off + n].view(shape),
                                                  cctx)
                if g.data_ptr() != p.grad.data_ptr():
                    p.grad.copy_(g)
                off += n
            bucket.inflight = None
            bucket.pending = len(bucket.params)

    def _synchronize_adasum(self) -> None:
        """Adasum over every gradient as one flat vector. The ``1/k`` of
        ``backward_passes_per_step = k`` scales each gradient first, as the
        JAX optimizer scales its accumulated gradients before reducing."""
        (bucket,) = self._buckets
        grads = []
        for p in bucket.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if self._prescale != 1.0:
                p.grad.mul_(self._prescale)
            grads.append(p.grad)
        reduced = adasum_allreduce(grads, process_set=self._process_set,
                                   compression=self._compression)
        for p, g in zip(bucket.params, reduced):
            if g.data_ptr() != p.grad.data_ptr():
                p.grad.copy_(g)
        bucket.pending = len(bucket.params)

    def step(self, closure=None):
        self.synchronize()
        return super(self.__class__, self).step(closure)

    def zero_grad(self, set_to_none: bool = True):
        if any(b.inflight is not None
               or (self._op == _ops.Adasum and b.pending == 0)
               for b in self._buckets):
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step() or optimizer.synchronize()")
        return super(self.__class__, self).zero_grad(set_to_none)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression: Compressor = Compression.none,
                         backward_passes_per_step: int = 1,
                         op: str = _ops.Average,
                         gradient_predivide_factor: float = 1.0,
                         process_set: Optional[ProcessSet] = None):
    """Wrap ``optimizer`` so gradients are all-reduced across ranks during
    ``loss.backward()`` (reference ``hvd.DistributedOptimizer``). Needs an
    initialised context. With ``backward_passes_per_step=k`` the gradients of
    k backward passes accumulate locally and are reduced, divided by k, once;
    call ``step()`` after the k-th."""
    _ctx.context()
    if gradient_predivide_factor != 1.0 and op != _ops.Average:
        raise ValueError(
            "gradient_predivide_factor not supported with op != Average")
    if named_parameters is not None:
        named_parameters = list(named_parameters)
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step, op, gradient_predivide_factor,
               process_set)
