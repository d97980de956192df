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

A sparse gradient (``F.embedding(..., sparse=True)``, the reference's
``optimizer.py:141-157``) never enters a dense bucket. With
``sparse_as_dense`` the hook densifies it and it rides its bucket.
Otherwise it is reduced by :func:`~horovod_tpu_torch.collectives.ops.
sparse_allreduce` (an all-gather of indices and values, then a coalesce)
in ``synchronize()``, in parameter order, its values divided by
``backward_passes_per_step``. Which parameters give sparse gradients is
learned, not declared: while some parameter has had no gradient on any
rank, ``synchronize()`` first all-gathers each rank's kind of gradient for
those parameters (none, dense, or sparse and its sparse dims; the
reference's ``_exchange_sparse_param_meta``). A parameter found sparse
leaves its bucket on every rank, and a rank where it got no gradient
takes part in its all-gathers with an empty one, so no rank waits
forever. Once every parameter has had a gradient somewhere, no step
exchanges anything more; a world of one never does. So a dense model pays
one such all-gather, on its first step (more while a parameter that
requires a gradient gets none on any rank);
``DistributedOptimizer.agreements`` counts them where they are handed to
``torch.distributed``.

The numeric-integrity sentinel (``core/sentinel.py``): while one is
active, each bucket's local gradients are probed just before its
all-reduce is launched, on the stream the all-reduce waits on and with no
wait for the card: the max of ``|g|`` (finite or not) and the f32 sum of
squares go into small tensors on the card. These are this rank's gradients
before the reduction, as JAX's ``health_vector(grads, ...)`` sees them, so
the gathered health vector can name the rank at fault. :meth:`health`
gathers ``[finite, sqnorm, digest of the parameters]`` from every rank
into ``[n, 3]``; ``step()`` feeds it to the ladder and applies the update
only when every rank's gradients were finite. A sparse gradient is not
probed. ``step()`` runs in the step monitor's span
(``core/watchdog.py``) and counts ``hvd_frontend_steps_total``;
:meth:`skip_synchronize` is the reference's, for a ``synchronize()``
called by hand before ``step()``.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import List, Optional

import torch

from ..collectives import ops as _ops
from ..collectives.adasum import adasum_allreduce
from ..collectives.compression import Compression, Compressor
from ..core import context_api as _ctx
from ..core import sentinel as _sentinel
from ..core import telemetry as _telemetry
from ..core import watchdog as _watchdog
from ..core.config import resolve_fusion_threshold_bytes
from ..core.process_sets import ProcessSet

#: A parameter's kind of gradient, agreed by the ranks: dense, or
#: ``_DENSE + sparse_dim`` for a sparse one (0 on a rank: no gradient).
_DENSE = 1


def _kind(grad: Optional[torch.Tensor]) -> int:
    if grad is None:
        return 0
    return _DENSE + grad.sparse_dim() if grad.is_sparse else _DENSE


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
                 process_set: Optional[ProcessSet], sparse_as_dense: bool):
        super(self.__class__, self).__init__(params)
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self._compression = compression
        self._process_set = process_set
        self._sparse_as_dense = sparse_as_dense
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
        self._ordered = [p for g in self.param_groups for p in g["params"]
                         if p.requires_grad]
        self._kind = {}     # parameter -> its agreed kind of gradient
        self._sparse = []   # the parameters agreed sparse, in order
        self.replan()
        self._passes = {p: 0 for p in self._ordered}
        #: The sentinel this optimizer's steps feed and its buckets are
        #: probed for (None: the active one; False: none).
        self.sentinel = None
        self._probes = []   # (finite, sqnorm) a launched bucket, this step
        self._sentinel_steps = 0
        self._should_synchronize = True
        for p in self._ordered:
            p.register_post_accumulate_grad_hook(_weak_hook(self))

    def replan(self) -> None:
        """(Re)build the fusion buckets at the current threshold
        (``HOROVOD_FUSION_THRESHOLD``, or an active
        ``collectives.ops.fusion_threshold_override``: the autotuner's
        knob). Between steps only; every rank must re-plan alike."""
        if any(b.inflight is not None for b in getattr(self, "_buckets", ())):
            raise AssertionError("replan() with a bucket in flight")
        ordered = [(i, p) for i, g in enumerate(self.param_groups)
                   for p in g["params"] if p.requires_grad
                   and self._kind.get(p, _DENSE) == _DENSE]
        sets = [g.get("replica_set") for g in self.param_groups]
        divisors = [g.get("data_shards") for g in self.param_groups]
        if self._op == _ops.Adasum:
            if any(s is not None for s in sets):
                raise ValueError("op=Adasum takes no replica_set groups")
            self._buckets = [_Bucket([p for _, p in ordered])]
        else:
            # One bucket never mixes groups: a group may have its own
            # replica set, and a step may freeze a group (no gradient).
            comp = self._compression
            sizes = [(p.numel() * comp.wire_dtype_for(p.dtype).itemsize,
                      (comp.wire_dtype_for(p.dtype), i)) for i, p in ordered]
            plan = _ops.plan_buckets(sizes, resolve_fusion_threshold_bytes())
            self._buckets = [_Bucket([ordered[j][1] for j in idxs],
                                     sets[ordered[idxs[0]][0]],
                                     divisors[ordered[idxs[0]][0]])
                             for idxs in plan]
        self._bucket_of = {p: b for b in self._buckets for p in b.params}

    @property
    def buckets(self) -> List[List[torch.nn.Parameter]]:
        """The fusion buckets, in launch order (sparse parameters in none)."""
        return [b.params for b in self._buckets if b.params]

    # -- the sentinel's probe ------------------------------------------------

    def _sentinel_now(self):
        if self.sentinel is False:
            return None
        return self.sentinel if self.sentinel is not None \
            else _sentinel.active()

    def _probing(self) -> bool:
        return self._sentinel_now() is not None

    def _probe_grads(self, grads) -> None:
        """Queue this rank's (finite, sqnorm) of ``grads`` on the current
        stream, before the all-reduce that will overwrite them."""
        grads = [g for g in grads if g is not None and not g.is_sparse]
        if grads:
            self._probes.append((_sentinel.grads_finite(grads),
                                 _sentinel.grad_sqnorm(grads)))

    def health(self, gather: bool = True) -> torch.Tensor:
        """This step's health vector, ``[n, 3]`` over the optimizer's ranks
        (``[1, 3]``, this rank's row, with ``gather=False``): the finite
        bit and squared norm of the gradients its buckets probed before
        their all-reduces, and the digest of its parameters as they stand
        (call it before the update). Consumes the probes."""
        probes, self._probes = self._probes, []
        if probes:
            finite = torch.stack([f for f, _ in probes]).all()
            sq = torch.stack([q for _, q in probes]).sum()
        else:
            finite = torch.ones((), dtype=torch.bool)
            sq = torch.zeros(())
        dev = self._ordered[0].device if self._ordered else finite.device
        row = _sentinel.local_health(finite.to(dev), sq.to(dev),
                                     _sentinel.param_digest(self._ordered))
        return _sentinel.gather_health(
            row, self._process_set if gather else False)

    def _hook(self, p: torch.nn.Parameter) -> None:
        g = p.grad
        if g.is_sparse and (self._sparse_as_dense
                            or self._kind.get(p) == _DENSE):
            p.grad = g = g.to_dense()
        elif not g.is_sparse and self._kind.get(p, 0) > _DENSE:
            p.grad = g = g.to_sparse(self._kind[p] - _DENSE)
        self._passes[p] += 1
        if self._passes[p] < self.backward_passes_per_step:
            return
        self._passes[p] = 0
        if g.is_sparse:
            if self._op == _ops.Adasum:
                raise ValueError("op=Adasum takes no sparse gradient; pass "
                                 "sparse_as_dense=True")
            return  # reduced in synchronize(), once the ranks agree on it
        bucket = self._bucket_of[p]
        bucket.pending -= 1
        if bucket.pending == 0 and self._op != _ops.Adasum:
            self._launch(bucket)

    def _launch(self, bucket: _Bucket) -> None:
        if self._probing():
            self._probe_grads([p.grad for p in bucket.params])
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
        if not self._sparse_as_dense:
            self._agree_on_sparse()
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
        self._reduce_sparse()

    def _agree_on_sparse(self) -> None:
        """Agree on the kind of gradient of each parameter that has had
        none on any rank so far: one all-gather of every rank's kinds
        (module doc). A parameter found sparse leaves its bucket."""
        unknown = [p for p in self._ordered
                   if p.requires_grad and p not in self._kind]
        if not unknown:
            return
        kinds = [_kind(p.grad) for p in unknown]
        if self._world > 1:
            DistributedOptimizer.agreements += 1
            kinds = _ops.allgather(
                torch.tensor([kinds], device=_ctx.device()),
                process_set=self._process_set).amax(0).tolist()
        for p, kind in zip(unknown, kinds):
            if kind == 0:
                continue
            self._kind[p] = kind
            if kind > _DENSE:
                bucket = self._bucket_of.pop(p)
                if bucket.replica_set is not None:
                    raise ValueError("a parameter with a sparse gradient "
                                     "takes no replica_set group")
                bucket.params = [q for q in bucket.params if q is not p]
        self._sparse = [p for p in self._ordered
                        if self._kind.get(p, 0) > _DENSE]

    def _reduce_sparse(self) -> None:
        """``sparse_allreduce`` of each sparse gradient, in parameter order;
        a rank where one got no gradient contributes an empty one."""
        scale = self._prescale * self._postscale
        for p in self._sparse:
            if not p.requires_grad:
                continue
            g = p.grad
            if g is None:
                dims = self._kind[p] - _DENSE
                g = torch.sparse_coo_tensor(
                    torch.zeros((dims, 0), dtype=torch.long,
                                device=p.device),
                    p.new_zeros((0,) + tuple(p.shape[dims:])), p.shape)
            elif scale != 1.0:
                g = torch.sparse_coo_tensor(g._indices(), g._values() * scale,
                                            g.shape)
            p.grad = _ops.sparse_allreduce(g, self._op,
                                           process_set=self._process_set)

    def _synchronize_adasum(self) -> None:
        """Adasum over every gradient as one flat vector. The ``1/k`` of
        ``backward_passes_per_step = k`` scales each gradient first, as the
        JAX optimizer scales its accumulated gradients before reducing."""
        (bucket,) = self._buckets
        grads = []
        if self._probing():
            self._probe_grads([p.grad for p in bucket.params])
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

    @contextlib.contextmanager
    def skip_synchronize(self):
        """For a ``synchronize()`` called by hand before ``step()``: the
        ``step()`` inside this context does not synchronize again
        (reference contract)."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def apply_update(self, closure=None):
        """The wrapped optimizer's update on the gradients as they stand:
        no synchronization, no sentinel. The train steps call it once
        they have gated the step themselves."""
        return super(self.__class__, self).step(closure)

    def step(self, closure=None):
        """Synchronize (unless inside :meth:`skip_synchronize`), and apply
        the update. With a sentinel active the step's health vector goes
        to the ladder first; the update is withheld (``None`` returned)
        unless every rank's gradients were finite, and a rollback, evict
        or abort verdict is carried out."""
        _telemetry.inc("hvd_frontend_steps_total", frontend="torch")
        with _watchdog.monitor().step_span("torch_step"):
            if self._should_synchronize:
                self.synchronize()
            s = self._sentinel_now()
            if s is not None:
                self._sentinel_steps += 1
                health = _sentinel.decode_health(self.health())
                action = s.observe(health, self._sentinel_steps)
                if action.kind == "rollback":
                    s.do_rollback(None)
                elif action.kind in ("evict", "abort"):
                    s.do_evict(action)
                if not health.finite:
                    return None
            return self.apply_update(closure)

    def zero_grad(self, set_to_none: bool = True):
        if any(b.inflight is not None
               or (self._op == _ops.Adasum and b.pending == 0)
               for b in self._buckets):
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step() or optimizer.synchronize()")
        self._probes = []  # a step's probes never outlive it
        return super(self.__class__, self).zero_grad(set_to_none)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression: Compressor = Compression.none,
                         backward_passes_per_step: int = 1,
                         op: str = _ops.Average,
                         gradient_predivide_factor: float = 1.0,
                         process_set: Optional[ProcessSet] = None,
                         sparse_as_dense: bool = False):
    """Wrap ``optimizer`` so gradients are all-reduced across ranks during
    ``loss.backward()`` (reference ``hvd.DistributedOptimizer``). Needs an
    initialised context. With ``backward_passes_per_step=k`` the gradients of
    k backward passes accumulate locally and are reduced, divided by k, once;
    call ``step()`` after the k-th. A sparse gradient is reduced by
    ``sparse_allreduce``, or densified first with ``sparse_as_dense``
    (module doc)."""
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
               process_set, sparse_as_dense)


#: The all-gathers of the kinds of gradient (``_agree_on_sparse``) handed
#: to ``torch.distributed``, as ``allreduce_async_.launches`` counts its own.
DistributedOptimizer.agreements = 0
