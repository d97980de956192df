"""Horovod's torch collectives with integer handles, matched by name.

Counterpart of ``horovod_tpu/torch/mpi_ops.py`` (reference
``horovod/torch/mpi_ops.py``, the binding ``mpi_ops_v2.cc`` and
``handle_manager.cc``): the sync and async forms of every op, in-place
``*_`` forms, integer handles resolved by :func:`synchronize` and
:func:`poll`, upstream's arguments (``average=``, ``name=``, ``op=``,
``compression=``, ``prescale_factor=``, ``postscale_factor=``,
``process_set=``), ``join`` and ``barrier``.

Ops are matched across ranks by NAME, as upstream's controller matches
them, so ranks may submit named ops in different orders. NCCL matches by
program order, so the controller cycle of upstream Horovod is ported:

- the frontend queues each op with its signature (kind, reduce op, dtype,
  shape, scale factors, root, members) and returns a handle at once;
- a background thread negotiates which names are ready on every member,
  in cycles: each rank posts its new submissions (and whether it is
  shutting down) under the cycle's key in the world's ``torch.distributed``
  store and reads every rank's, a round trip to the store (a gloo
  all-gather costs several). The thread talks to the store over a client
  connection of its own: a store client serves one request at a time, and
  a wait of the caller's (the key exchange of an NCCL communicator's first
  use, ``new_group``'s barrier) on a shared one would wait behind the
  thread's wait for a peer that is itself stuck so. A thread with nothing
  new waits up to ``HOROVOD_CYCLE_TIME`` ms (``Config.cycle_time_ms``) for
  a submission before its next cycle. While no op is pending on any rank
  that wait doubles each cycle, up to :data:`IDLE_BACKOFF` cycle times: a
  cycle takes the GIL from the caller's thread, which cost a host-bound
  training loop a quarter of its rate at one cycle a millisecond. A
  rank's own submission wakes its thread at once; a peer's waits for this
  rank's next cycle, so an op that this rank does not submit (one on a
  process set it is not in) may wait up to that cap after an idle spell;
- every rank then sees the same table and launches the agreed ops in the
  same order, on its own CUDA stream, with the device set in that thread,
  over communicators of its own (one NCCL or gloo group for the world, and
  one per process set), so they never interleave with the program-ordered
  collectives of the rest of the port. Those groups are made on the
  caller's thread, at collective points: the world's and every existing
  set's when the frontend starts, a new set's when it is added
  (``ProcessSetTable.on_add``). The thread makes none: ``new_group`` must
  run in one order on every rank, and the caller may make groups of its
  own at any time. An op on a set the frontend has no group for fails on
  every rank.

Rules kept from the reference: a duplicate in-flight name raises
``ValueError``; a name whose kind, shape, dtype, op or members differ
between ranks fails on every rank that submitted it (its handle raises a
``ValueError`` naming both sides) and never cross-pairs or hangs; a handle
keeps its tensors alive until it is synchronized; :func:`poll` does not
block; an unknown or already-synchronized handle raises ``ValueError``.
:func:`synchronize` returns once the card has finished the op (upstream's
wait on the op's completion), and makes the caller's stream the owner of
the results. While a rank has joined (:func:`join`), the others' Sum and
Average all-reduces complete with zeros from it, and an Average divides by
the ranks that submitted.

``DistributedOptimizer``'s gradient buckets keep their direct,
program-ordered launches (``optimizer/distributed.py``): that path does not
pay for the negotiation.
"""

from __future__ import annotations

import collections
import itertools
import pickle
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ..collectives.adasum import _butterfly
from ..collectives.compression import Compression
from ..core import context_api as _ctx
from ..core.process_sets import ProcessSet

Sum = "sum"
Average = "average"
Min = "min"
Max = "max"
Product = "product"
Adasum = "adasum"

#: The idle wait's cap, in cycle times (module doc).
IDLE_BACKOFF = 32

_DIST_OP = {Sum: dist.ReduceOp.SUM, Average: dist.ReduceOp.SUM,
            Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX,
            Product: dist.ReduceOp.PRODUCT}


class _Handle:
    """An op in flight: set done by the negotiation thread, with its result
    or error and, on the card, the event recorded after its launch."""

    def __init__(self, keep):
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.event = None
        self.keep = keep    # the tensors the op reads or writes


class _Op:
    """One submitted op: ``sig`` must be equal on every member, ``meta`` is
    this rank's own (a first dim, splits, an entry count), ``run(agreed)``
    executes it on the negotiation thread, where ``agreed`` holds every
    member's meta and the submitters."""

    def __init__(self, kind, name, members, sig, meta, run, handle):
        self.kind, self.name, self.members = kind, name, members
        self.sig, self.meta, self.run, self.handle = sig, meta, run, handle
        self.submitted = time.perf_counter()
        self.cycle = None   # the cycle that carried it
        self.ready_event = None


class _Runtime:
    """The handle table, the submission queue and the negotiation thread."""

    def __init__(self):
        ctx = _ctx.context()
        self.rank, self.size = ctx.rank, ctx.size
        self.device = ctx.device
        self.cycle_s = max(float(ctx.config.cycle_time_ms), 0.0) / 1e3
        self.lock = threading.Lock()
        self.handles: Dict[int, _Handle] = {}
        self.next_handle = itertools.count()
        self.inflight: set = set()
        self.names: Dict[str, int] = {}
        self.submissions: "queue.Queue[_Op]" = queue.Queue()
        self.stop = threading.Event()
        self.join_count = 0
        self.wake = threading.Event()
        # Every rank makes its runtimes in the same order: the same keys.
        self.store = dist.PrefixStore(f"hvd_frontend/{next(_runtimes)}/",
                                      _own_store_client())
        # Collective, on the caller's thread (module doc): the frontend's
        # own data groups, for the world and every process set.
        self.group_lock = threading.Lock()
        self.groups = {tuple(range(self.size)): dist.new_group()}
        self.table = ctx.process_sets
        for ps in self.table.sets():
            self.add_group(ps)
        self.table.on_add.append(self.add_group)
        #: Negotiation counts: cycles run; ops agreed and their summed
        #: seconds from submission to launch (waits for the peers
        #: included); and of those, the ops agreed in the cycle that
        #: carried this rank's own submission (it was the last to submit,
        #: so their time is the negotiation's alone).
        self.stats = {"cycles": 0, "ops": 0, "wait_s": 0.0, "last_ops": 0}
        self.last_s = collections.deque(maxlen=1024)  # the latest of those
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="hvd-negotiation")
        self.thread.start()

    # -- submission (caller's thread) ------------------------------------

    def autoname(self, kind: str, name: Optional[str]) -> str:
        if name is not None:
            return name
        with self.lock:
            i = self.names.get(kind, 0)
            self.names[kind] = i + 1
        return f"{kind}.noname.{i}"

    def submit(self, kind, name, members, sig, meta, run, keep) -> int:
        name = self.autoname(kind, name)
        if self.rank not in members:
            raise ValueError(f"rank {self.rank} is not a member of process "
                             f"set {members} and cannot submit {kind} "
                             f"{name!r}")
        h = _Handle(keep)
        op = _Op(kind, name, members, (kind,) + tuple(sig), meta, run, h)
        with self.lock:
            if self.stop.is_set():
                raise RuntimeError("horovod_tpu_torch.frontend is shut down")
            if name in self.inflight:
                raise ValueError(
                    f"duplicate name {name!r}: an op with this name is "
                    "already in flight (reference controller restriction)")
            self.inflight.add(name)
            hid = next(self.next_handle)
            self.handles[hid] = h
        if self.device.type == "cuda":
            op.ready_event = torch.cuda.Event()
            op.ready_event.record()
        self.submissions.put(op)
        self.wake.set()
        return hid

    def _exchange(self, cycle: int, payload) -> List[Any]:
        """Every rank's message of ``cycle``: post this rank's, then read
        all of them (the store waits for each key). A rank reaches a cycle
        only once every rank has posted the one before, so by then all
        have read it and this rank's previous key can go."""
        self.store.set(f"{cycle}/{self.rank}",
                       pickle.dumps(payload, pickle.HIGHEST_PROTOCOL))
        raw = self.store.multi_get([f"{cycle}/{r}"
                                    for r in range(self.size)])
        if cycle:
            self.store.delete_key(f"{cycle - 1}/{self.rank}")
        return [pickle.loads(m) for m in raw]

    # -- the negotiation thread -------------------------------------------

    def add_group(self, ps: ProcessSet) -> None:
        """Make the frontend's own group over ``ps``. Collective, on the
        caller's thread."""
        members = tuple(ps.ranks)
        if len(members) > 1:
            with self.group_lock:
                if members not in self.groups:
                    self.groups[members] = dist.new_group(list(members))

    def group(self, members: tuple):
        """The frontend's own group over ``members``, or None."""
        with self.group_lock:
            return self.groups.get(members)

    def _loop(self) -> None:
        stream = None
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            stream = torch.cuda.Stream(self.device)
        mine: Dict[str, _Op] = {}
        table: Dict[str, dict] = {}   # name -> members, subs
        joined: Dict[int, int] = {}   # rank -> cycle it joined at
        idle_s = self.cycle_s
        while True:
            self.wake.clear()
            new = []
            while True:
                try:
                    new.append(self.submissions.get_nowait())
                except queue.Empty:
                    break
            cycle = self.stats["cycles"]
            for op in new:
                op.cycle = cycle
                mine[op.name] = op
            self.stats["cycles"] += 1
            msgs = self._exchange(cycle, (
                [(op.name, op.kind, op.members, op.sig, op.meta)
                 for op in new], self.stop.is_set()))
            for r, (subs, _) in enumerate(msgs):
                for name, kind, members, sig, meta in subs:
                    e = table.setdefault(name, {"members": members,
                                                "subs": {}})
                    e["subs"][r] = (sig, meta)
                    if kind == "join":
                        joined[r] = cycle
            ready = self._ready(table, joined)
            for name, entry, error in ready:
                self._execute(name, entry, error, mine, stream, joined,
                              cycle)
            if all(stop for _, stop in msgs):
                break
            # Every rank sees the same messages and table, so all back off
            # alike; a pending op anywhere keeps the base rate.
            if table or any(subs for subs, _ in msgs):
                idle_s = self.cycle_s
            else:
                idle_s = min(2 * idle_s, IDLE_BACKOFF * self.cycle_s)
            if not new and not ready:
                self.wake.wait(idle_s)
        err = RuntimeError("horovod_tpu_torch.frontend shut down before "
                           "the op was matched on every rank")
        for op in mine.values():
            op.handle.error = err
            op.handle.done.set()

    def _ready(self, table, joined):
        """The names every member has submitted (a joined member counts for
        a Sum or Average all-reduce), in the table's order — the same on
        every rank — with the mismatch error of each, if any."""
        out = []
        for name, e in list(table.items()):
            subs, members = e["subs"], e["members"]
            sigs = [s for s, _ in subs.values()]
            kind = sigs[0][0]
            zeros_ok = kind == "allreduce" and sigs[0][1] in (Sum, Average)
            waiting = [r for r in members if r not in subs
                       and not (zeros_ok and r in joined)]
            if waiting:
                continue
            del table[name]
            error = None
            first_rank = next(iter(subs))
            for r, (s, _) in subs.items():
                if s != sigs[0] or r not in members:
                    error = ValueError(
                        f"mismatched {kind} for name {name!r} across ranks: "
                        f"rank {first_rank} submitted {sigs[0]}, rank {r} "
                        f"{s}")
                    break
            if error is None and kind != "join" and joined \
                    and any(r in joined for r in members) and not zeros_ok:
                error = ValueError(f"{kind} {name!r} cannot complete while "
                                   "a rank has joined (only Sum and Average "
                                   "all-reduces take a joined rank's zeros)")
            out.append((name, e, error))
        return out

    def _execute(self, name, entry, error, mine, stream, joined,
                 cycle) -> None:
        members = entry["members"]
        if error is None and len(members) > 1 \
                and self.group(tuple(members)) is None:
            error = ValueError(
                f"op {name!r}: the frontend has no group "
                f"over ranks {tuple(members)}; add the process set with "
                "add_process_set on every rank before its ops")
        op = mine.pop(name, None)
        subs = entry["subs"]
        if op is None:
            if self.rank in members and error is None \
                    and entry["subs"] and self.rank in joined:
                # A joined rank takes part with zeros.
                sig = next(iter(subs.values()))[0]
                self._zero_contribution(sig, members, stream)
            return
        h = op.handle
        if op.kind == "join":
            last = max(joined.items(), key=lambda kv: (kv[1], kv[0]))[0]
            for r in list(joined):
                joined.pop(r)
            h.result = last
        elif error is not None:
            h.error = error
        else:
            agreed = {"meta": {r: m for r, (_, m) in subs.items()},
                      "submitters": sorted(subs),
                      "group": self.group(tuple(members)),
                      "members": members}
            try:
                if stream is not None:
                    stream.wait_event(op.ready_event)
                    with torch.cuda.stream(stream):
                        h.result = op.run(agreed)
                        h.event = torch.cuda.Event()
                        h.event.record(stream)
                else:
                    h.result = op.run(agreed)
            except Exception as e:  # relayed to synchronize()
                h.error = e
            waited = time.perf_counter() - op.submitted
            self.stats["ops"] += 1
            self.stats["wait_s"] += waited
            if op.cycle == cycle:
                self.stats["last_ops"] += 1
                self.last_s.append(waited)
        with self.lock:
            self.inflight.discard(name)
        h.done.set()

    def _zero_contribution(self, sig, members, stream) -> None:
        _, op, dtype, shape = sig[:4]
        dev = self.device

        def run():
            buf = torch.zeros(shape, dtype=getattr(torch, dtype), device=dev)
            dist.all_reduce(buf, _DIST_OP[op],
                            group=self.group(tuple(members)))
        if stream is not None:
            with torch.cuda.stream(stream):
                run()
        else:
            run()

    def shutdown(self) -> None:
        if self.add_group in self.table.on_add:
            self.table.on_add.remove(self.add_group)
        with self.lock:
            self.stop.set()
        self.wake.set()
        self.thread.join()


_lock = threading.Lock()
_state: Optional[_Runtime] = None
_runtimes = itertools.count()


def _own_store_client():
    """A client connection of the negotiation thread's own to the world's
    store (module doc). A world whose store is not a TCP store (a world of
    one on a file or hash store) shares the world's client: no peer can
    hold it waiting."""
    from datetime import timedelta
    world = dist.distributed_c10d._get_default_store()
    store = world
    while hasattr(store, "underlying_store"):
        store = store.underlying_store
    if not isinstance(store, dist.TCPStore):
        return world
    return dist.TCPStore(store.host, store.port, is_master=False,
                         timeout=timedelta(seconds=store.timeout
                                           .total_seconds()))


def _rt() -> _Runtime:
    if _state is None:
        raise ValueError("horovod_tpu_torch.frontend is not initialized; "
                         "call hvd.init() first")
    return _state


def start() -> None:
    """Start the runtime of an initialised context. Collective."""
    global _state
    with _lock:
        if _state is None:
            _state = _Runtime()


def stop() -> None:
    """Stop the negotiation thread, once every rank has asked.
    Collective."""
    global _state
    with _lock:
        if _state is not None:
            _state.shutdown()
            _state = None


def negotiation_stats() -> Dict[str, float]:
    """This rank's negotiation counts (``_Runtime.stats``), with
    ``ms_per_op``: the median ms from submission to launch of the latest
    ops this rank submitted last, the negotiation's own price (a mean
    would carry the first use of each communicator)."""
    rt = _rt()
    s = dict(rt.stats)
    last = sorted(rt.last_s)
    s["ms_per_op"] = 1e3 * last[len(last) // 2] if last else 0.0
    return s


# --- helpers -----------------------------------------------------------------

def _members(process_set: Optional[ProcessSet]) -> tuple:
    if process_set is None or process_set.process_set_id == 0:
        return tuple(range(_ctx.size()))
    return tuple(process_set.ranks)


def _dt(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _op_from_average(average: Optional[bool], op: Optional[str]) -> str:
    if average is not None and op is not None:
        raise ValueError("specify either average or op, not both "
                         "(reference mpi_ops.py contract)")
    if op is not None:
        return op
    if average is False:
        return Sum
    return Average


def _scaled(t: torch.Tensor, f: float) -> torch.Tensor:
    """``t * f`` in ``t``'s dtype (the wire keeps its dtype)."""
    return t if f == 1.0 else (t * f).to(t.dtype)


def _reduce(wire, op, agreed, prescale, postscale, compression):
    """All-reduce the wire tensor ``wire`` (this rank's, ours to change)
    over the agreed group; Average divides by the ranks that submitted."""
    group = agreed["group"]
    if op == Adasum:
        ranks = agreed["members"]
        if len(ranks) & (len(ranks) - 1):
            raise ValueError("Adasum needs a power-of-2 member count, got "
                             f"{len(ranks)}")
        x = _scaled(wire.reshape(-1).float(), prescale)
        if len(ranks) > 1:
            x = _butterfly(x, ranks, group, compression)
        return _scaled(x, postscale).view(wire.shape).to(wire.dtype)
    wire = _scaled(wire, prescale)
    if len(agreed["members"]) > 1:
        dist.all_reduce(wire, _DIST_OP[op], group=group)
    if op == Average:
        n = len(agreed["submitters"])
        wire = wire / n if wire.is_floating_point() \
            else torch.div(wire, n, rounding_mode="floor")
    return _scaled(wire, postscale)


def _allreduce_sig(t, op, compression, prescale, postscale):
    wire = compression.wire_dtype_for(t.dtype)
    return (op, str(wire).replace("torch.", ""), tuple(t.shape),
            float(prescale), float(postscale))


def _allreduce_run(tensor, op, compression, prescale, postscale, output):
    comp = Compression.none if op == Adasum else compression

    def run_one(agreed):
        wire, cctx = comp.compress(tensor)
        if wire is tensor:
            wire = tensor.detach().clone()
        red = _reduce(wire, op, agreed, prescale, postscale, compression)
        res = comp.decompress(red, cctx).to(tensor.dtype)
        if output is not None:
            output.copy_(res)
            return output
        return res
    return run_one


# --- allreduce ---------------------------------------------------------------

def allreduce_async(tensor: torch.Tensor, average: Optional[bool] = None,
                    name: Optional[str] = None, compression=Compression.none,
                    op: Optional[str] = None, prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    process_set: Optional[ProcessSet] = None) -> int:
    op = _op_from_average(average, op)
    return _rt().submit(
        "allreduce", name, _members(process_set),
        _allreduce_sig(tensor, op, compression, prescale_factor,
                       postscale_factor), None,
        _allreduce_run(tensor, op, compression, prescale_factor,
                       postscale_factor, None), [tensor])


def allreduce_async_(tensor: torch.Tensor, average: Optional[bool] = None,
                     name: Optional[str] = None,
                     compression=Compression.none, op: Optional[str] = None,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0,
                     process_set: Optional[ProcessSet] = None) -> int:
    op = _op_from_average(average, op)
    return _rt().submit(
        "allreduce", name, _members(process_set),
        _allreduce_sig(tensor, op, compression, prescale_factor,
                       postscale_factor), None,
        _allreduce_run(tensor, op, compression, prescale_factor,
                       postscale_factor, tensor), [tensor])


def allreduce(tensor: torch.Tensor, average: Optional[bool] = None,
              name: Optional[str] = None, compression=Compression.none,
              op: Optional[str] = None, prescale_factor: float = 1.0,
              postscale_factor: float = 1.0,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    return synchronize(allreduce_async(
        tensor, average, name, compression, op, prescale_factor,
        postscale_factor, process_set))


def allreduce_(tensor: torch.Tensor, average: Optional[bool] = None,
               name: Optional[str] = None, compression=Compression.none,
               op: Optional[str] = None, prescale_factor: float = 1.0,
               postscale_factor: float = 1.0,
               process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    return synchronize(allreduce_async_(
        tensor, average, name, compression, op, prescale_factor,
        postscale_factor, process_set))


def _grouped_allreduce(tensors, average, name, compression, op,
                       prescale_factor, postscale_factor, process_set,
                       inplace: bool) -> int:
    """One handle and one negotiated name for a list of tensors, reduced
    together (reference: grouped ops, ``group_table.cc``)."""
    op = _op_from_average(average, op)
    tensors = list(tensors)
    runs = [_allreduce_run(t, op, compression, prescale_factor,
                           postscale_factor, t if inplace else None)
            for t in tensors]
    sig = tuple(_allreduce_sig(t, op, compression, prescale_factor,
                               postscale_factor) for t in tensors)
    return _rt().submit("grouped_allreduce", name, _members(process_set),
                        (op,) + sig, None,
                        lambda agreed: [r(agreed) for r in runs], tensors)


def grouped_allreduce_async(tensors, average=None, name=None,
                            compression=Compression.none, op=None,
                            prescale_factor=1.0, postscale_factor=1.0,
                            process_set: Optional[ProcessSet] = None) -> int:
    return _grouped_allreduce(tensors, average, name, compression, op,
                              prescale_factor, postscale_factor, process_set,
                              inplace=False)


def grouped_allreduce_async_(tensors, average=None, name=None,
                             compression=Compression.none, op=None,
                             prescale_factor=1.0, postscale_factor=1.0,
                             process_set: Optional[ProcessSet] = None) -> int:
    return _grouped_allreduce(tensors, average, name, compression, op,
                              prescale_factor, postscale_factor, process_set,
                              inplace=True)


def grouped_allreduce(tensors, **kw):
    return synchronize(grouped_allreduce_async(tensors, **kw))


def grouped_allreduce_(tensors, **kw):
    return synchronize(grouped_allreduce_async_(tensors, **kw))


def allreduce_fused_async_(tensors, op: str = Average,
                           name: Optional[str] = None,
                           compression=Compression.none,
                           prescale_factor: float = 1.0,
                           postscale_factor: float = 1.0,
                           process_set: Optional[ProcessSet] = None) -> int:
    """ONE all-reduce for a list of same-dtype tensors: concatenated into a
    flat fusion buffer, reduced, and copied back into the tensors in place
    (reference ``fusion_buffer_manager.cc``'s MEMCPY_IN/OUT). With Adasum
    each tensor keeps its own coefficients (the reference's segments), so
    each takes its own butterfly."""
    tensors = list(tensors)
    if op == Adasum:
        return _grouped_allreduce(tensors, None, name, compression, op,
                                  prescale_factor, postscale_factor,
                                  process_set, inplace=True)
    if len({t.dtype for t in tensors}) > 1:
        raise ValueError("allreduce_fused_async_ needs tensors of one dtype")
    n = sum(t.numel() for t in tensors)
    flat_like = tensors[0].new_empty(n) if tensors else torch.empty(0)

    def run(agreed):
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        res = _allreduce_run(flat, op, compression, prescale_factor,
                             postscale_factor, None)(agreed)
        off = 0
        for t in tensors:
            t.copy_(res[off:off + t.numel()].view_as(t))
            off += t.numel()
        return tensors
    return _rt().submit("allreduce", name, _members(process_set),
                        _allreduce_sig(flat_like, op, compression,
                                       prescale_factor, postscale_factor),
                        None, run, tensors)


def sparse_allreduce_async(tensor: torch.Tensor, op: str = Average,
                           name: Optional[str] = None,
                           process_set: Optional[ProcessSet] = None) -> int:
    """All-reduce a sparse COO tensor (the gather-based scheme of the
    reference and of ``collectives.ops.sparse_allreduce``): all-gather every
    member's indices and values, then coalesce, whose sum over duplicate
    coordinates is the reduction; Average divides the values by the member
    count first. The entry counts ride the negotiation, so no size
    exchange is needed. NOT in place: ``synchronize(handle)`` returns the
    reduced tensor."""
    if op not in (Sum, Average):
        raise ValueError(f"sparse allreduce supports Sum/Average, got {op}")
    if not tensor.is_sparse:
        raise ValueError("sparse_allreduce_async needs a sparse tensor")
    t = tensor.coalesce()
    members = _members(process_set)
    sig = (op, _dt(t), tuple(t.shape), t.sparse_dim())

    def run(agreed):
        counts = [agreed["meta"][r] for r in members]
        idx = t.indices().t().contiguous()
        vals = t.values() / len(members) if op == Average else t.values()
        idx = _gather_rows(idx, counts, agreed)
        vals = _gather_rows(vals.contiguous(), counts, agreed)
        return torch.sparse_coo_tensor(idx.t(), vals, t.shape).coalesce()
    return _rt().submit("sparse_allreduce", name, members, sig,
                        t.indices().shape[1], run, [t])


# --- allgather ---------------------------------------------------------------

def _gather_rows(x: torch.Tensor, counts, agreed) -> torch.Tensor:
    """Every member's rows of ``x`` (first dims ``counts``, member order),
    concatenated: padded to the largest, one all-gather, compacted."""
    if len(counts) == 1:
        return x
    most = max(counts)
    pad = x.new_zeros((most,) + tuple(x.shape[1:]))
    pad[:x.shape[0]] = x
    out = x.new_empty((len(counts) * most,) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, pad, group=agreed["group"])
    return torch.cat([out[i * most:i * most + c]
                      for i, c in enumerate(counts)])


def _allgather_op(tensor, members):
    def run(agreed):
        return _gather_rows(tensor.contiguous(),
                            [agreed["meta"][r] for r in members], agreed)
    return run


def allgather_async(tensor: torch.Tensor, name: Optional[str] = None,
                    process_set: Optional[ProcessSet] = None) -> int:
    """Concatenate every member's ``tensor`` along dim 0, in rank order;
    first dims may differ between ranks (upstream's allgather)."""
    members = _members(process_set)
    return _rt().submit("allgather", name, members,
                        (_dt(tensor), tuple(tensor.shape[1:])),
                        tensor.shape[0] if tensor.dim() else 1,
                        _allgather_op(tensor.reshape(-1) if tensor.dim() == 0
                                      else tensor, members), [tensor])


def allgather(tensor: torch.Tensor, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    return synchronize(allgather_async(tensor, name, process_set))


def grouped_allgather_async(tensors, name: Optional[str] = None,
                            process_set: Optional[ProcessSet] = None) -> int:
    tensors = list(tensors)
    members = _members(process_set)
    runs = [_allgather_op(t, members) for t in tensors]

    def run(agreed):
        out = []
        for i, r in enumerate(runs):
            meta = {k: v[i] for k, v in agreed["meta"].items()}
            out.append(r(dict(agreed, meta=meta)))
        return out
    return _rt().submit(
        "grouped_allgather", name, members,
        tuple((_dt(t), tuple(t.shape[1:])) for t in tensors),
        [t.shape[0] for t in tensors], run, tensors)


def grouped_allgather(tensors, name: Optional[str] = None,
                      process_set: Optional[ProcessSet] = None):
    return synchronize(grouped_allgather_async(tensors, name, process_set))


# --- broadcast ---------------------------------------------------------------

def _broadcast(tensor, root_rank, name, process_set, inplace) -> int:
    members = _members(process_set)
    if root_rank not in members:
        raise ValueError(f"root rank {root_rank} not in process set "
                         f"{members}")

    def run(agreed):
        buf = tensor if inplace else tensor.detach().clone()
        if len(members) > 1:
            dist.broadcast(buf, root_rank, group=agreed["group"])
        return buf
    return _rt().submit("broadcast", name, members,
                        (_dt(tensor), tuple(tensor.shape), int(root_rank)),
                        None, run, [tensor])


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: Optional[str] = None,
                    process_set: Optional[ProcessSet] = None) -> int:
    return _broadcast(tensor, root_rank, name, process_set, False)


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None) -> int:
    return _broadcast(tensor, root_rank, name, process_set, True)


def broadcast(tensor: torch.Tensor, root_rank: int,
              name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    return synchronize(broadcast_async(tensor, root_rank, name, process_set))


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name: Optional[str] = None,
               process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    return synchronize(broadcast_async_(tensor, root_rank, name,
                                        process_set))


# --- alltoall ----------------------------------------------------------------

def alltoall_async(tensor: torch.Tensor,
                   splits: Optional[torch.Tensor] = None,
                   name: Optional[str] = None,
                   process_set: Optional[ProcessSet] = None) -> int:
    """Send the i-th chunk of dim 0 to the i-th member: equal chunks, or
    ``splits`` rows each. With ``splits`` the result is ``(received,
    received_splits)``; every member's splits ride the negotiation, so the
    received sizes need no exchange."""
    members = _members(process_set)
    n = len(members)
    if splits is None:
        if tensor.shape[0] % n:
            raise ValueError(f"alltoall dim0 ({tensor.shape[0]}) must be "
                             f"divisible by the member count ({n})")
        send = [tensor.shape[0] // n] * n
    else:
        send = [int(s) for s in torch.as_tensor(splits).tolist()]
        if len(send) != n or sum(send) != tensor.shape[0]:
            raise ValueError("splits must have one entry per member summing "
                             "to the first dimension")
    me = members.index(_ctx.rank())

    def run(agreed):
        recv = [agreed["meta"][r][me] for r in members]
        out = tensor.new_empty((sum(recv),) + tuple(tensor.shape[1:]))
        if n > 1:
            dist.all_to_all_single(out, tensor.contiguous(), recv, send,
                                   group=agreed["group"])
        else:
            out.copy_(tensor)
        if splits is None:
            return out
        return out, torch.tensor(recv, dtype=torch.int64)
    return _rt().submit("alltoall", name, members,
                        (_dt(tensor), tuple(tensor.shape[1:]),
                         splits is not None), send, run, [tensor])


def alltoall(tensor: torch.Tensor, splits: Optional[torch.Tensor] = None,
             name: Optional[str] = None,
             process_set: Optional[ProcessSet] = None):
    """The received tensor, or ``(tensor, received_splits)`` when ``splits``
    is given (reference contract)."""
    return synchronize(alltoall_async(tensor, splits, name, process_set))


# --- reducescatter -----------------------------------------------------------

def _reducescatter_op(tensor, op, members):
    n = len(members)
    if op not in (Sum, Average):
        raise ValueError("reducescatter supports Sum and Average")
    if tensor.shape[0] % n:
        raise ValueError(f"reducescatter dim0 ({tensor.shape[0]}) must be "
                         f"divisible by the member count ({n})")

    def run(agreed):
        out = tensor.new_empty((tensor.shape[0] // n,)
                               + tuple(tensor.shape[1:]))
        if n > 1:
            dist.reduce_scatter_tensor(out, tensor.contiguous(),
                                       group=agreed["group"])
        else:
            out.copy_(tensor)
        return out / n if op == Average else out
    return run


def reducescatter_async(tensor: torch.Tensor, op: str = Sum,
                        name: Optional[str] = None,
                        process_set: Optional[ProcessSet] = None) -> int:
    members = _members(process_set)
    return _rt().submit("reducescatter", name, members,
                        (op, _dt(tensor), tuple(tensor.shape)), None,
                        _reducescatter_op(tensor, op, members), [tensor])


def reducescatter(tensor: torch.Tensor, op: str = Sum,
                  name: Optional[str] = None,
                  process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    return synchronize(reducescatter_async(tensor, op, name, process_set))


def grouped_reducescatter_async(tensors, op: str = Sum,
                                name: Optional[str] = None,
                                process_set: Optional[ProcessSet] = None
                                ) -> int:
    tensors = list(tensors)
    members = _members(process_set)
    runs = [_reducescatter_op(t, op, members) for t in tensors]
    return _rt().submit(
        "grouped_reducescatter", name, members,
        (op,) + tuple((_dt(t), tuple(t.shape)) for t in tensors), None,
        lambda agreed: [r(agreed) for r in runs], tensors)


def grouped_reducescatter(tensors, op: str = Sum,
                          name: Optional[str] = None,
                          process_set: Optional[ProcessSet] = None):
    return synchronize(grouped_reducescatter_async(tensors, op, name,
                                                   process_set))


# --- handles -----------------------------------------------------------------

def _tensors_in(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors_in(y)


def synchronize(handle: int):
    """Wait until the op behind ``handle`` has completed, on the card too,
    and return its output (reference: ``handle_manager.cc``'s wait and
    rethrow)."""
    rt = _rt()
    with rt.lock:
        h = rt.handles.pop(handle, None)
    if h is None:
        raise ValueError(f"unknown or already-synchronized handle {handle}")
    h.done.wait()
    if h.error is not None:
        raise h.error
    if h.event is not None:
        h.event.synchronize()
        cur = torch.cuda.current_stream()
        for t in _tensors_in(h.result):
            if t.is_cuda and not t.is_sparse:
                t.record_stream(cur)
    h.keep = None
    return h.result


def poll(handle: int) -> bool:
    """True if the op behind ``handle`` has completed (synchronize would
    not block); never blocks."""
    rt = _rt()
    with rt.lock:
        h = rt.handles.get(handle)
    if h is None:
        raise ValueError(f"unknown or already-synchronized handle {handle}")
    return h.done.is_set() and (h.event is None or h.event.query())


# --- join / barrier ----------------------------------------------------------

def join(device: int = -1) -> int:
    """Block until every rank has called join; return the last rank to
    join. Meanwhile this rank gives zeros to the others' Sum and Average
    all-reduces (reference ``hvd.join``; ``device`` is accepted for
    signature parity)."""
    rt = _rt()
    with rt.lock:
        k = rt.join_count
        rt.join_count += 1
    return synchronize(rt.submit("join", f"__join__.{k}",
                                 tuple(range(rt.size)), (), None,
                                 lambda agreed: None, []))


def barrier(process_set: Optional[ProcessSet] = None) -> None:
    """Return once every member has reached the barrier: the negotiation
    itself is the rendezvous."""
    synchronize(_rt().submit("barrier", None, _members(process_set), (),
                             None, lambda agreed: None, []))
