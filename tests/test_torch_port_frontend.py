"""The port's torch frontend (``horovod_tpu_torch.frontend``) against the
reference's (``horovod_tpu.torch``).

The cases of ``tests/test_torch_api.py`` — async and in-place forms, poll
and an unknown handle, the scale factors, fp16 and bf16 compression, the
grouped ops, named ops submitted in opposite orders, a duplicate in-flight
name, ``allreduce_fused_async_``, ``sparse_allreduce_async``, the uneven
allgather, broadcast, alltoall with splits, reducescatter, ``join`` with
uneven ranks, ``barrier``, and ``DistributedOptimizer``'s averaging,
``backward_passes_per_step``, ``zero_grad`` guard and
``skip_synchronize`` — are written once (:data:`_CASES`) against the API
both frontends share, and run twice: by a 2-process gloo world of the
port, started once for the module, and by the reference over its
``ThreadSimEngine`` in this process. Integer-valued data must agree
exactly; float data within 1e-6 (the same sums in another order). The port
world also checks what the reference cannot show in one process: a name
whose shape differs between the ranks raises on both and hangs neither;
the caller's own waits on the store (``new_group``) pass while the
negotiation thread cycles; an op on a process set; and the negotiation's
counts, and the idle thread's back-off. A 3-process world beside it runs ops on a process set made through
the port's top level while the caller makes groups of its own, and checks
that the negotiation thread makes no group.
"""

import pickle
import textwrap

import pytest
import torch

import horovod_tpu.torch as ref_hvd
import torch_port_mp as mp
from horovod_tpu.torch.testing import run_parallel

N = 2

#: The cases as functions of (hvd, rank), for either frontend.
_CASES = textwrap.dedent('''
    import torch


    def inplace_async(hvd, r):
        t = torch.full((4,), float(r + 1))
        h = hvd.allreduce_async_(t, op=hvd.Sum, name="ip")
        assert isinstance(h, int)
        out = hvd.synchronize(h)
        return [t, torch.tensor(out is t)]


    def async_out_of_place(hvd, r):
        t = torch.full((3,), float(r + 1))
        h = hvd.allreduce_async(t, average=False, name="oop")
        return [hvd.synchronize(h), t]


    def poll_and_unknown_handle(hvd, r):
        h = hvd.allreduce_async(torch.ones(2), op=hvd.Sum, name="pu")
        assert hvd.poll(h) in (True, False)
        out = hvd.synchronize(h)
        raised = []
        for fn in (hvd.poll, hvd.synchronize):
            try:
                fn(h)
                raised.append(False)
            except ValueError:
                raised.append(True)
        try:
            hvd.poll(10 ** 6)
            raised.append(False)
        except ValueError:
            raised.append(True)
        return [out, torch.tensor(raised)]


    def average_and_ops(hvd, r):
        t = torch.tensor([float(r + 1), float(3 - r)])
        return [hvd.allreduce(torch.full((2,), float(r)), name="avg"),
                hvd.allreduce(t, op=hvd.Min, name="mn"),
                hvd.allreduce(t, op=hvd.Max, name="mx"),
                hvd.allreduce(t, op=hvd.Product, name="pr"),
                hvd.allreduce(torch.full((3, 2), r + 1, dtype=torch.int64),
                              op=hvd.Sum, name="int")]


    def scale_factors(hvd, r):
        return [hvd.allreduce(torch.full((2,), 2.0), op=hvd.Sum, name="s",
                              prescale_factor=0.5, postscale_factor=3.0)]


    def compression(hvd, r):
        fp16 = hvd.allreduce(torch.full((8,), 1.5), op=hvd.Sum, name="c",
                             compression=hvd.Compression.fp16)
        bf16 = hvd.allreduce(torch.tensor([1.0, 2.0],
                                          dtype=torch.bfloat16) * (r + 1),
                             op=hvd.Sum, name="bf")
        return [fp16, torch.tensor(fp16.dtype == torch.float32),
                bf16.float(), torch.tensor(bf16.dtype == torch.bfloat16)]


    def grouped(hvd, r):
        ts = [torch.full((2,), float(r + 1)), torch.full((3,), float(r))]
        outs = hvd.grouped_allreduce(ts, op=hvd.Sum, name="grp")
        hvd.grouped_allreduce_(ts, op=hvd.Sum, name="grp_")
        gat = hvd.grouped_allgather([torch.full((1, 2), float(r)),
                                     torch.full((2,), float(r))],
                                    name="gag")
        rs = hvd.grouped_reducescatter([torch.arange(4.0),
                                        torch.arange(6.0).reshape(2, 3)],
                                       op=hvd.Sum, name="grs")
        return outs + ts + gat + rs


    def out_of_order_names(hvd, r):
        if r == 0:
            a = hvd.allreduce_async(torch.tensor([1.0]), op=hvd.Sum,
                                    name="op_a")
            b = hvd.allreduce_async(torch.tensor([2.0]), op=hvd.Sum,
                                    name="op_b")
        else:
            b = hvd.allreduce_async(torch.tensor([20.0]), op=hvd.Sum,
                                    name="op_b")
            a = hvd.allreduce_async(torch.tensor([10.0]), op=hvd.Sum,
                                    name="op_a")
        return [hvd.synchronize(a), hvd.synchronize(b)]


    def duplicate_name(hvd, r):
        """Each rank submits its own name twice while the other has not
        submitted it yet (an all-reduce orders the two), so the first is
        surely in flight when the second comes."""
        mine = hvd.allreduce_async(torch.ones(2), op=hvd.Sum, name=f"dup{r}")
        try:
            hvd.allreduce_async(torch.ones(2), op=hvd.Sum, name=f"dup{r}")
            raised = False
        except ValueError:
            raised = True
        hvd.allreduce(torch.ones(1), op=hvd.Sum, name="dup.order")
        other = hvd.allreduce_async(torch.ones(2), op=hvd.Sum,
                                    name=f"dup{1 - r}")
        return [hvd.synchronize(mine), hvd.synchronize(other),
                torch.tensor(raised)]


    def fused(hvd, r):
        ts = [torch.full((i + 1, 2), float(r + i)) for i in range(8)]
        per = [hvd.allreduce(t, op=hvd.Sum, name=f"per.{i}")
               for i, t in enumerate(ts)]
        out = hvd.synchronize(hvd.mpi_ops.allreduce_fused_async_(
            ts, op=hvd.Sum, name="fused"))
        return per + list(out) + ts


    def sparse(hvd, r):
        dense = torch.zeros(6, 3)
        dense[r] = 1.0 + r
        dense[4] = 2.0
        return [hvd.synchronize(hvd.sparse_allreduce_async(
                    dense.to_sparse_coo(), op=op, name=f"sp.{op}")
                ).to_dense() for op in (hvd.Sum, hvd.Average)]


    def shape_changing(hvd, r):
        g = hvd.allgather(torch.arange(r + 1, dtype=torch.float32) + 10 * r,
                          name="g")
        t = torch.full((3,), float(r))
        b = hvd.broadcast(t, root_rank=1, name="b")
        b_ = hvd.broadcast_(torch.full((3,), float(r)), root_rank=0,
                            name="b_")
        a = hvd.alltoall(torch.arange(4, dtype=torch.float32) + 10 * r,
                         name="a2a")
        av, recv = hvd.alltoall(torch.arange(4, dtype=torch.float32)
                                + 10 * r, splits=torch.tensor([1, 3]),
                                name="a2av")
        rs = hvd.reducescatter(torch.arange(4, dtype=torch.float32),
                               op=hvd.Sum, name="rs")
        return [g, b, t, b_, a, av, recv, rs]


    def join_uneven(hvd, r):
        total = torch.zeros(1)
        for i in range(r + 1):
            total += hvd.allreduce(torch.ones(1), op=hvd.Sum,
                                   name=f"step.{i}")
        return [total, torch.tensor(hvd.join())]


    def barrier(hvd, r):
        hvd.barrier()
        return [torch.tensor(1)]


    def _model():
        m = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                                torch.nn.Linear(8, 1))
        with torch.no_grad():
            for i, p in enumerate(m.parameters()):
                p.copy_(torch.linspace(-0.5, 0.5, p.numel()).reshape(p.shape)
                        * (i + 1))
        return m


    def _params(m):
        return [p.detach().clone() for p in m.parameters()]


    def optimizer_averaging(hvd, r):
        m = _model()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(m.parameters(), lr=0.1),
            named_parameters=m.named_parameters())
        opt.zero_grad()
        m(torch.full((2, 4), float(r + 1))).sum().backward()
        opt.step()
        return _params(m)


    def backward_passes(hvd, r):
        m = _model()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(m.parameters(), lr=0.1),
            named_parameters=m.named_parameters(),
            backward_passes_per_step=2)
        for i in range(2):
            m(torch.full((2, 4), float(r + i + 1))).sum().backward()
        opt.step()
        return _params(m)


    def zero_grad_guard(hvd, r):
        m = _model()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(m.parameters(), lr=0.1),
            named_parameters=m.named_parameters())
        m(torch.ones(1, 4)).sum().backward()
        try:
            opt.zero_grad()
            raised = False
        except AssertionError:
            raised = True
        opt.step()
        return [torch.tensor(raised)] + _params(m)


    def skip_synchronize(hvd, r):
        """A step through synchronize() and skip_synchronize() against a
        plain step() of the same model: equal bit for bit."""
        out = []
        for manual in (False, True):
            m = _model()
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9),
                named_parameters=m.named_parameters())
            for step in range(2):
                opt.zero_grad()
                m(torch.full((2, 4), float(r + step + 1))).sum().backward()
                if manual:
                    opt.synchronize()
                    with opt.skip_synchronize():
                        opt.step()
                else:
                    opt.step()
            out += _params(m)
        return out


    CALLS = {
        "inplace-async": inplace_async,
        "async-out-of-place": async_out_of_place,
        "poll-and-unknown-handle": poll_and_unknown_handle,
        "average-and-ops": average_and_ops,
        "scale-factors": scale_factors,
        "compression": compression,
        "grouped": grouped,
        "out-of-order-names": out_of_order_names,
        "duplicate-name": duplicate_name,
        "allreduce-fused": fused,
        "sparse-allreduce-async": sparse,
        "shape-changing": shape_changing,
        "join-uneven": join_uneven,
        "barrier": barrier,
        "optimizer-averaging": optimizer_averaging,
        "backward-passes-per-step": backward_passes,
        "zero-grad-guard": zero_grad_guard,
        "skip-synchronize": skip_synchronize,
    }
''')

_WORKER = textwrap.dedent("""
    import pickle
    import sys
    import threading
    import time
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    import horovod_tpu_torch
    from horovod_tpu_torch import frontend as hvd
    from horovod_tpu_torch.core.process_sets import ProcessSet

    data_dir = sys.argv[1]
    sys.path.insert(0, data_dir)
    import frontend_cases

    # The thread of every new_group call: the negotiation thread must make
    # none (new_group runs in one order on every rank).
    made_by = []
    _new_group = dist.new_group


    def new_group(*args, **kwargs):
        made_by.append(threading.current_thread().name)
        return _new_group(*args, **kwargs)


    dist.new_group = new_group


    def process_sets(rank):
        # A set made through the port's top level, not the frontend's.
        ps = horovod_tpu_torch.add_process_set([0, 2])
        got = []
        for i in range(3):
            h = None
            if rank != 1:
                h = hvd.allreduce_async(torch.full((2,), rank + 1.0 + i),
                                        op=hvd.Sum, name=f"ps.{i}",
                                        process_set=ps)
            # The caller makes a group of its own while the op is in
            # flight.
            dist.new_group([0, 1, 2])
            got.append(hvd.synchronize(h) if h is not None
                       else torch.zeros(2))
        # A set the frontend has no group for fails on its members.
        stray = ""
        if rank != 0:
            try:
                hvd.allreduce(torch.ones(2), op=hvd.Sum, name="stray",
                              process_set=ProcessSet(99, (1, 2)))
            except ValueError as e:
                stray = str(e)
        return {"ps": got, "stray": stray,
                "after-stray": hvd.allreduce(torch.ones(2), op=hvd.Sum,
                                             name="after-stray")}


    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()
    if size == 3:
        out = process_sets(rank)
        out["made_by"] = made_by
        hvd.shutdown()
        with open(f"{data_dir}/w3rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
        sys.exit(0)
    # The caller's own waits on the store (new_group's barrier) while the
    # negotiation thread cycles; then ops on a process set of the frontend.
    for _ in range(3):
        torch.distributed.new_group([0, 1])
    ps = hvd.add_process_set([1])
    out = {"process-set": [
        hvd.allreduce(torch.full((2,), rank + 1.0), op=hvd.Sum, name="ps",
                      process_set=ps) if rank == 1 else torch.zeros(2),
        hvd.allreduce(torch.ones(2), op=hvd.Sum, name="after-ps")]}
    out.update({name: fn(hvd, rank)
                for name, fn in frontend_cases.CALLS.items()})
    # With no op pending anywhere the thread backs off: few cycles in half
    # a second (one a millisecond without the back-off).
    hvd.barrier()
    c0 = hvd.negotiation_stats()["cycles"]
    time.sleep(0.5)
    out["idle-cycles"] = hvd.negotiation_stats()["cycles"] - c0
    # A name whose shape differs between the ranks fails on both.
    h = hvd.allreduce_async(torch.ones(3 + rank), op=hvd.Sum, name="mm")
    try:
        hvd.synchronize(h)
        out["mismatch"] = ""
    except ValueError as e:
        out["mismatch"] = str(e)
    # The world goes on after it.
    out["after-mismatch"] = hvd.allreduce(torch.ones(2), op=hvd.Sum,
                                          name="after")
    out["stats"] = hvd.negotiation_stats()
    out["probes"] = [hvd.nccl_built(), hvd.cuda_built(), hvd.mpi_built(),
                     hvd.gloo_enabled(), hvd.is_initialized()]
    out["made_by"] = made_by
    hvd.shutdown()
    with open(f"{data_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
""")


def _cases():
    ns = {}
    exec(compile(_CASES, "frontend_cases", "exec"), ns)
    return ns["CALLS"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("frontend")
    (tmp / "frontend_cases.py").write_text(_CASES)
    wait = mp.start_worlds(tmp, _WORKER, (N, 3))
    ref = {}
    for name, fn in _cases().items():
        ref_hvd.shutdown()
        ref[name] = run_parallel(N, lambda r, fn=fn: fn(ref_hvd, r))
    wait()
    port = []
    for r in range(N):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    sets = []
    for r in range(3):
        with open(tmp / f"w3rank{r}.pkl", "rb") as f:
            sets.append(pickle.load(f))
    return port, ref, sets


@pytest.mark.parametrize("name", sorted(_cases()))
def test_frontend_matches_the_reference_frontend(results, name):
    port, ref, _ = results
    for r in range(N):
        assert len(port[r][name]) == len(ref[name][r])
        for got, want in zip(port[r][name], ref[name][r]):
            assert got.dtype == want.dtype, name
            if got.is_floating_point():
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
            else:
                assert torch.equal(got, want), (name, got, want)


def test_mismatched_signature_raises_on_every_rank(results):
    port, _, _ = results
    for r in range(N):
        assert "mismatched allreduce for name 'mm'" in port[r]["mismatch"]
        assert torch.equal(port[r]["after-mismatch"], torch.full((2,), 2.0))


def test_store_waits_and_process_sets_beside_the_negotiation(results):
    """The caller's ``new_group`` barriers pass while the negotiation
    thread cycles on its own store client, and an op on a process set of
    one rank completes on that rank alone."""
    port, _, _ = results
    assert torch.equal(port[1]["process-set"][0], torch.full((2,), 2.0))
    for r in range(N):
        assert torch.equal(port[r]["process-set"][1], torch.full((2,), 2.0))


def test_negotiation_counts_and_build_probes(results):
    port, _, _ = results
    for r in range(N):
        # half a second idle: about 20 cycles as the wait doubles to 32 ms
        assert port[r]["idle-cycles"] <= 60, port[r]["idle-cycles"]
        stats = port[r]["stats"]
        # Every case's ops, and the cycles that carried them.
        assert stats["ops"] >= 30 and stats["cycles"] >= 20
        assert stats["ms_per_op"] > 0
        assert port[r]["probes"] == [torch.distributed.is_nccl_available(),
                                     torch.version.cuda is not None, False,
                                     torch.distributed.is_gloo_available(),
                                     True]


def test_process_set_groups_are_made_on_the_callers_thread(results):
    """Ops on a set made through the port's top level complete while the
    caller makes groups of its own; every group, the frontend's included,
    is made on the caller's thread; an op on a set the frontend has no
    group for fails on its members and the world goes on."""
    port, _, sets = results
    for r in (0, 2):
        for i, got in enumerate(sets[r]["ps"]):
            assert torch.equal(got, torch.full((2,), 4.0 + 2 * i))
    for r in (1, 2):
        assert "the frontend has no group over ranks (1, 2)" \
            in sets[r]["stray"]
    assert sets[0]["stray"] == ""
    for world in (port, sets):
        for out in world:
            assert out["made_by"]
            assert "hvd-negotiation" not in out["made_by"]
    for r in range(3):
        assert torch.equal(sets[r]["after-stray"], torch.full((2,), 3.0))
