"""Sparse gradients in the port against the reference's torch frontend.

The reference's sparse cases (``tests/test_torch_api.py``: the sparse
all-reduce against the dense sum, ``sparse_as_dense`` both ways against a
dense run, and no deadlock when a sparse parameter is unused on one rank,
unused from the first step, or first used mid-run) plus
``backward_passes_per_step = 2``, written once (:data:`_CASES`) and run
twice: by a 2-process gloo world of the port (``horovod_tpu_torch``,
``DistributedOptimizer``'s ``sparse_allreduce`` path), started once for the
module, and by ``horovod_tpu.torch`` over its ``ThreadSimEngine``
(``horovod_tpu/torch/testing.py``) in this process. Each rank's results
must agree within 1e-6 (the same sums in another order) and, where the
reference test has one, match its expected value.
"""

import pickle
import textwrap

import pytest
import torch

import horovod_tpu.torch as ref_hvd
import torch_port_mp as mp
from horovod_tpu.torch.testing import run_parallel

N = 2

#: The cases as functions of (hvd, rank), for either package.
_CASES = textwrap.dedent('''
    import torch


    def _reduce_sparse(hvd, sp, op):
        if hasattr(hvd, "sparse_allreduce"):  # the port
            return hvd.sparse_allreduce(sp, op)
        return hvd.synchronize(hvd.sparse_allreduce_async(sp, op=op,
                                                          name="sp"))


    def sparse_allreduce(hvd, rank, op):
        dense = torch.zeros(6, 3)
        dense[rank] = 1.0 + rank    # rank-distinct rows
        dense[4] = 2.0              # a row both hold: the coalesce sums it
        return [_reduce_sparse(hvd, dense.to_sparse_coo(), op).to_dense()]


    def _embedding(sparse):
        emb = torch.nn.Embedding(8, 4, sparse=sparse)
        with torch.no_grad():
            emb.weight.copy_(torch.arange(32, dtype=torch.float32)
                             .reshape(8, 4) / 10)
        return emb


    def embedding_fit(hvd, rank, sparse, sparse_as_dense, passes=1):
        emb = _embedding(sparse)
        hvd.broadcast_parameters(emb.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(emb.parameters(), lr=0.1),
            named_parameters=emb.named_parameters(),
            sparse_as_dense=sparse_as_dense,
            backward_passes_per_step=passes)
        for step in range(3):
            opt.zero_grad()
            for p in range(passes):
                ids = torch.tensor([rank, 2 + rank + p, 5])
                (emb(ids) * (1.0 + step)).sum().backward()
            opt.step()
        return [emb.weight.detach().clone()]


    class EmbLin(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = torch.nn.Embedding(6, 3, sparse=True)
            self.lin = torch.nn.Linear(3, 1)
            with torch.no_grad():
                self.emb.weight.copy_(torch.arange(18, dtype=torch.float32)
                                      .reshape(6, 3))
                self.lin.weight.fill_(0.5)
                self.lin.bias.zero_()


    def unused_fit(hvd, rank, mode):
        """``mode``: "one-rank" (rank 1 skips the embedding on step 1),
        "first-step" (rank 1 never uses it), "mid-run" (no rank uses it on
        step 0, rank 0 from step 1)."""
        m = EmbLin()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(m.parameters(), lr=0.1),
            named_parameters=m.named_parameters())
        steps = 3 if mode == "mid-run" else 2
        for step in range(steps):
            opt.zero_grad()
            use = {"one-rank": rank == 0 or step == 0,
                   "first-step": rank == 0,
                   "mid-run": rank == 0 and step >= 1}[mode]
            if use:
                loss = m.lin(m.emb(torch.tensor([rank, 3]))).sum()
            else:
                loss = m.lin(torch.ones(2, 3)).sum()
            loss.backward()
            opt.step()
        return [m.emb.weight.detach().clone(), m.lin.weight.detach().clone()]


    CALLS = {
        "allreduce-sum": (sparse_allreduce, ("sum",)),
        "allreduce-average": (sparse_allreduce, ("average",)),
        "embedding-sparse": (embedding_fit, (True, False)),
        "embedding-sparse-as-dense": (embedding_fit, (True, True)),
        "embedding-dense": (embedding_fit, (False, False)),
        "embedding-passes-2": (embedding_fit, (True, False, 2)),
        "embedding-dense-passes-2": (embedding_fit, (False, False, 2)),
        "unused-one-rank": (unused_fit, ("one-rank",)),
        "unused-first-step": (unused_fit, ("first-step",)),
        "unused-mid-run": (unused_fit, ("mid-run",)),
    }
''')

_WORKER = textwrap.dedent("""
    import pickle
    import sys
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd

    data_dir = sys.argv[1]
    sys.path.insert(0, data_dir)
    import sparse_cases


    def agreements(kind):
        # The kinds-of-gradient all-gathers of each of three steps of an
        # embedding and a linear layer: dense, sparse, or sparse and used
        # by no rank on step 0.
        emb = torch.nn.Embedding(6, 3, sparse=kind != "dense")
        lin = torch.nn.Linear(3, 1)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(
            [*emb.parameters(), *lin.parameters()], lr=0.1))
        seen = []
        for step in range(3):
            opt.zero_grad()
            if kind == "unused-on-step-0" and step == 0:
                x = torch.ones(2, 3)
            else:
                x = emb(torch.tensor([rank, 3]))
            lin(x).sum().backward()
            before = hvd.DistributedOptimizer.agreements
            opt.step()
            seen.append(hvd.DistributedOptimizer.agreements - before)
        return seen


    hvd.init(device="cpu")
    rank = hvd.rank()
    out = {name: fn(hvd, rank, *args)
           for name, (fn, args) in sparse_cases.CALLS.items()}
    out["agreements"] = {k: agreements(k) for k in
                         ("dense", "sparse", "unused-on-step-0")}
    with open(f"{data_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    hvd.shutdown()
""")


def _namespace():
    ns = {}
    exec(compile(_CASES, "sparse_cases", "exec"), ns)
    return ns


def _cases():
    return _namespace()["CALLS"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sparse")
    (tmp / "sparse_cases.py").write_text(_CASES)
    wait = mp.start_worlds(tmp, _WORKER, (N,))
    ref = {}
    for name, (fn, args) in _cases().items():
        ref_hvd.shutdown()
        ref[name] = run_parallel(N, lambda r: fn(ref_hvd, r, *args))
    wait()
    port = []
    for r in range(N):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    return port, ref


@pytest.mark.parametrize("name", sorted(_cases()))
def test_port_matches_the_reference_frontend(results, name):
    port, ref = results
    for r in range(N):
        for got, want in zip(port[r][name], ref[name][r]):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op, row4", [("allreduce-sum", 4.0),
                                      ("allreduce-average", 2.0)])
def test_sparse_allreduce_equals_the_dense_reduction(results, op, row4):
    port, _ = results
    expect = torch.zeros(6, 3)
    expect[0], expect[1], expect[4] = 1.0, 2.0, row4
    if op == "allreduce-average":
        expect[:2] /= 2
    for r in range(N):
        torch.testing.assert_close(port[r][op][0], expect)


@pytest.mark.parametrize("case, dense", [
    ("embedding-sparse", "embedding-dense"),
    ("embedding-sparse-as-dense", "embedding-dense"),
    ("embedding-passes-2", "embedding-dense-passes-2")])
def test_sparse_gradients_train_as_dense_ones(results, case, dense):
    """The ranks end equal, and equal to the run with dense gradients."""
    port, _ = results
    for r in range(N):
        torch.testing.assert_close(port[r][case][0], port[0][case][0],
                                   rtol=0, atol=0)
        torch.testing.assert_close(port[r][case][0], port[r][dense][0])


@pytest.mark.parametrize("case", ["unused-one-rank", "unused-first-step",
                                  "unused-mid-run"])
def test_unused_sparse_parameter_does_not_deadlock(results, case):
    """The world finished (no rank waited forever) and the ranks agree."""
    port, _ = results
    for a, b in zip(port[0][case], port[1][case]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kind, want", [("dense", [1, 0, 0]),
                                        ("sparse", [1, 0, 0]),
                                        ("unused-on-step-0", [1, 1, 0])])
def test_kinds_are_agreed_until_every_parameter_had_a_gradient(
        results, kind, want):
    """``DistributedOptimizer`` all-gathers the ranks' kinds of gradient
    on a step only while some parameter has had no gradient on any rank:
    a dense model's second step issues none."""
    port, _ = results
    for r in range(N):
        assert port[r]["agreements"][kind] == want


def test_world_of_one_reduces_sparse_gradients_without_an_exchange(
        monkeypatch):
    """In a world of one, a sparse gradient leaves its bucket without the
    agreement's all-gather: the step issues one all-reduce per dense
    bucket and the sparse all-reduce of one member, which gathers
    nothing, and Adagrad applies the rows it names."""
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch.collectives import ops as tops
    from horovod_tpu_torch.optimizer import Adagrad
    issued = {"all_reduce": 0, "all_gather_into_tensor": 0}
    thvd.init(device="cpu")
    try:
        for name in issued:
            real = getattr(tops.dist, name)

            def counting(*a, _name=name, _real=real, **k):
                issued[_name] += 1
                return _real(*a, **k)
            monkeypatch.setattr(tops.dist, name, counting)
        m = _namespace()["EmbLin"]()
        opt = thvd.DistributedOptimizer(
            Adagrad(m.parameters(), lr=0.1),
            named_parameters=m.named_parameters())
        before = m.emb.weight.detach().clone()
        for _ in range(2):
            opt.zero_grad()
            m.lin(m.emb(torch.tensor([1, 3]))).sum().backward()
            opt.step()
        assert opt.buckets == [[m.lin.bias, m.lin.weight]]
        assert issued == {"all_reduce": 2, "all_gather_into_tensor": 0}
        moved = (m.emb.weight != before).any(1)
        assert moved.tolist() == [False, True, False, True, False, False]
    finally:
        monkeypatch.undo()
        thvd.shutdown()
