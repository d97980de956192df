"""The port's data-parallel machinery against the JAX package's, on the CPU.

- ``Config.from_env`` field parity under one environment;
- the gradient bucket count against the ``buckets`` field of the JAX
  ``collective_issue`` telemetry event, for the same tree and threshold;
- one all-reduce launched per bucket at each optimizer step;
- two AdamW steps of the port in a 2-process gloo world against
  ``make_train_step`` on the 8-device CPU mesh, same global batch: the
  parameters agree within 1e-5 (and the world's reduce ops and broadcast
  give exact answers);
- the optimizer's reduction options in a world of one.
"""

import dataclasses
import gc
import os
import socket
import subprocess
import sys
import textwrap
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu.collectives import ops as jops
from horovod_tpu.core import config as jconfig
from horovod_tpu.core import context_api as jctx
from horovod_tpu.core import telemetry as jtelemetry
from horovod_tpu.models import llama as jllama
from horovod_tpu.optimizer import distributed
from horovod_tpu.train import create_train_state, make_train_step
from horovod_tpu.train.gspmd import next_token_loss as j_next_token_loss

import horovod_tpu_torch as thvd
from horovod_tpu_torch import convert
from horovod_tpu_torch.collectives import ops as tops
from horovod_tpu_torch.core import config as tconfig
from horovod_tpu_torch.models import llama as tllama

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env", [
    {},
    {"HOROVOD_FUSION_THRESHOLD": "0", "HOROVOD_CYCLE_TIME": "3.5",
     "HOROVOD_AUTOTUNE": "1", "HOROVOD_TIMELINE": "/tmp/t.json",
     "HOROVOD_HIERARCHICAL_COMPRESSION": "BF16",
     "HOROVOD_ADASUM_ACCUMULATE_FP64": "yes",
     "HOROVOD_STALL_CHECK_TIME_SECONDS": "12",
     "HOROVOD_SENTINEL_MAX_SKIPS": "not-a-number"},
])
def test_config_from_env_matches_reference(monkeypatch, env):
    for name in list(os.environ):
        if name.startswith("HOROVOD_"):
            monkeypatch.delenv(name)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    want = dataclasses.asdict(jconfig.Config.from_env())
    got = dataclasses.asdict(tconfig.Config.from_env())
    assert got == want


def _tree():
    """Leaves of mixed size and dtype, in flatten order."""
    rng = np.random.RandomState(0)
    shapes = {"a": (100,), "b": (10, 10), "c": (7,), "d": (1000,),
              "e": (64,), "f": (5, 5)}
    return {k: rng.randn(*s).astype(np.float32 if k in "abde" else
                                    jnp.bfloat16)
            for k, s in shapes.items()}


@pytest.mark.parametrize("threshold", [0, 1200, None])
def test_bucket_count_matches_collective_issue_event(threshold, monkeypatch):
    tree = _tree()
    # JAX: the event recorded when grouped_allreduce traces this tree.
    jctx.context().config.fusion_threshold_bytes = \
        -1 if threshold is None else threshold
    f = shard_map(lambda t: jops.grouped_allreduce(t, jops.Sum),
                  mesh=hvd.mesh(), in_specs=P(), out_specs=P(),
                  check_vma=False)
    jax.jit(f).lower(jax.tree_util.tree_map(jnp.asarray, tree))
    want = [e for e in jtelemetry.active().ring.events()
            if e["kind"] == "collective_issue"][-1]["buckets"]
    # Port: the same leaves, in the same flatten order, through the planner,
    # the collective path and the optimizer's buckets.
    leaves = [torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)
        for x in jax.tree_util.tree_leaves(tree)]
    sizes = [(t.numel() * t.element_size(), t.dtype) for t in leaves]
    assert len(tops.plan_buckets(sizes, threshold)) == want
    cfg = tconfig.Config(fusion_threshold_bytes=-1 if threshold is None
                         else threshold)
    thvd.init(device="cpu", config=cfg)
    try:
        issued = []
        real = tops.dist.all_reduce

        def counting(*args, **kwargs):
            issued.append(args[0].numel())
            return real(*args, **kwargs)

        monkeypatch.setattr(tops.dist, "all_reduce", counting)
        out = thvd.grouped_allreduce(leaves, thvd.Sum)
        monkeypatch.undo()
        assert len(issued) == want
        for a, b in zip(out, leaves):
            assert torch.equal(a, b)  # a world of one: the sum is the input
        params = [torch.nn.Parameter(t) for t in leaves]
        opt = thvd.DistributedOptimizer(torch.optim.SGD(params, lr=0.1))
        assert len(opt.buckets) == want
    finally:
        thvd.shutdown()


@pytest.mark.parametrize("threshold, want", [(0, 4), (400, 2), (None, 1)])
def test_each_step_launches_one_allreduce_per_bucket(threshold, want):
    """``allreduce_async_.launches`` counts the all-reduces handed to
    ``torch.distributed``: each ``DistributedOptimizer`` step launches
    exactly one per fusion bucket (parameters of 512, 64, 256 and 16 bytes, packed in
    reverse order)."""
    cfg = tconfig.Config(fusion_threshold_bytes=-1 if threshold is None
                         else threshold)
    thvd.init(device="cpu", config=cfg)
    try:
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(8, 16),
                                    torch.nn.Linear(16, 4))
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1))
        assert len(opt.buckets) == want
        tops.allreduce_async_.launches = 0
        for _ in range(2):
            opt.zero_grad()
            model(torch.randn(4, 8)).square().sum().backward()
            opt.step()
        assert tops.allreduce_async_.launches == 2 * want
    finally:
        thvd.shutdown()


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.llama import Llama, llama_tiny
    from horovod_tpu_torch.train import (create_train_state, make_train_step,
                                         next_token_loss)

    data_dir = sys.argv[1]
    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()
    data = np.load(f"{data_dir}/init.npz")
    model = Llama(llama_tiny(), device="cpu", seed=rank)
    if rank == 0:  # the others keep their own seed: the broadcast fixes them
        model.load_state_dict({k: torch.from_numpy(data[k])
                               for k in data.files if k != "tokens"})
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, next_token_loss)
    tokens = torch.from_numpy(data["tokens"])
    per = tokens.shape[0] // size
    shard = tokens[rank * per:(rank + 1) * per]
    losses = []
    for _ in range(2):
        state, loss = step(state, shard, shard)
        losses.append(loss.item())
    x = torch.tensor([rank + 1.0])
    ps = hvd.add_process_set([0, 1])
    ops = [hvd.allreduce(x, op, process_set=ps).item()
           for op in (hvd.Sum, hvd.Average, hvd.Min, hvd.Max, hvd.Product)]
    ops.append(hvd.broadcast(x, 1).item())
    out = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    np.savez(f"{data_dir}/rank{rank}.npz", losses=np.asarray(losses),
             ops=np.asarray(ops),
             layout=np.asarray([rank, size, hvd.local_rank(),
                                hvd.local_size(), hvd.cross_rank(),
                                hvd.cross_size()]), **out)
    hvd.shutdown()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_adamw_steps_match_jax_mesh(tmp_path):
    cfg = jllama.llama_tiny()
    model = jllama.Llama(cfg)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (8, 16))
    dopt = distributed(optax.adamw(1e-4))
    state = create_train_state(model, jax.random.PRNGKey(0),
                               jnp.asarray(tokens[:1]), dopt)
    tcfg = tllama.llama_tiny()
    init = convert.llama_params_from_flax(state.params, tcfg)
    np.savez(tmp_path / "init.npz", tokens=tokens,
             **{k: v.numpy() for k, v in init.items()})

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, HOROVOD_NUM_PROCESSES="2",
               HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}")
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp_path)],
        env=dict(env, HOROVOD_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]

    step = make_train_step(model, dopt,
                           lambda logits, y: j_next_token_loss(logits, y))
    jlosses = []
    for _ in range(2):
        state, loss = step(state, jnp.asarray(tokens), jnp.asarray(tokens))
        jlosses.append(float(loss))
    want = convert.llama_params_from_flax(state.params, tcfg)

    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert list(got["layout"]) == [r, 2, r, 2, 0, 1]
        # Sum, Average, Min, Max, Product of [1, 2] over a process set, and
        # a broadcast from rank 1.
        assert list(got["ops"]) == [3.0, 1.5, 1.0, 2.0, 2.0, 2.0]
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def _grads_after(opt_kwargs, passes, seed=0):
    """Gradients a one-rank gloo world's DistributedOptimizer leaves on a
    small model after ``passes`` backward passes, beside the plain sum of
    the same passes' gradients."""
    torch.manual_seed(seed)
    model = torch.nn.Linear(8, 3)
    xs = [torch.randn(4, 8) for _ in range(passes)]
    plain = [torch.zeros_like(p) for p in model.parameters()]
    for x in xs:
        g = torch.autograd.grad(model(x).square().sum(), model.parameters())
        plain = [a + b for a, b in zip(plain, g)]
    thvd.init(device="cpu")
    try:
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.0), **opt_kwargs)
        for x in xs:
            model(x).square().sum().backward()
        opt.synchronize()
        return [p.grad.clone() for p in model.parameters()], plain
    finally:
        thvd.shutdown()


@pytest.mark.parametrize("opt_kwargs, passes, factor", [
    ({}, 1, 1.0),
    ({"backward_passes_per_step": 2}, 2, 0.5),
    ({"gradient_predivide_factor": 4.0}, 1, 1.0),
    ({"compression": thvd.Compression.bf16}, 1, 1.0),
    ({"op": thvd.Sum}, 1, 1.0),
    ({"op": thvd.Adasum}, 1, 1.0),
    ({"op": thvd.Adasum, "backward_passes_per_step": 2}, 2, 0.5),
])
def test_optimizer_reduction_options_in_a_world_of_one(opt_kwargs, passes,
                                                       factor):
    """Each option's algebra in a world of one, where the reduced gradient
    must be the local one: k local passes divided by k, the predivide split
    netting an average, bf16 on the wire rounding to within 2^-8, and Adasum
    of one contribution being that contribution."""
    got, plain = _grads_after(opt_kwargs, passes)
    tol = 2 ** -8 if "compression" in opt_kwargs else 1e-6
    for g, p in zip(got, plain):
        torch.testing.assert_close(g, p * factor, rtol=tol, atol=tol)


@pytest.mark.parametrize("op", [thvd.Average, thvd.Adasum])
def test_optimizer_is_freed_with_its_last_reference(op):
    """The gradient hooks hold the optimizer weakly: once the caller drops
    it, its state and parameters go (a 1.5 B-parameter model's AdamW state
    is 12 GB), and a later backward is not reduced by it."""
    thvd.init(device="cpu")
    try:
        model = torch.nn.Linear(8, 3)
        opt = thvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=0.1), op=op)
        model(torch.randn(4, 8)).sum().backward()
        opt.step()
        ref = weakref.ref(opt)
        del opt
        gc.collect()
        assert ref() is None
        model(torch.randn(4, 8)).sum().backward()  # the dead hook is inert
    finally:
        thvd.shutdown()


@pytest.mark.parametrize("op", [thvd.Average, thvd.Adasum])
def test_zero_grad_between_backward_and_step_raises(op):
    """Gradients that are complete but not yet reduced (an all-reduce in
    flight, or Adasum's one bucket ready) must not be dropped."""
    thvd.init(device="cpu")
    try:
        model = torch.nn.Linear(8, 3)
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1), op=op)
        opt.zero_grad()
        model(torch.randn(4, 8)).sum().backward()
        with pytest.raises(AssertionError, match="zero_grad"):
            opt.zero_grad()
        opt.step()
        opt.zero_grad()
    finally:
        thvd.shutdown()


def test_adamw_weight_decay_matches_optax_only_when_set():
    """``optax.adamw``'s default weight decay is 1e-4 and ``torch.optim.
    AdamW``'s 1e-2: the port's recipes set 1e-4 explicitly. One step at a
    large learning rate, where the decay term shows."""
    rng = np.random.RandomState(9)
    p0 = rng.randn(64).astype(np.float32)
    g = rng.randn(64).astype(np.float32)
    tx = optax.adamw(0.1)
    upd, _ = tx.update(jnp.asarray(g), tx.init(jnp.asarray(p0)),
                       jnp.asarray(p0))
    want = np.asarray(optax.apply_updates(jnp.asarray(p0), upd))

    def torch_step(**kw):
        p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = torch.optim.AdamW([p], lr=0.1, **kw)
        p.grad = torch.from_numpy(g)
        opt.step()
        return p.detach().numpy()

    np.testing.assert_allclose(torch_step(weight_decay=1e-4), want,
                               rtol=1e-6, atol=1e-6)
    assert np.abs(torch_step() - want).max() > 1e-4
