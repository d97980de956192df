"""The port's data-parallel machinery against the JAX package's, on the CPU.

- ``Config.from_env`` field parity under one environment;
- the gradient bucket count against the ``buckets`` field of the JAX
  ``collective_issue`` telemetry event, for the same tree and threshold;
- one all-reduce launched per bucket at each optimizer step;
- two AdamW steps of the port in a 2-process gloo world against
  ``make_train_step`` on the 8-device CPU mesh, same global batch: the
  parameters agree within 1e-5 (and the world's reduce ops and broadcast
  give exact answers);
- the optimizer's reduction options in a world of one;
- in the same world, two SGD-momentum steps of ``ResNetTiny`` with
  SyncBatchNorm against the mesh: parameters and running statistics within
  1e-5;
- ``accum_steps``: the plain step's update with one all-reduce per bucket,
  BatchNorm statistics threaded through the microbatches as the JAX
  package's ``accumulate_gradients`` threads them, and the reference's
  "per-device" error for a batch it does not divide.
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
from horovod_tpu.models import resnet as jresnet
from horovod_tpu.optimizer import distributed
from horovod_tpu.train import create_train_state, make_train_step
from horovod_tpu.train.gspmd import next_token_loss as j_next_token_loss

import horovod_tpu_torch as thvd
from horovod_tpu_torch import convert
from horovod_tpu_torch.collectives import ops as tops
from horovod_tpu_torch.core import config as tconfig
from horovod_tpu_torch import train as thvd_train
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.models import resnet as tresnet

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
    from horovod_tpu_torch.models.resnet import ResNetTiny
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

    # ResNetTiny with SyncBatchNorm, two SGD-momentum steps.
    data = np.load(f"{data_dir}/resnet_init.npz")
    model = ResNetTiny(num_classes=10, dtype=torch.float32,
                       sync_batch_norm=True, device="cpu", seed=rank)
    if rank == 0:
        model.load_state_dict({k: torch.from_numpy(data[k])
                               for k in data.files
                               if k not in ("images", "labels")})
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, torch.nn.functional.cross_entropy)
    per = data["images"].shape[0] // size
    own = slice(rank * per, (rank + 1) * per)
    images = torch.from_numpy(data["images"][own])
    labels = torch.from_numpy(data["labels"][own])
    losses = []
    for _ in range(2):
        state, loss = step(state, images, labels)
        losses.append(loss.item())
    out = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    np.savez(f"{data_dir}/resnet_rank{rank}.npz", losses=np.asarray(losses),
             **out)
    hvd.shutdown()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_resnet_steps(tmp_path):
    """``ResNetTiny`` with SyncBatchNorm (``axis_name`` the rank axis), two
    steps of ``make_train_step`` with SGD and momentum on the 8-device mesh;
    writes the initial variables and the batch for the port's world and
    returns the final variables and the losses."""
    model = jresnet.ResNetTiny(num_classes=10, dtype=jnp.float32,
                               axis_name=hvd.RANK_AXIS)
    rng = np.random.RandomState(5)
    images = rng.randn(16, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, 16)
    dopt = distributed(optax.sgd(0.1, momentum=0.9))
    state = create_train_state(model, jax.random.PRNGKey(0),
                               jnp.asarray(images[:1]), dopt)
    init = convert.resnet_params_from_flax(
        {"params": state.params, "batch_stats": state.batch_stats})
    np.savez(tmp_path / "resnet_init.npz", images=images, labels=labels,
             **{k: v.numpy() for k, v in init.items()})

    def xent(logits, y):
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    step = make_train_step(model, dopt, xent)
    losses = []
    for _ in range(2):
        state, loss = step(state, jnp.asarray(images), jnp.asarray(labels))
        losses.append(float(loss))
    return {"params": state.params, "batch_stats": state.batch_stats}, losses


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One 2-process gloo world for the module: two AdamW steps of
    ``llama_tiny``, then two SGD steps of ``ResNetTiny`` with SyncBatchNorm,
    each rank on its half of the global batch; the JAX package runs the same
    steps on the 8-device mesh meanwhile. Returns both sides' results."""
    tmp_path = tmp_path_factory.mktemp("dp_world")
    # A module fixture runs before conftest's per-test context: make one.
    hvd.shutdown()
    hvd.init()
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
    want_resnet, resnet_losses = _jax_resnet_steps(tmp_path)

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

    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=180)
        outs.append((p.returncode, out))
    return {"dir": tmp_path, "outs": outs, "llama": (want, jlosses),
            "resnet": (want_resnet, resnet_losses)}


def test_two_adamw_steps_match_jax_mesh(world):
    for rc, out in world["outs"]:
        assert rc == 0, out
    want, jlosses = world["llama"]
    for r in range(2):
        got = np.load(world["dir"] / f"rank{r}.npz")
        assert list(got["layout"]) == [r, 2, r, 2, 0, 1]
        # Sum, Average, Min, Max, Product of [1, 2] over a process set, and
        # a broadcast from rank 1.
        assert list(got["ops"]) == [3.0, 1.5, 1.0, 2.0, 2.0, 2.0]
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def test_two_sgd_steps_with_sync_batch_norm_match_jax_mesh(world):
    """``ResNetTiny`` with SyncBatchNorm across 2 ranks against
    ``make_train_step`` on the 8-device mesh: parameters and the running
    statistics (averaged across the ranks after the update, as the JAX
    step averages its ``batch_stats``) within 1e-5 after two steps, and the
    ranks bit-identical."""
    for rc, out in world["outs"]:
        assert rc == 0, out
    variables, jlosses = world["resnet"]
    want = convert.resnet_params_from_flax(variables)
    got = [np.load(world["dir"] / f"resnet_rank{r}.npz") for r in range(2)]
    for name, w in want.items():
        np.testing.assert_array_equal(got[1][name], got[0][name],
                                      err_msg=name)
        np.testing.assert_allclose(got[0][name], w.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(got[0]["losses"], jlosses, rtol=1e-5)


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


def _mlp_step(accum_steps, batch=16, seed=0):
    """One DistributedOptimizer(SGD) step of a small MLP in a world of one,
    plain or with ``accum_steps`` microbatches; returns the loss, the
    parameters, the bucket count and the all-reduces launched."""
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(12, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 5))
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(batch, 12).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 5, batch))
    thvd.init(device="cpu")
    try:
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            backward_passes_per_step=accum_steps or 1)
        step = thvd_train.make_train_step(
            model, opt, torch.nn.functional.cross_entropy,
            accum_steps=accum_steps)
        tops.allreduce_async_.launches = 0
        _, loss = step(thvd_train.create_train_state(model, opt), x, y)
        return (loss.item(), [p.detach().clone() for p in model.parameters()],
                len(opt.buckets), tops.allreduce_async_.launches)
    finally:
        thvd.shutdown()


def test_accum_step_matches_plain_and_keeps_one_allreduce_per_bucket():
    """``accum_steps=2`` gives the plain step's update (the mean of the
    microbatches' mean losses is the batch's mean loss) and launches one
    all-reduce per bucket, as many as the plain step: nothing crosses ranks
    inside the microbatch loop (the JAX package's ``dp-step-accum``
    claim)."""
    l1, p1, buckets, n1 = _mlp_step(None)
    l2, p2, _, n2 = _mlp_step(2)
    assert n1 == n2 == buckets
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_accum_step_rejects_indivisible_local_batch():
    with pytest.raises(ValueError, match="per-device"):
        _mlp_step(3, batch=16)


def test_accum_step_needs_as_many_backward_passes_per_step():
    thvd.init(device="cpu")
    try:
        model = torch.nn.Linear(4, 2)
        opt = thvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                        lr=0.1))
        with pytest.raises(ValueError, match="backward_passes_per_step=2"):
            thvd_train.make_train_step(
                model, opt, torch.nn.functional.mse_loss, accum_steps=2)
    finally:
        thvd.shutdown()


def test_accum_step_threads_batch_norm_statistics_like_jax():
    """``ResNetTiny`` with ``accum_steps=2`` in a world of one against the
    JAX package's ``accumulate_gradients`` and one SGD step: the running
    statistics move once a microbatch, in order, and the update is that of
    the mean gradient, within 1e-5."""
    from horovod_tpu.train.step_builder import accumulate_gradients
    jmodel = jresnet.ResNetTiny(num_classes=10, dtype=jnp.float32)
    rng = np.random.RandomState(6)
    images = rng.randn(8, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, 8)
    v = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(images[:1]),
                    train=False)

    def vg_fn(params, stats, x, y):
        out, mut = jmodel.apply({"params": params, "batch_stats": stats}, x,
                                train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(out, y).mean()
        return loss, mut["batch_stats"]

    (loss, stats), grads = accumulate_gradients(
        jax.value_and_grad(vg_fn, has_aux=True), v["params"],
        v["batch_stats"], (jnp.asarray(images), jnp.asarray(labels)), 2)
    params = jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, v["params"],
                                    grads)
    want = convert.resnet_params_from_flax({"params": params,
                                            "batch_stats": stats})

    model = tresnet.ResNetTiny(num_classes=10, dtype=torch.float32,
                               device="cpu")
    model.load_state_dict(convert.resnet_params_from_flax(v))
    thvd.init(device="cpu")
    try:
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            backward_passes_per_step=2)
        step = thvd_train.make_train_step(
            model, opt, torch.nn.functional.cross_entropy, accum_steps=2)
        _, tloss = step(thvd_train.create_train_state(model, opt),
                        torch.from_numpy(images), torch.from_numpy(labels))
    finally:
        thvd.shutdown()
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    for name, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
