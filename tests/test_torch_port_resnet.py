"""The port's ResNet and SyncBatchNorm against the JAX package's, on the CPU.

Flax parameters and batch statistics are carried across by
``horovod_tpu_torch.convert``; the same images and labels, made from a seed
with numpy, go through both models, in f32.

- Logits, the loss, every parameter's gradient and the updated running
  statistics, per element within ``1e-4 * |flax| + 1e-5`` (summation order
  only; the BN statistics pass the differences on), for ``ResNetTiny`` and
  for a bottleneck ResNet at ``stage_sizes=[1, 1]``, width 8, on 32x32
  images with the ``conv7`` stem and with ``space_to_depth``. Those cases
  reach every asymmetric "SAME" padding (the stride-2 3x3 convs and the
  max-pool) and the space-to-depth channel order.
- ``SyncBatchNorm`` in a 2-process gloo world against ``horovod_tpu.
  optimizer.SyncBatchNorm`` under ``shard_map`` on the 8-device mesh, on the
  same global batch: outputs, running mean and variance, input gradients
  and the parameters' gradients summed over the ranks, within 1e-5. The
  global statistics do not depend on how many ranks share the batch, so 2
  ranks against 8 devices is a fair comparison; a backward that summed the
  statistics' cotangent instead of averaging it would be off by the world
  size.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu.models import resnet as jresnet
from horovod_tpu.optimizer import SyncBatchNorm as JSyncBatchNorm
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import resnet as tresnet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (JAX model, port model) factories of each case, f32, 10 classes.
CASES = {
    "tiny": (lambda: jresnet.ResNetTiny(num_classes=10, dtype=jnp.float32),
             lambda **kw: tresnet.ResNetTiny(num_classes=10,
                                             dtype=torch.float32, **kw)),
    "bottleneck-conv7": (
        lambda: jresnet.ResNet(stage_sizes=[1, 1],
                               block_cls=jresnet.BottleneckResNetBlock,
                               width=8, num_classes=10, dtype=jnp.float32),
        lambda **kw: tresnet.ResNet(stage_sizes=[1, 1],
                                    block_cls=tresnet.BottleneckResNetBlock,
                                    width=8, num_classes=10,
                                    dtype=torch.float32, **kw)),
    "bottleneck-s2d": (
        lambda: jresnet.ResNet(stage_sizes=[1, 1],
                               block_cls=jresnet.BottleneckResNetBlock,
                               width=8, num_classes=10, dtype=jnp.float32,
                               stem="space_to_depth"),
        lambda **kw: tresnet.ResNet(stage_sizes=[1, 1],
                                    block_cls=tresnet.BottleneckResNetBlock,
                                    width=8, num_classes=10,
                                    dtype=torch.float32,
                                    stem="space_to_depth", **kw)),
}


def _close(what, got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _data(seed=0, n=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, n))


def _variables(jmodel, x, seed=1):
    """Initial flax variables with every leaf moved off its init value (a
    zero BN scale or a unit variance would hide a misplaced tensor)."""
    v = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    rng = np.random.RandomState(seed)

    def nudge(path, a):
        a = np.asarray(a)
        if path[-1].key == "var":
            return jnp.asarray(a + rng.rand(*a.shape).astype(a.dtype))
        return jnp.asarray(a + 0.1 * rng.randn(*a.shape).astype(a.dtype))
    return jax.tree_util.tree_map_with_path(nudge, v)


def _port(case, variables, **kw):
    model = CASES[case][1](device="cpu", **kw)
    model.load_state_dict(convert.resnet_params_from_flax(variables))
    return model


def _jax_train(jmodel, variables, x, y):
    """Loss, logits, parameter gradients and updated batch_stats of one
    training-mode forward and backward."""
    def loss_fn(params):
        out, mut = jmodel.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            out, jnp.asarray(y)).mean()
        return loss, (out, mut["batch_stats"])
    (loss, (out, stats)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])
    return loss, out, grads, stats


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_gradients_and_stats_match_flax(case):
    jmodel = CASES[case][0]()
    x, y = _data()
    v = _variables(jmodel, x)
    loss, out, grads, stats = _jax_train(jmodel, v, x, y)
    model = _port(case, v)
    logits = model(torch.from_numpy(x))
    assert logits.dtype == torch.float32
    tloss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    tloss.backward()
    _close("logits", logits.detach().numpy(), out)
    _close("loss", tloss.item(), float(loss), rtol=1e-5, atol=1e-6)
    want = convert.resnet_params_from_flax({"params": grads})
    for name, p in model.named_parameters():
        _close(f"grad {name}", p.grad.numpy(), want[name].numpy())
    want = convert.resnet_params_from_flax({"params": v["params"],
                                            "batch_stats": stats})
    for name, b in model.named_buffers():
        _close(name, b.numpy(), want[name].numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_mode_normalises_with_the_running_statistics(case):
    jmodel = CASES[case][0]()
    x, _ = _data(2)
    v = _variables(jmodel, x)
    want = jmodel.apply(v, jnp.asarray(x), train=False)
    model = _port(case, v).eval()
    before = {k: b.clone() for k, b in model.named_buffers()}
    with torch.no_grad():
        _close("eval logits", model(torch.from_numpy(x)).numpy(), want)
    for k, b in model.named_buffers():
        assert torch.equal(b, before[k]), k


def test_remat_blocks_recompute_without_moving_the_statistics_twice():
    """``remat_blocks`` gives the same logits, gradients and running
    statistics as the plain model: the recompute in backward leaves the
    statistics alone, and flax's ``Checkpoint`` block names convert."""
    jmodel = jresnet.ResNet(stage_sizes=[1, 1],
                            block_cls=jresnet.BottleneckResNetBlock, width=8,
                            num_classes=10, dtype=jnp.float32,
                            stem="space_to_depth", remat_blocks=True)
    x, y = _data(3)
    v = _variables(jmodel, x)
    loss, out, grads, stats = _jax_train(jmodel, v, x, y)
    model = _port("bottleneck-s2d", v, remat_blocks=True)
    logits = model(torch.from_numpy(x))
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(y)).backward()
    _close("logits", logits.detach().numpy(), out)
    want = convert.resnet_params_from_flax({"params": grads,
                                            "batch_stats": stats})
    for name, p in model.named_parameters():
        _close(f"grad {name}", p.grad.numpy(), want[name].numpy())
    for name, b in model.named_buffers():
        _close(name, b.numpy(), want[name].numpy())
    back = convert.resnet_params_to_flax(model.state_dict(), model)
    assert (jax.tree_util.tree_structure(back["params"])
            == jax.tree_util.tree_structure(v["params"]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_converters_round_trip(case):
    jmodel = CASES[case][0]()
    x, _ = _data()
    v = _variables(jmodel, x)
    model = _port(case, v)
    back = convert.resnet_params_to_flax(model.state_dict(), model)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(
                {"params": v["params"], "batch_stats": v["batch_stats"]}))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(
                        {"params": v["params"],
                         "batch_stats": v["batch_stats"]})):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("size, k, s, want", [
    (56, 3, 2, (0, 1)),    # stride-2 3x3 conv, 56 -> 28
    (28, 3, 2, (0, 1)),
    (14, 3, 2, (0, 1)),    # 14 -> 7
    (112, 3, 2, (0, 1)),   # the max-pool, 112 -> 56
    (56, 3, 1, (1, 1)),
    (56, 1, 2, (0, 0)),    # the stride-2 projection
    (7, 3, 2, (1, 1)),     # an odd size pads on both sides
])
def test_same_padding_matches_lax(size, k, s, want):
    assert tresnet._same_pads(size, k, s) == want
    assert tuple(jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]) \
        == want


def test_resnet50_has_the_reference_parameter_count():
    """ResNet-50 of both packages, counted from shapes alone: 25,557,032
    parameters (torchvision's count) and 53 BatchNorm layers."""
    model = tresnet.ResNet50(stem="space_to_depth", device="cpu")
    jmodel = jresnet.ResNet50(stem="space_to_depth")
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes["params"]))
    got = sum(p.numel() for p in model.parameters())
    assert got == want
    assert sum(1 for m in model.modules()
               if isinstance(m, tresnet.SyncBatchNorm)) == 53


# ------------------------------------------------- SyncBatchNorm, 2 ranks

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.collectives import ops

    data_dir = sys.argv[1]
    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()
    d = np.load(f"{data_dir}/syncbn.npz")
    per = d["x"].shape[0] // size
    own = slice(rank * per, (rank + 1) * per)
    bn = hvd.SyncBatchNorm(d["x"].shape[-1], device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(d["scale"]))
        bn.bias.copy_(torch.from_numpy(d["bias"]))
    # NHWC data, as the JAX side holds it; the module takes channels in dim 1.
    x = torch.from_numpy(d["x"][own]).permute(0, 3, 1, 2).requires_grad_()
    ct = torch.from_numpy(d["ct"][own]).permute(0, 3, 1, 2)
    ops.allreduce_async_.launches = 0
    y = bn(x)
    forward = ops.allreduce_async_.launches
    (y * ct).sum().backward()
    launches = [forward, ops.allreduce_async_.launches]
    out = {"y": y.detach().permute(0, 2, 3, 1).numpy(),
           "gx": x.grad.permute(0, 2, 3, 1).numpy(),
           "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy(),
           "gscale": hvd.allreduce(bn.weight.grad, hvd.Sum).numpy(),
           "gbias": hvd.allreduce(bn.bias.grad, hvd.Sum).numpy(),
           "launches": np.asarray(launches)}
    np.savez(f"{data_dir}/syncbn_rank{rank}.npz", **out)
    hvd.shutdown()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sync_batch_norm_across_two_ranks_matches_the_mesh(tmp_path):
    rng = np.random.RandomState(4)
    C = 6
    x = (rng.randn(16, 3, 3, C) * 2 + rng.randn(C)).astype(np.float32)
    x += np.arange(16, dtype=np.float32)[:, None, None, None] / 4
    ct = rng.randn(*x.shape).astype(np.float32)
    scale = (1 + 0.2 * rng.randn(C)).astype(np.float32)
    bias = (0.3 * rng.randn(C)).astype(np.float32)
    np.savez(tmp_path / "syncbn.npz", x=x, ct=ct, scale=scale, bias=bias)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO, HOROVOD_NUM_PROCESSES="2",
               HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp_path)],
        env=dict(env, HOROVOD_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]

    bn = JSyncBatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = bn.init(jax.random.PRNGKey(0), jnp.asarray(x[:2]))["batch_stats"]

    def body(xb, cb):
        def f(xl, p):
            yl, mut = bn.apply({"params": p, "batch_stats": stats}, xl,
                               mutable=["batch_stats"])
            return (yl * cb).sum(), (yl, mut["batch_stats"])
        (_, (yl, new)), (gx, gp) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(xb, params)
        gp = jax.lax.psum(gp, hvd.RANK_AXIS)
        return yl, gx, new, gp

    run = shard_map(body, mesh=hvd.mesh(),
                    in_specs=(P(hvd.RANK_AXIS), P(hvd.RANK_AXIS)),
                    out_specs=(P(hvd.RANK_AXIS), P(hvd.RANK_AXIS), P(), P()),
                    check_vma=False)
    y, gx, new, gp = jax.jit(run)(jnp.asarray(x), jnp.asarray(ct))

    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
    got = [np.load(tmp_path / f"syncbn_rank{r}.npz") for r in range(2)]
    tol = dict(rtol=1e-5, atol=1e-5)
    _close("output", np.concatenate([g["y"] for g in got]), y, **tol)
    _close("input grad", np.concatenate([g["gx"] for g in got]), gx, **tol)
    for g in got:
        _close("running mean", g["mean"], new["mean"], **tol)
        _close("running var", g["var"], new["var"], **tol)
        _close("scale grad", g["gscale"], gp["scale"], **tol)
        _close("bias grad", g["gbias"], gp["bias"], **tol)
        # One all-reduce of the stacked statistics forward, one of their
        # cotangent backward.
        assert g["launches"].tolist() == [1, 2]
