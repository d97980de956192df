"""Pipeline parallelism in the port against the JAX package, on the CPU.

One 4-process gloo world for the module runs the cases of
``tests/test_parallel.py`` (pipeline section) and
``tests/test_step_builder.py`` (pipeline matrix) on a ``{"pp": 4}`` mesh,
each rank holding one stage (JAX stacks the four and splits them over
``pp`` with ``shard_map``):

- :func:`pipeline` forward of affine-tanh stages against their
  sequential composition (rtol 2e-4, atol 2e-5);
- GPipe's gradients (``pipeline_value_and_grad``) and 1F1B's
  (``pipeline_1f1b_value_and_grad``, M = 40 > 2 (n - 1) + 1, so its input
  ring wraps) against ``jax.value_and_grad`` of the sequential
  composition (loss rtol 1e-4; gradients rtol 2e-4 / 3e-4, atol 1e-5);
- eight GPipe SGD steps whose loss falls every step;
- one ``make_pipeline_train_step`` step of each schedule, and of GPipe on
  ``{"dp": 2, "pp": 2}``, against JAX's ``make_pipeline_train_step`` on
  the same mesh of ``jax.devices()[:4]`` (loss rtol 1e-4, parameters rtol
  2e-4 / atol 1e-5, JAX's tolerances), and a second step that lowers the
  loss;
- ``pair=deferred_pair(every=2)`` with GPipe and 1F1B on ``{"pp": 4}``,
  each stage ``tanh(tanh(x @ dense) @ mlp)`` with ``mlp`` deferred, four
  steps against JAX's ``make_pipeline_train_step(pair=...)``; on the skip
  steps ``mlp`` takes no gradient and stays bit-unchanged;
- the schedule ``ValueError`` s, and ``pair=`` with an optimizer not built
  from ``pair.apply``, in process.
"""

import json
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

from horovod_tpu.parallel import create_mesh as jcreate_mesh
from horovod_tpu.train import (create_pipeline_train_state as
                               jcreate_pipeline_train_state)
from horovod_tpu.train import (make_pipeline_train_step as
                               jmake_pipeline_train_step)

import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.parallel import create_mesh
from horovod_tpu_torch.train import make_pipeline_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
STEP_CASES = [("interleaved", None), ("gpipe", None), ("gpipe", 2)]

_WORKER = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import (create_mesh, pipeline,
                                            pipeline_1f1b_value_and_grad,
                                            pipeline_value_and_grad)
    from horovod_tpu_torch.train import (create_pipeline_train_state,
                                         make_pipeline_train_step)

    data_dir = sys.argv[1]
    hvd.init(device="cpu")
    rank = hvd.rank()
    d = {k: torch.from_numpy(v) for k, v in
         np.load(f"{data_dir}/inputs.npz").items()}
    mse = lambda y, t: ((y - t) ** 2).mean()
    tanh_stage = lambda W, x: torch.tanh(x @ W)
    out = {}
    pp = create_mesh({"pp": 4}).axis("pp")
    i = pp.index

    with torch.no_grad():
        y = pipeline(lambda p, x: torch.tanh(x @ p[0] + p[1]),
                     (d["fwd_W"][i], d["fwd_b"][i]), d["fwd_x"], pp)
    out["fwd"] = y.tolist()

    W = d["grad_W"][i].clone().requires_grad_()
    vg = pipeline_value_and_grad(tanh_stage, mse, pp)
    loss, (g,) = vg(W, d["grad_x"], d["grad_t"])
    out["gpipe"] = [loss.item(), g.tolist()]

    W = d["f1b_W"][i].clone().requires_grad_()
    vg = pipeline_1f1b_value_and_grad(tanh_stage, mse, pp)
    loss, (g,) = vg(W, d["f1b_x"], d["f1b_t"])
    out["1f1b"] = [loss.item(), g.tolist()]

    W = d["train_W"][i].clone().requires_grad_()
    vg = pipeline_value_and_grad(tanh_stage, mse, pp)
    losses = []
    for _ in range(8):
        loss, (g,) = vg(W, d["train_x"], d["train_t"])
        with torch.no_grad():
            W -= 2.0 * g
        losses.append(loss.item())
    out["train"] = losses

    for schedule, dp in json.loads(sys.argv[2]):
        axes = {"pp": 4} if dp is None else {"dp": dp, "pp": 4 // dp}
        mesh = create_mesh(axes)
        n = 4 // (dp or 1)
        W = torch.nn.Parameter(d[f"step{n}_W"][mesh.axis("pp").index].clone())
        x, t = d["step_x"], d["step_t"]
        if dp:
            j, w = mesh.axis("dp").index, x.shape[1] // dp
            x, t = x[:, j * w:(j + 1) * w], t[:, j * w:(j + 1) * w]
        opt = torch.optim.SGD([W], lr=0.1)
        state = create_pipeline_train_state(W, opt)
        step = make_pipeline_train_step(
            tanh_stage, mse, opt, mesh=mesh, schedule=schedule,
            dp_axis_name="dp" if dp else None)
        state, loss = step(state, x, t)
        first = W.detach().clone()
        state, loss2 = step(state, x, t)
        out[f"step-{schedule}-{dp}"] = [loss.item(), loss2.item(),
                                        state.step, mesh.axis("pp").index,
                                        first.tolist()]
    from horovod_tpu_torch.optimizer import deferred_pair, optimizer_for
    for schedule in ("gpipe", "1f1b"):
        mesh = create_mesh({"pp": 4})
        i = mesh.axis("pp").index
        stage = torch.nn.Module()
        stage.dense = torch.nn.Parameter(d["pair_dense"][i].clone())
        stage.mlp = torch.nn.Parameter(d["pair_mlp"][i].clone())
        pair = deferred_pair(1e-2, every=2,
                             is_expert=lambda n: n.startswith("mlp"))
        opt = optimizer_for(pair.apply, stage.named_parameters())
        state = create_pipeline_train_state(stage, opt)
        step = make_pipeline_train_step(
            lambda m, x: torch.tanh(torch.tanh(x @ m.dense) @ m.mlp), mse,
            opt, mesh=mesh, schedule=schedule, pair=pair)
        losses, frozen_kept, moved = [], True, True
        for k in range(4):
            before = stage.mlp.detach().clone()
            state, loss = step(state, d["step_x"], d["step_t"])
            losses.append(loss.item())
            if (k + 1) % 2:  # a skip step
                frozen_kept &= (stage.mlp.grad is None
                                and torch.equal(stage.mlp, before))
            else:
                moved &= not torch.equal(stage.mlp, before)
        out[f"pair-{schedule}"] = [losses, frozen_kept, moved, i,
                                   stage.dense.detach().tolist(),
                                   stage.mlp.detach().tolist()]
    with open(f"{data_dir}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    hvd.shutdown()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs():
    """The seeded inputs of the JAX package's pipeline tests."""
    d = {}
    rng = np.random.RandomState(5)
    d["fwd_W"] = rng.randn(N, 4, 4).astype(np.float32) * 0.3
    d["fwd_b"] = rng.randn(N, 4).astype(np.float32) * 0.1
    d["fwd_x"] = rng.randn(6, 3, 4).astype(np.float32)
    rng = np.random.RandomState(6)
    d["grad_W"] = rng.randn(N, 3, 3).astype(np.float32) * 0.4
    d["grad_x"] = rng.randn(5, 2, 3).astype(np.float32)
    d["grad_t"] = rng.randn(5, 2, 3).astype(np.float32)
    rng = np.random.RandomState(11)
    d["f1b_W"] = rng.randn(N, 3, 3).astype(np.float32) * 0.4
    d["f1b_x"] = rng.randn(40, 2, 3).astype(np.float32)
    d["f1b_t"] = rng.randn(40, 2, 3).astype(np.float32)
    rng = np.random.RandomState(7)
    d["train_W"] = rng.randn(N, 4, 4).astype(np.float32) * 0.3
    d["train_x"] = rng.randn(6, 2, 4).astype(np.float32)
    d["train_t"] = rng.randn(6, 2, 4).astype(np.float32)
    rng = np.random.RandomState(8)
    d["pair_dense"] = rng.randn(N, 3, 3).astype(np.float32) * 0.4
    d["pair_mlp"] = rng.randn(N, 3, 3).astype(np.float32) * 0.4
    for n in (4, 2):  # tests/test_step_builder.py::_pipeline_parts
        rng = np.random.RandomState(7)
        d[f"step{n}_W"] = rng.randn(n, 3, 3).astype(np.float32) * 0.4
        d["step_x"] = rng.randn(40, 4, 3).astype(np.float32)
        d["step_t"] = rng.randn(40, 4, 3).astype(np.float32)
    return d


def _seq(Ws, xs, ts, per_microbatch):
    h = xs
    for s in range(Ws.shape[0]):
        h = jnp.tanh(h @ Ws[s])
    if per_microbatch:
        return jnp.mean((h - ts) ** 2, axis=(1, 2)).mean()
    return jnp.mean((h - ts) ** 2)


def _jax_step(d, schedule, dp):
    """One step of JAX's ``make_pipeline_train_step`` on the same mesh:
    the loss and the stacked stage parameters after it."""
    n = N // (dp or 1)
    axes = {"pp": n} if dp is None else {"dp": dp, "pp": n}
    mesh = jcreate_mesh(axes, devices=jax.devices()[:N])
    opt = optax.sgd(0.1)
    Ws = jnp.asarray(d[f"step{n}_W"])
    state = jcreate_pipeline_train_state(Ws, opt)
    step = jmake_pipeline_train_step(
        lambda W, x: jnp.tanh(x @ W), lambda y, t: jnp.mean((y - t) ** 2),
        opt, mesh=mesh, schedule=schedule,
        dp_axis_name="dp" if dp else None, donate=False)
    state, loss = step(state, jnp.asarray(d["step_x"]),
                       jnp.asarray(d["step_t"]))
    return float(loss), np.asarray(state.stage_params)


def _jax_pair_steps(d, schedule):
    """Four steps of JAX's ``make_pipeline_train_step(pair=deferred_pair(
    every=2))`` on ``{"pp": 4}`` with stages ``tanh(tanh(x @ dense) @
    mlp)``, ``mlp`` the deferred group: the losses and the stacked stage
    parameters after them."""
    from horovod_tpu.optimizer import deferred_pair as jdeferred_pair
    mesh = jcreate_mesh({"pp": N}, devices=jax.devices()[:N])
    pair = jdeferred_pair(1e-2, every=2,
                          is_expert=lambda p: p.startswith("mlp"))
    params = {"dense": jnp.asarray(d["pair_dense"]),
              "mlp": jnp.asarray(d["pair_mlp"])}
    state = jcreate_pipeline_train_state(params, pair.apply)
    step = jmake_pipeline_train_step(
        lambda p, x: jnp.tanh(jnp.tanh(x @ p["dense"]) @ p["mlp"]),
        lambda y, t: jnp.mean((y - t) ** 2), pair.apply, mesh=mesh,
        schedule=schedule, donate=False, pair=pair)
    losses = []
    for _ in range(4):
        state, loss = step(state, jnp.asarray(d["step_x"]),
                           jnp.asarray(d["step_t"]))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in state.stage_params.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline_world")
    d = _inputs()
    np.savez(tmp / "inputs.npz", **d)
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO, HOROVOD_NUM_PROCESSES=str(N),
               HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp), json.dumps(STEP_CASES)],
        env=dict(env, HOROVOD_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(N)]
    want = {f"{s}-{dp}": _jax_step(d, s, dp) for s, dp in STEP_CASES}
    want.update({f"pair-{s}": _jax_pair_steps(d, j)
                 for s, j in (("gpipe", "gpipe"), ("1f1b", "interleaved"))})
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, _) in zip(procs, outs):
        assert p.returncode == 0, out
    ranks = []
    for r in range(N):
        with open(tmp / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    return d, ranks, want


def test_pipeline_matches_sequential(world):
    d, ranks, _ = world
    ref = d["fwd_x"]
    for s in range(N):
        ref = np.tanh(ref @ d["fwd_W"][s] + d["fwd_b"][s])
    np.testing.assert_allclose(ranks[N - 1]["fwd"], ref, rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_grads_match_sequential(world, schedule):
    d, ranks, _ = world
    key = "grad" if schedule == "gpipe" else "f1b"
    ref_loss, ref_grads = jax.value_and_grad(_seq)(
        jnp.asarray(d[f"{key}_W"]), jnp.asarray(d[f"{key}_x"]),
        jnp.asarray(d[f"{key}_t"]), schedule == "1f1b")
    rtol = 2e-4 if schedule == "gpipe" else 3e-4
    for i, r in enumerate(ranks):
        loss, g = r[schedule]
        np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-4)
        np.testing.assert_allclose(g, np.asarray(ref_grads)[i], rtol=rtol,
                                   atol=1e-5)


def test_pipeline_training_loss_decreases(world):
    _, ranks, _ = world
    losses = np.asarray(ranks[0]["train"])
    assert np.all(np.diff(losses) < 0), losses
    for r in ranks[1:]:
        assert r["train"] == ranks[0]["train"]  # replicated over pp


@pytest.mark.parametrize("schedule,dp", STEP_CASES)
def test_pipeline_step_matches_jax(world, schedule, dp):
    _, ranks, want = world
    key = f"{schedule}-{dp}"
    jloss, jparams = want[key]
    for r in ranks:
        loss, loss2, step, stage, W = r[f"step-{key}"]
        assert step == 2
        np.testing.assert_allclose(loss, jloss, rtol=1e-4)
        np.testing.assert_allclose(W, jparams[stage], rtol=2e-4, atol=1e-5)
        assert loss2 < loss


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pair_cadence_matches_jax(world, schedule):
    """``pair=deferred_pair(every=2)`` naming each stage's ``mlp``: four
    steps against JAX's apply and skip programs (loss rtol 1e-4,
    parameters rtol 2e-4 / atol 1e-5, the step tolerances above); on the
    skip steps ``mlp`` takes no gradient and stays bit-unchanged, on the
    apply steps it moves."""
    _, ranks, want = world
    jlosses, jparams = want[f"pair-{schedule}"]
    for r in ranks:
        losses, frozen_kept, moved, stage, dense, mlp = r[f"pair-{schedule}"]
        assert frozen_kept and moved
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
        np.testing.assert_allclose(dense, jparams["dense"][stage],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(mlp, jparams["mlp"][stage], rtol=2e-4,
                                   atol=1e-5)


def test_pipeline_schedule_validation():
    thvd.init(device="cpu")
    try:
        mesh = create_mesh({"dp": 1, "pp": 1})
        with pytest.raises(ValueError, match="dp seam"):
            make_pipeline_train_step(lambda W, x: x, lambda y, t: y.mean(),
                                     None, mesh=mesh, schedule="interleaved",
                                     dp_axis_name="dp")
        with pytest.raises(ValueError, match="unknown schedule"):
            make_pipeline_train_step(lambda W, x: x, lambda y, t: y.mean(),
                                     None, mesh=mesh, schedule="zigzag")
        # pair= takes an optimizer built from pair.apply
        from horovod_tpu_torch.optimizer import deferred_pair
        from horovod_tpu_torch.train import create_pipeline_train_state
        W = torch.nn.Parameter(torch.ones(2, 2))
        opt = torch.optim.SGD([W], lr=0.1)
        step = make_pipeline_train_step(
            lambda W, x: x @ W, lambda y, t: y.mean(), opt, mesh=mesh,
            schedule="gpipe", pair=deferred_pair(1e-3, every=2))
        with pytest.raises(ValueError, match="not built from pair.apply"):
            step(create_pipeline_train_state(W, opt), torch.ones(2, 1, 2),
                 torch.ones(2, 1, 2))
    finally:
        thvd.shutdown()
