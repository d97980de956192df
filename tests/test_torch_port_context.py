"""Context-parallel Llama training in the port against the JAX package's
GSPMD step, on the CPU.

One 4-process gloo world for the module, a mesh of ``{"dp": 2, "sp": 2}``:
``llama_tiny`` with ``attention_impl`` "ring" and then "ulysses", weights
converted from the flax state by ``horovod_tpu_torch.convert``, three AdamW
steps (lr 1e-3, weight decay 1e-4) of ``make_gspmd_train_step`` on a
global batch of 2 x 32 seeded tokens, each rank on its [1, 16] shard.
Beside it the JAX package runs ``make_gspmd_train_step`` with
``optax.adamw(1e-3)`` on ``create_mesh({"dp": 2, "sp": 2},
devices=jax.devices()[:4])`` from the same state, as
``tests/test_models.py::train_losses`` does.

- the losses agree at rtol 3e-4, JAX's own tolerance for this comparison;
- every parameter after the three steps agrees within 1e-4 (absolute plus
  relative). Both sides are f32 and differ in summation order only, but
  AdamW's first update, lr g / (|g| + eps), moves a parameter by up to lr =
  1e-3 when its gradient is near zero, so a gradient that differs there in
  the last bits moves it differently (the note of the DP test in
  ``tests/test_torch_port_cuda.py``). The worst element here reads 8.1e-6;
- the ranks' parameters are bit-identical;
- an sp mesh with ``attention_impl=None`` raises, where XLA would gather
  K/V, and an unknown ``attention_impl`` raises on a mesh without sp.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import llama as jllama
from horovod_tpu.parallel import create_mesh as jcreate_mesh
from horovod_tpu.train import (create_gspmd_train_state,
                               make_gspmd_train_step)

import horovod_tpu_torch as thvd
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.parallel import create_mesh, set_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
IMPLS = ("ring", "ulysses")
STEPS = 3

_WORKER = textwrap.dedent("""
    import dataclasses
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.llama import Llama, llama_tiny
    from horovod_tpu_torch.parallel import create_mesh, set_mesh
    from horovod_tpu_torch.train import (create_train_state,
                                         make_gspmd_train_step, shard_tokens)

    data_dir = sys.argv[1]
    hvd.init(device="cpu")
    rank = hvd.rank()
    mesh = create_mesh({"dp": 2, "sp": 2})
    tokens = torch.from_numpy(np.load(f"{data_dir}/tokens.npy"))
    out = {}
    for impl in ("ring", "ulysses"):
        data = np.load(f"{data_dir}/init_{impl}.npz")
        cfg = dataclasses.replace(llama_tiny(), attention_impl=impl)
        model = Llama(cfg, device="cpu", seed=rank)
        if rank == 0:  # the broadcast makes the others equal
            model.load_state_dict({k: torch.from_numpy(data[k])
                                   for k in data.files})
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters())
        state = create_train_state(model, opt)
        step = make_gspmd_train_step(model, opt, mesh)
        shard = shard_tokens(tokens, mesh)
        losses = []
        for _ in range(3):
            state, loss = step(state, shard)
            losses.append(loss.item())
        out[f"{impl}-losses"] = np.asarray(losses)
        for k, v in model.state_dict().items():
            out[f"{impl}-{k}"] = v.numpy()
    dense = Llama(llama_tiny(), device="cpu")
    try:
        with set_mesh(mesh):
            dense(shard_tokens(tokens, mesh))
        out["dense_error"] = np.asarray("")
    except ValueError as e:
        out["dense_error"] = np.asarray(str(e))
    np.savez(f"{data_dir}/rank{rank}.npz", **out)
    hvd.shutdown()
""")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_train(impl, tokens, tmp):
    """Three GSPMD AdamW steps of ``llama_tiny`` with ``attention_impl`` on
    the dp 2 x sp 2 mesh; writes the initial weights for the port's world,
    returns the losses and the final weights in the port's layout."""
    cfg = dataclasses.replace(jllama.llama_tiny(), attention_impl=impl)
    model = jllama.Llama(cfg)
    mesh = jcreate_mesh({"dp": 2, "sp": 2}, devices=jax.devices()[:N])
    opt = optax.adamw(1e-3)
    tcfg = tllama.llama_tiny()
    state = create_gspmd_train_state(model, opt, jax.random.PRNGKey(0),
                                     tokens, mesh, jllama.LOGICAL_RULES)
    init = convert.llama_params_from_flax(state.params, tcfg)
    np.savez(tmp / f"init_{impl}.npz",
             **{k: v.numpy() for k, v in init.items()})
    step = make_gspmd_train_step(model, opt, mesh, jllama.LOGICAL_RULES)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, tokens)
        losses.append(float(loss))
    return losses, convert.llama_params_from_flax(state.params, tcfg)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("context_world")
    tokens = np.random.RandomState(0).randint(0, 255, (2, 32))
    np.save(tmp / "tokens.npy", tokens)
    want = {impl: _jax_train(impl, jnp.asarray(tokens), tmp)
            for impl in IMPLS}
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO, HOROVOD_NUM_PROCESSES=str(N),
               HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp)],
        env=dict(env, HOROVOD_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(N)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, _) in zip(procs, outs):
        assert p.returncode == 0, out
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)], want


@pytest.mark.parametrize("impl", IMPLS)
def test_losses_match_jax_gspmd(world, impl):
    ranks, want = world
    jlosses, _ = want[impl]
    for r in ranks:
        np.testing.assert_allclose(r[f"{impl}-losses"], jlosses, rtol=3e-4)
    assert jlosses[-1] < jlosses[0]


@pytest.mark.parametrize("impl", IMPLS)
def test_parameters_after_three_steps_match_jax(world, impl):
    ranks, want = world
    _, params = want[impl]
    for name, w in params.items():
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"{impl}-{name}"],
                                          ranks[0][f"{impl}-{name}"],
                                          err_msg=name)
        np.testing.assert_allclose(ranks[0][f"{impl}-{name}"], w.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_sp_mesh_without_attention_impl_raises(world):
    ranks, _ = world
    for r in ranks:
        assert "needs attention_impl 'ring' or 'ulysses'" in str(
            r["dense_error"])


@pytest.mark.parametrize("with_mesh", [False, True])
def test_unknown_attention_impl_raises_without_sp(with_mesh):
    """As in JAX, the value is checked on every mesh: a typo must not train
    dense on a dev box and fail only on the sp mesh."""
    thvd.init(device="cpu")
    try:
        cfg = dataclasses.replace(tllama.llama_tiny(), attention_impl="typo")
        model = tllama.Llama(cfg, device="cpu")
        tokens = torch.zeros((1, 8), dtype=torch.long)
        mesh = create_mesh({"dp": 1}) if with_mesh else None
        with set_mesh(mesh), pytest.raises(ValueError,
                                           match="attention_impl 'typo'"):
            model(tokens)
    finally:
        thvd.shutdown()
