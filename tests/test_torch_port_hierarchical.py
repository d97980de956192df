"""The port's hierarchical collectives against the JAX package's, on the CPU.

One gloo world of 4 processes is started once per module, declared 2 cross
x 2 intra through the reference runner's ``HOROVOD_LOCAL_SIZE=2``, with
``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` in its environment. The JAX side is a
mesh of ``jax.devices()[:4]`` reshaped ``(2, 2)`` with axes ``("cross",
"intra")``, the ops run under ``shard_map`` over the tuple axis as
``tests/test_hierarchical.py`` runs them; each rank holds its own row of
seeded numpy inputs, rank r on mesh position r.

The cases mirror ``tests/test_hierarchical.py``: hierarchical against flat;
a leaf that the intra size does not divide; grouped mixed dtypes; Average
over ints promoting like flat; pre- and post-scale; Min and Max falling back
to flat; the explicit ``hierarchical_allreduce`` with the flag off; bf16 on
the cross hop only; the staged allgather; the env var engaging; and then
``hierarchical_adasum`` against the JAX one, and two
``DistributedOptimizer(AdamW)`` steps of ``llama_tiny`` against the JAX
``make_train_step`` on the 2 x 2 mesh with ``hierarchical_allreduce=True``.
Launches of each stage are counted on the port's side.

Tolerances: f32 sums of 4 terms in two orders, rtol = atol = 1e-6; bf16 on
the cross hop, 2^-8 relative to (|ref| + RMS(ref)): both sides round each
shard to bf16 (2^-9) and the cross sum of two once more; Adasum 1e-5 as in
``tests/test_torch_port_adasum.py``; the optimizer within 1e-5 (absolute
plus relative), as the Adasum optimizer test holds its composition.
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
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu.collectives import adasum as jadasum
from horovod_tpu.collectives import ops as jops
from horovod_tpu.core.config import Config
from horovod_tpu.models import llama as jllama
from horovod_tpu.optimizer import distributed
from horovod_tpu.train import create_train_state, make_train_step
from horovod_tpu.train.gspmd import next_token_loss as j_next_token_loss
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import llama as tllama

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
AXES = ("cross", "intra")
OPT_STEPS = 2

_WORKER = textwrap.dedent("""
    import dataclasses
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.collectives import ops
    from horovod_tpu_torch.core import context_api
    from horovod_tpu_torch.ops import fused

    data_dir = sys.argv[1]
    hvd.init(device="cpu")
    rank = hvd.rank()
    ctx = context_api.context()
    data = np.load(f"{data_dir}/inputs.npz")
    row = lambda k: torch.from_numpy(data[k][rank].copy())
    out = {"layout": np.asarray([rank, hvd.size(), hvd.local_rank(),
                                 hvd.local_size(), hvd.cross_rank(),
                                 hvd.cross_size()]),
           "env_flag": np.asarray(ctx.config.hierarchical_allreduce)}
    stages = ops.hierarchical_allreduce_async_.launches

    def counted(key, fn):
        before = dict(stages)
        out[key] = fn()
        out[key + "#launches"] = np.asarray(
            [stages[s] - before[s] for s in ops.HIER_STAGES])
        return out[key]

    for op in (hvd.Sum, hvd.Average):
        counted(f"hier/{op}", lambda: hvd.allreduce(row("x"), op))
        with ops.hierarchical_override(False):
            counted(f"flat/{op}", lambda: hvd.allreduce(row("x"), op))
    counted("pad", lambda: hvd.allreduce(row("odd"), hvd.Sum))
    (out["grouped/w"], out["grouped/b"], out["grouped/i"]) = counted(
        "grouped", lambda: hvd.grouped_allreduce(
            [row("w"), row("b"), row("i")], hvd.Sum))
    del out["grouped"]
    counted("int_average", lambda: hvd.allreduce(row("i2"), hvd.Average))
    counted("scaled", lambda: hvd.allreduce(row("s"), hvd.Sum,
                                            prescale_factor=0.5,
                                            postscale_factor=2.0))
    for op in (hvd.Min, hvd.Max):
        counted(f"fallback/{op}", lambda: hvd.allreduce(row("m"), op))
    ctx.config = dataclasses.replace(ctx.config, hierarchical_allreduce=False)
    counted("unflagged", lambda: hvd.allreduce(row("e"), hvd.Sum))
    counted("explicit", lambda: hvd.hierarchical_allreduce(row("e"), hvd.Sum))
    ctx.config = dataclasses.replace(ctx.config, hierarchical_allreduce=True,
                                     hierarchical_compression="bf16")
    counted("bf16_cross", lambda: hvd.allreduce(row("c"), hvd.Sum))
    ctx.config = dataclasses.replace(ctx.config,
                                     hierarchical_compression="none")
    out["allgather_flat"] = hvd.allgather(row("g"))
    ctx.config = dataclasses.replace(ctx.config, hierarchical_allgather=True)
    out["allgather_staged"] = hvd.allgather(row("g"))
    ctx.config = dataclasses.replace(ctx.config, hierarchical_allgather=False)

    fused.reset_launch_counts()
    out["adasum/a"], out["adasum/b"] = hvd.hierarchical_adasum(
        [row("ada_a"), row("ada_b")])
    out["adasum#launches"] = np.asarray(
        [f.launches for f in fused.KERNELS.values()])

    from horovod_tpu_torch.models.llama import Llama, llama_tiny
    from horovod_tpu_torch.train import (create_train_state, make_train_step,
                                         next_token_loss)
    model = Llama(llama_tiny(), device="cpu", seed=rank)
    if rank == 0:  # the others keep their own seed: the broadcast fixes them
        model.load_state_dict({k[6:]: torch.from_numpy(data[k])
                               for k in data.files if k.startswith("param/")})
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, next_token_loss)
    shard = row("tokens")
    losses, launches = [], []
    for _ in range(%(steps)d):
        before = dict(stages)
        state, loss = step(state, shard, shard)
        losses.append(loss.item())
        launches.append([stages[s] - before[s] for s in ops.HIER_STAGES])
    out["opt/losses"] = np.asarray(losses)
    out["opt/launches"] = np.asarray(launches)
    out["opt/buckets"] = np.asarray(len(opt.buckets))
    out.update({"param/" + k: v for k, v in model.state_dict().items()})
    np.savez(f"{data_dir}/rank{rank}.npz",
             **{k: np.asarray(v) for k, v in out.items()})
    hvd.shutdown()
""") % {"steps": OPT_STEPS}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs():
    rng = np.random.RandomState(6)
    return {
        "x": rng.randn(N, 4, 3).astype(np.float32),
        "odd": rng.randn(N, 13).astype(np.float32),
        "w": rng.randn(N, 5, 2).astype(np.float32),
        "b": rng.randn(N, 7).astype(np.float32),
        "i": (rng.randn(N, 3) * 4).astype(np.int32),
        "i2": (rng.randn(N, 6) * 8).astype(np.int32),
        "s": rng.randn(N, 10).astype(np.float32),
        "m": rng.randn(N, 9).astype(np.float32),
        "e": rng.randn(N, 12).astype(np.float32),
        "c": rng.randn(N, 64).astype(np.float32),
        "g": rng.randn(N, 2, 3).astype(np.float32),
        "ada_a": rng.randn(N, 37).astype(np.float32),
        "ada_b": rng.randn(N, 3, 4).astype(np.float32),
    }


def _mesh2d():
    return Mesh(np.array(jax.devices()[:N]).reshape(2, 2), AXES)


def _init_hier(**cfg):
    hvd.shutdown()
    hvd.init(mesh=_mesh2d(), config=Config(**cfg))


def _run(fn, *arrays):
    """``fn`` of each rank's row on the 2 x 2 mesh; the per-rank results."""
    f = shard_map(lambda *xs: jax.tree_util.tree_map(
        lambda y: y[None], fn(*[x[0] for x in xs])), mesh=_mesh2d(),
        in_specs=tuple(P(AXES) for _ in arrays), out_specs=P(AXES),
        check_vma=False)
    return jax.jit(f)(*[jnp.asarray(a) for a in arrays])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the worker in the 4-process world declared 2 x 2 while the JAX
    package trains the same model on the 2 x 2 mesh; return both sides."""
    d = tmp_path_factory.mktemp("hierarchical")
    _init_hier(hierarchical_allreduce=True)
    cfg = jllama.llama_tiny()
    model = jllama.Llama(cfg)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (8, 16))
    dopt = distributed(optax.adamw(1e-4))
    state = create_train_state(model, jax.random.PRNGKey(0),
                               jnp.asarray(tokens[:1]), dopt)
    init = convert.llama_params_from_flax(state.params, tllama.llama_tiny())
    inputs = _inputs()
    np.savez(d / "inputs.npz", tokens=tokens.reshape(N, 2, -1), **inputs,
             **{"param/" + k: v.numpy() for k, v in init.items()})
    script = d / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO,
               HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               HOROVOD_NUM_PROCESSES=str(N), HOROVOD_LOCAL_SIZE="2",
               HOROVOD_HIERARCHICAL_ALLREDUCE="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(d)],
        env=dict(env, HOROVOD_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(N)]
    try:
        step = make_train_step(model, dopt, j_next_token_loss)
        losses = []
        for _ in range(OPT_STEPS):
            state, loss = step(state, jnp.asarray(tokens),
                               jnp.asarray(tokens))
            losses.append(float(loss))
        want = convert.llama_params_from_flax(state.params,
                                              tllama.llama_tiny())
        for p in procs:
            out, _ = p.communicate(timeout=240)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            p.kill()
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(N)]
    return inputs, ranks, (want, losses)


def _hold(ranks, key, want, rtol=1e-6, atol=1e-6):
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[key], np.asarray(want)[r], rtol=rtol,
                                   atol=atol, err_msg=f"{key} rank {r}")


HIER = [1, 1, 1]  # one launch of each stage
NONE = [0, 0, 0]


def test_layout_is_declared_by_local_size_and_the_env_flag_engages(world):
    _, ranks, _ = world
    for r, got in enumerate(ranks):
        assert list(got["layout"]) == [r, N, r % 2, 2, r // 2, 2]
        assert bool(got["env_flag"])
        assert list(got["hier/sum#launches"]) == HIER


@pytest.mark.parametrize("op", [hvd.Sum, hvd.Average])
def test_hierarchical_matches_flat_and_jax(world, op):
    inputs, ranks, _ = world
    _init_hier(hierarchical_allreduce=True)
    want = _run(lambda t: jops.allreduce(t, op), inputs["x"])
    _hold(ranks, f"hier/{op}", want)
    ref = inputs["x"].sum(0) / (N if op == hvd.Average else 1)
    for got in ranks:
        assert list(got[f"hier/{op}#launches"]) == HIER
        assert list(got[f"flat/{op}#launches"]) == NONE
        np.testing.assert_allclose(got[f"hier/{op}"], got[f"flat/{op}"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[f"hier/{op}"], ref, rtol=1e-5)


def test_hierarchical_pads_non_divisible_leaf(world):
    """13 elements over an intra size of 2: padded to 14 for the
    reduce-scatter and sliced back after the gather."""
    inputs, ranks, _ = world
    _init_hier(hierarchical_allreduce=True)
    _hold(ranks, "pad", _run(lambda t: jops.allreduce(t, hvd.Sum),
                             inputs["odd"]))
    assert ranks[0]["pad"].shape == (13,)


def test_hierarchical_grouped_mixed_dtypes(world):
    inputs, ranks, _ = world
    _init_hier(hierarchical_allreduce=True)
    want = _run(lambda w, b, i: jops.grouped_allreduce(
        {"w": w, "b": b, "i": i}, hvd.Sum),
        inputs["w"], inputs["b"], inputs["i"])
    for k in "wbi":
        _hold(ranks, f"grouped/{k}", want[k])
        assert ranks[0][f"grouped/{k}"].dtype == inputs[k].dtype
    # One bucket per wire dtype, each through the three stages.
    assert list(ranks[0]["grouped#launches"]) == [2, 2, 2]


def test_hierarchical_average_int_promotes_like_flat(world):
    inputs, ranks, _ = world
    _init_hier(hierarchical_allreduce=True)
    want = _run(lambda t: jops.allreduce(t, hvd.Average), inputs["i2"])
    assert np.asarray(want).dtype == np.float32
    for got in ranks:
        assert got["int_average"].dtype == np.float32
    _hold(ranks, "int_average", want)


def test_hierarchical_prescale_postscale(world):
    inputs, ranks, _ = world
    _init_hier(hierarchical_allreduce=True)
    _hold(ranks, "scaled", _run(lambda t: jops.allreduce(
        t, hvd.Sum, prescale_factor=0.5, postscale_factor=2.0),
        inputs["s"]))


@pytest.mark.parametrize("op", [hvd.Min, hvd.Max])
def test_min_and_max_fall_back_to_flat(world, op):
    inputs, ranks, _ = world
    _init_hier(hierarchical_allreduce=True)
    _hold(ranks, f"fallback/{op}", _run(lambda t: jops.allreduce(t, op),
                                        inputs["m"]), rtol=0, atol=0)
    for got in ranks:
        assert list(got[f"fallback/{op}#launches"]) == NONE


def test_explicit_hierarchical_allreduce_without_the_flag(world):
    inputs, ranks, _ = world
    _init_hier(hierarchical_allreduce=False)
    want = _run(lambda t: jops.hierarchical_allreduce(
        t, hvd.Sum, intra_axis="intra", cross_axes="cross"), inputs["e"])
    _hold(ranks, "explicit", want)
    for got in ranks:
        assert list(got["unflagged#launches"]) == NONE
        assert list(got["explicit#launches"]) == HIER


def test_bf16_compression_on_the_cross_hop_only(world):
    inputs, ranks, _ = world
    _init_hier(hierarchical_allreduce=True, hierarchical_compression="bf16")
    want = np.asarray(_run(lambda t: jops.allreduce(t, hvd.Sum),
                           inputs["c"]))
    exact = inputs["c"].sum(0)
    for r, got in enumerate(ranks):
        g = got["bf16_cross"]
        assert g.dtype == np.float32
        tol = 2 ** -8 * (np.abs(want[r]) + np.sqrt(np.mean(want[r] ** 2)))
        assert (np.abs(g - want[r]) <= tol).all()
        assert np.abs(g - exact).max() > 1e-6, "the cross hop was not cast"
        assert list(got["bf16_cross#launches"]) == HIER


def test_hierarchical_allgather_matches_flat_and_jax(world):
    inputs, ranks, _ = world
    _init_hier(hierarchical_allgather=True)
    want = np.asarray(_run(lambda t: jops.allgather(t), inputs["g"]))
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["allgather_staged"], want[r])
        np.testing.assert_array_equal(got["allgather_staged"],
                                      got["allgather_flat"])
    np.testing.assert_array_equal(ranks[0]["allgather_staged"],
                                  inputs["g"].reshape(-1, 3))


def test_hierarchical_adasum_matches_jax(world):
    """Sum within the node, the butterfly across the 2 nodes, gather within
    the node, for each tensor; on the CPU the kernels do not launch."""
    inputs, ranks, _ = world
    _init_hier()
    want = _run(lambda a, b: jadasum.hierarchical_adasum(
        [a, b], intra_axis="intra", cross_axis="cross"),
        inputs["ada_a"], inputs["ada_b"])
    for i, key in enumerate(("adasum/a", "adasum/b")):
        _hold(ranks, key, want[i], rtol=1e-5, atol=1e-5)
    for got in ranks[1:]:
        np.testing.assert_array_equal(got["adasum/a"], ranks[0]["adasum/a"])
    for got in ranks:
        assert list(got["adasum#launches"]) == [0, 0]


def test_distributed_optimizer_hierarchical_matches_jax_train_step(world):
    """Two AdamW steps of ``llama_tiny``, each rank on its quarter of the
    batch, with the flag: every bucket and the loss take the three stages
    once a step, the ranks end bit-identical, and the parameters are within
    1e-5 of the JAX ``make_train_step`` on the 2 x 2 mesh."""
    _, ranks, (want, losses) = world
    buckets = int(ranks[0]["opt/buckets"])
    for got in ranks:
        assert got["opt/launches"].tolist() == [[buckets + 1] * 3] * OPT_STEPS
        np.testing.assert_allclose(got["opt/losses"], losses, rtol=1e-5)
    for name, w in want.items():
        for got in ranks[1:]:
            np.testing.assert_array_equal(got["param/" + name],
                                          ranks[0]["param/" + name])
        np.testing.assert_allclose(ranks[0]["param/" + name], w.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
