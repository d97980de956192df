"""The port's Adasum against the JAX package's, in gloo worlds on the CPU.

Two worlds are started once per module, side by side: 2 processes and 4.
Each rank runs every case on its own row of seeded inputs and saves what it
got; the tests then hold the ranks against the JAX package's
``eager.adasum_allreduce`` (or ``eager.allreduce(op=Adasum)``) on the
8-device CPU mesh, with the rows stacked and restricted to a process set of
the first n mesh ranks, so that the JAX butterfly has the port's member
count. Tolerances are per case:

- f32 accumulation, rtol = atol = 1e-5: both sides sum the same terms in f32
  in different orders;
- fp16 on the wire, rtol = atol = 2^-9: both sides round the same values to
  fp16 (2^-11 relative) at the first level; at the second, values that
  differ by the f32 order above may round to neighbouring fp16 values;
- ``HOROVOD_ADASUM_ACCUMULATE_FP64`` against a numpy f64 model (the JAX
  package computes f64 only under ``jax_enable_x64``): within one f32
  rounding, 2^-24 of the value, where the f32 path is not.

``DistributedOptimizer(AdamW, op=Adasum)`` runs 2 steps of ``llama_tiny`` in
the 2-process world, a different shard per rank, and is held within 1e-5
(absolute plus relative) to the JAX composition: ``jax.grad`` of
``next_token_loss`` per shard from the converted weights, then
``eager.adasum_allreduce`` over a 2-member process set, then
``optax.adamw(1e-4)``. The ranks end bit-identical in every case but fp16
compression, where each rank keeps its own f32 working copy (as in the JAX
package).
"""

import os
import socket
import subprocess
import sys
import textwrap

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import horovod_tpu as hvd
from horovod_tpu.collectives import eager
from horovod_tpu.collectives.compression import Compression as JCompression
from horovod_tpu.models import llama as jllama
from horovod_tpu.train.gspmd import next_token_loss as j_next_token_loss
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import llama as tllama

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = 8
WORLDS = (2, 4)
OPT_STEPS = 2

_WORKER = textwrap.dedent("""
    import dataclasses
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import context_api
    from horovod_tpu_torch.ops import fused

    data_dir = sys.argv[1]
    hvd.init(device="cpu")
    rank, n = hvd.rank(), hvd.size()
    data = np.load(f"{data_dir}/inputs{n}.npz")
    row = lambda k: torch.from_numpy(data[k][rank].copy())
    out = {}

    x = row("x")
    out["allreduce"] = hvd.allreduce(x, hvd.Adasum)
    assert torch.equal(x, row("x")), "the input is left untouched"
    out["grouped_b"], out["grouped_w"] = hvd.grouped_allreduce(
        [row("b"), row("w")], hvd.Adasum)
    out["scaled"] = hvd.allreduce(x, hvd.Adasum, prescale_factor=0.5,
                                  postscale_factor=3.0)
    out["fp16"] = hvd.allreduce(x, hvd.Adasum,
                                compression=hvd.Compression.fp16)
    ctx = context_api.context()
    xc = row("xc")
    out["f32_acc"] = hvd.allreduce(xc, hvd.Adasum)
    ctx.config = dataclasses.replace(ctx.config,
                                     adasum_accumulate_dtype="float64")
    out["f64_acc"] = hvd.allreduce(xc, hvd.Adasum)
    ctx.config = dataclasses.replace(ctx.config,
                                     adasum_accumulate_dtype="float32")
    if n == 4:
        pair = hvd.add_process_set([0, 1])
        got = hvd.allreduce(x, hvd.Adasum, process_set=pair)
        assert (got is x) == (rank not in (0, 1))
        out["pair"] = got
        three = hvd.add_process_set([0, 1, 2])
        try:
            hvd.allreduce(x, hvd.Adasum, process_set=three)
        except ValueError as e:
            out["non_pow2_error"] = np.asarray(str(e))
    if n == 2:
        from horovod_tpu_torch.models.llama import Llama, llama_tiny
        from horovod_tpu_torch.train import (create_train_state,
                                             make_train_step,
                                             next_token_loss)
        model = Llama(llama_tiny(), device="cpu", seed=rank)
        if rank == 0:  # the others keep their own seed: the broadcast fixes them
            model.load_state_dict({k[6:]: torch.from_numpy(data[k])
                                   for k in data.files
                                   if k.startswith("param/")})
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters(), op=hvd.Adasum)
        assert len(opt.buckets) == 1
        state = create_train_state(model, opt)
        step = make_train_step(model, opt, next_token_loss)
        shard = row("tokens")
        for _ in range(%(steps)d):
            state, loss = step(state, shard, shard)
        out.update({"param/" + k: v for k, v in model.state_dict().items()})
    out["launches"] = np.asarray([f.launches for f in fused.KERNELS.values()])
    np.savez(f"{data_dir}/out{n}_rank{rank}.npz",
             **{k: np.asarray(v) for k, v in out.items()})
    hvd.shutdown()
""") % {"steps": OPT_STEPS}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs(n):
    rng = np.random.RandomState(n)
    common = rng.randn(1000).astype(np.float32)
    return {
        "x": rng.randn(n, 37).astype(np.float32),
        "b": rng.randn(n, 5).astype(np.float32),
        "w": rng.randn(n, 3, 4).astype(np.float32),
        # Nearly parallel rows: the coefficients' sums cancel.
        "xc": (common + 1e-3 * rng.randn(n, 1000)).astype(np.float32),
    }


def _tiny():
    cfg = jllama.llama_tiny()
    model = jllama.Llama(cfg)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (8, 16))
    params = nn.meta.unbox(model.init(jax.random.PRNGKey(0),
                                      jnp.asarray(tokens[:1])))
    return model, params, tokens


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Run the worker in a 2- and a 4-process gloo world at once; return
    ``{n: (inputs, [rank outputs])}``."""
    d = tmp_path_factory.mktemp("adasum")
    _, params, tokens = _tiny()
    init = convert.llama_params_from_flax(params, tllama.llama_tiny())
    inputs = {n: _inputs(n) for n in WORLDS}
    per = tokens.shape[0] // 2
    inputs[2]["tokens"] = tokens.reshape(2, per, -1)
    np.savez(d / "inputs4.npz", **inputs[4])
    np.savez(d / "inputs2.npz", **inputs[2],
             **{"param/" + k: v.numpy() for k, v in init.items()})
    script = d / "worker.py"
    script.write_text(_WORKER)
    procs = []
    for n in WORLDS:
        env = dict(os.environ, PYTHONPATH=REPO,
                   HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
                   HOROVOD_NUM_PROCESSES=str(n))
        procs += [subprocess.Popen(
            [sys.executable, str(script), str(d)],
            env=dict(env, HOROVOD_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(n)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            p.kill()
    return {n: (inputs[n], [dict(np.load(d / f"out{n}_rank{r}.npz"))
                            for r in range(n)]) for n in WORLDS}


def _stack(rows):
    """Per-rank rows padded with zero rows to the 8-device mesh."""
    pad = np.zeros((MESH - len(rows),) + rows.shape[1:], rows.dtype)
    return jnp.asarray(np.concatenate([rows, pad]))


def _first(n):
    """The process set of the first n mesh ranks (None: the whole mesh)."""
    return None if n == MESH else hvd.add_process_set(list(range(n)))


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)


def _np_combine(a, b):
    dot, na, nb = a @ b, a @ a, b @ b
    ca = 1.0 - dot / (2 * na) if na > 0 else 1.0
    cb = 1.0 - dot / (2 * nb) if nb > 0 else 1.0
    return ca * a + cb * b


def _np_adasum(rows):
    vecs = [v.astype(np.float64) for v in rows]
    d = 1
    while d < len(vecs):
        vecs = [_np_combine(vecs[i], vecs[i ^ d]) for i in range(len(vecs))]
        d *= 2
    return vecs[0]


@pytest.mark.parametrize("n", WORLDS)
def test_allreduce_adasum_matches_jax(worlds, n):
    inputs, ranks = worlds[n]
    want = eager.adasum_allreduce(_stack(inputs["x"]), process_set=_first(n))
    _same_on_every_rank(ranks, "allreduce")
    np.testing.assert_allclose(ranks[0]["allreduce"], np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", WORLDS)
def test_grouped_allreduce_adasum_combines_the_concatenation(worlds, n):
    """One coefficient pair per level over the list's concatenation
    (``tests/test_adasum.py::test_adasum_pytree``), not one per tensor."""
    inputs, ranks = worlds[n]
    want_b, want_w = eager.adasum_allreduce(
        [_stack(inputs["b"]), _stack(inputs["w"])], process_set=_first(n))
    for key, want in (("grouped_b", want_b), ("grouped_w", want_w)):
        _same_on_every_rank(ranks, key)
        np.testing.assert_allclose(ranks[0][key], np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    flat = np.concatenate([inputs["b"], inputs["w"].reshape(n, -1)], axis=1)
    got = np.concatenate([ranks[0]["grouped_b"],
                          ranks[0]["grouped_w"].ravel()])
    np.testing.assert_allclose(got, _np_adasum(flat), rtol=1e-5, atol=1e-5)
    per_tensor = _np_adasum(inputs["b"])
    assert np.abs(ranks[0]["grouped_b"] - per_tensor).max() > 1e-3


@pytest.mark.parametrize("n", WORLDS)
def test_prescale_and_postscale_match_jax(worlds, n):
    inputs, ranks = worlds[n]
    want = eager.adasum_allreduce(_stack(inputs["x"]), process_set=_first(n),
                                  prescale_factor=0.5, postscale_factor=3.0)
    _same_on_every_rank(ranks, "scaled")
    np.testing.assert_allclose(ranks[0]["scaled"], np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", WORLDS)
def test_fp16_compression_matches_jax(worlds, n):
    """Each rank combines its own f32 working copy with the partner's fp16
    wire copy, so the ranks differ by the wire's rounding, in the JAX
    package as here: each rank is held to its JAX counterpart."""
    inputs, ranks = worlds[n]
    want = np.asarray(eager.allreduce(
        _stack(inputs["x"]), op=hvd.Adasum, process_set=_first(n),
        compression=JCompression.fp16))
    for r in range(n):
        got = ranks[r]["fp16"]
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want[r], rtol=2 ** -9, atol=2 ** -9)
        assert np.abs(got - ranks[r]["allreduce"]).max() > 1e-5, \
            "the wire was not compressed"


@pytest.mark.parametrize("n", WORLDS)
def test_fp64_accumulate_option(worlds, n):
    inputs, ranks = worlds[n]
    oracle = _np_adasum(inputs["xc"])
    ulp = 2 ** -24 * np.abs(oracle)
    for key in ("f32_acc", "f64_acc"):
        _same_on_every_rank(ranks, key)
        assert ranks[0][key].dtype == np.float32
    assert (np.abs(ranks[0]["f64_acc"] - oracle) <= ulp).all()
    assert (np.abs(ranks[0]["f32_acc"] - oracle) > ulp).any()


def test_process_set_of_two_in_a_world_of_four(worlds):
    """Members 0 and 1 combine only with each other; 2 and 3 keep their
    input, as in ``tests/test_adasum.py::test_adasum_process_set_pow2``."""
    inputs, ranks = worlds[4]
    want = np.asarray(eager.allreduce(_stack(inputs["x"]), op=hvd.Adasum,
                                      process_set=hvd.add_process_set([0, 1])))
    for r in range(4):
        np.testing.assert_allclose(ranks[r]["pair"], want[r], rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(ranks[0]["pair"], ranks[1]["pair"])
    for r in (2, 3):
        np.testing.assert_array_equal(ranks[r]["pair"], inputs["x"][r])


def test_non_power_of_two_set_raises_on_every_rank(worlds):
    _, ranks = worlds[4]
    for r in ranks:
        assert "power-of-2 participant count, got 3" in str(
            r["non_pow2_error"])
    with pytest.raises(ValueError, match="power-of-2"):
        eager.allreduce(jnp.zeros((MESH, 4)), op=hvd.Adasum,
                        process_set=hvd.add_process_set([0, 1, 2]))


def test_no_kernel_launches_on_the_cpu(worlds):
    for n in WORLDS:
        for r in worlds[n][1]:
            assert list(r["launches"]) == [0, 0]


def test_distributed_optimizer_adasum_matches_jax_composition(worlds):
    model, params, tokens = _tiny()
    tx = optax.adamw(1e-4)
    opt_state = tx.init(params)
    pair = hvd.add_process_set([0, 1])
    per = tokens.shape[0] // 2

    def loss(p, t):
        return j_next_token_loss(model.apply(p, t), t)

    for _ in range(OPT_STEPS):
        grads = [jax.grad(loss)(params, jnp.asarray(tokens[r * per:
                                                          (r + 1) * per]))
                 for r in range(2)]
        stacked = jax.tree_util.tree_map(
            lambda *g: _stack(np.stack([np.asarray(x) for x in g])), *grads)
        combined = eager.adasum_allreduce(stacked, process_set=pair)
        updates, opt_state = tx.update(combined, opt_state, params)
        # A two-step reference on fixed data, not a training loop.
        params = optax.apply_updates(params, updates)  # hvd-analyze: ok
    want = convert.llama_params_from_flax(params, tllama.llama_tiny())
    _, ranks = worlds[2]
    for name, w in want.items():
        _same_on_every_rank(ranks, "param/" + name)
        np.testing.assert_allclose(ranks[0]["param/" + name], w.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
