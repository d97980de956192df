"""Model-parallel BERT in the port against the JAX package, on the CPU.

Gloo worlds of 2 and 4 processes, started side by side once for the module,
train ``bert_tiny`` (f32; dim 64, hidden 128, 4 heads, 2 layers) with the
masked-LM loss three AdamW steps (lr 1e-3, weight decay 1e-4) on a seeded
4 x 32 batch with a 15 % mask, ``tests/test_models.py``'s
``test_bert_trains_dp_tp`` settings, on ``{"tp": 2}``, ``{"fsdp": 2}``
(world of 2), ``{"dp": 2, "tp": 2}`` and ``{"fsdp": 2, "tp": 2}`` (world
of 4; JAX's own test is dp 4 x tp 2, and a gloo world of 8 would be slow).
Each rank holds its block of every parameter, cut from the flax init by
``convert.bert_params_from_flax(..., mesh=mesh)``, and trains through
``train.make_gspmd_train_step(loss_fn=losses.mlm_loss_sums)`` on its shard
of the tokens, labels and mask; JAX trains through its
``make_gspmd_train_step(loss_fn=...)`` on the same mesh of
``jax.devices()[:n]``, from the same init.

Gates: losses within rtol 1e-5; the whole parameters after the three
steps, gathered by ``sharding.full_state_dict``, within 1e-4 absolute plus
relative (the bound of ``tests/test_torch_port_tp.py``: AdamW's first
steps turn summation-order gaps at near-zero gradients into steps of up to
2 lr), but for the key projection's bias, whose gradient is 0 in exact
arithmetic (the test says why) and which both sides must keep within
three steps of lr of its zero init; each block bit-identical on the ranks
that hold it; the collectives a step. The data shards' mask counts differ
(asserted), so the mean of the shards' mean losses misses JAX's loss
(asserted), which the global count meets. In process: BERT on an ``sp`` axis raises, a vocabulary that tp
does not divide raises (30522 over tp 4; over tp 2 it splits), and
flax's first-use rule places ``mlm_transform``.
"""

import dataclasses
import json
import pickle
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax import linen as nn

import torch_port_mp as mp
from horovod_tpu.models import bert as jbert
from horovod_tpu.models.llama import LOGICAL_RULES
from horovod_tpu.parallel import create_mesh as jcreate_mesh
from horovod_tpu.train import gspmd_shardings, make_gspmd_train_step
from horovod_tpu.train.gspmd import GSPMDTrainState

from horovod_tpu_torch import convert
from horovod_tpu_torch.models import bert as tbert

STEPS = 3

#: name -> (world size, axes)
CASES = {
    "tp2": (2, {"tp": 2}),
    "fsdp2": (2, {"fsdp": 2}),
    "dp2tp2": (4, {"dp": 2, "tp": 2}),
    "fsdp2tp2": (4, {"fsdp": 2, "tp": 2}),
}

_WORKER = textwrap.dedent("""
    import json
    import pickle
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.models.bert import Bert, bert_tiny
    from horovod_tpu_torch.parallel import create_mesh, sharding
    from horovod_tpu_torch.train import (create_gspmd_train_state,
                                         make_gspmd_train_step,
                                         mesh_param_groups, mlm_loss_sums,
                                         shard_tokens)

    data_dir = sys.argv[1]
    torch.set_num_threads(1)  # six ranks and JAX share the host's cores
    hvd.init(device="cpu")
    rank, n = hvd.rank(), hvd.size()
    cases = json.load(open(f"{data_dir}/cases.json"))
    d = {k: torch.from_numpy(v) for k, v in
         np.load(f"{data_dir}/batch.npz").items()}
    cfg = bert_tiny()
    out = {}
    for name, (size, axes) in cases.items():
        if size != n:
            continue
        mesh = create_mesh(axes)
        with open(f"{data_dir}/init.pkl", "rb") as f:
            sd = convert.bert_params_from_flax(pickle.load(f), cfg,
                                               mesh=mesh)
        model = Bert(cfg, device="cpu", seed=rank, mesh=mesh)
        model.load_state_dict(sd)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(mesh_param_groups(model, mesh), lr=1e-3,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters())
        state = create_gspmd_train_state(model, opt, mesh)
        step = make_gspmd_train_step(model, opt, mesh,
                                     loss_fn=mlm_loss_sums)
        batch = tuple(shard_tokens(d[k], mesh)
                      for k in ("tokens", "labels", "mask"))
        res = {"losses": [], "counts": []}
        with torch.no_grad():  # this shard's own mean, before any step
            tp = mesh.axis("tp") if mesh.shape.get("tp", 1) > 1 else None
            total, count = mlm_loss_sums(model(batch[0]), batch, tp)
            res["shard_mean"] = (total / count).item()
            res["shard_count"] = count.item()
        for i in range(3):
            sharding.reset_counts()
            state, loss = step(state, batch)
            res["losses"].append(loss.item())
            res["counts"].append(dict(sharding.counts))
        differ = 0
        for p in model.parameters():
            rs = sharding.replica_set(mesh, sharding.holder_axes(p))
            ranks = rs.ranks if rs is not None else tuple(range(n))
            buf = p.detach().clone()
            hvd.broadcast_(buf, ranks[0], process_set=rs)
            differ += int(not torch.equal(buf, p.detach()))
        res["differ"] = differ
        res["coords"] = {a: mesh.axis(a).index for a in mesh.axis_names}
        full = sharding.full_state_dict(model)
        if rank == 0:
            np.savez(f"{data_dir}/{name}.npz",
                     **{k: v.numpy() for k, v in full.items()})
        out[name] = res
    with open(f"{data_dir}/rank{rank}_{n}.json", "w") as f:
        json.dump(out, f)
    hvd.shutdown()
""")


def _batch():
    """``tests/test_models.py::test_bert_trains_dp_tp``'s batch."""
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 255, (4, 32))
    labels = rng.randint(0, 255, (4, 32))
    mask = rng.rand(4, 32) < 0.15
    return {"tokens": tokens, "labels": labels, "mask": mask}


def _jax_gspmd(axes, batch, init):
    """Three AdamW steps of JAX's GSPMD step with the MLM ``loss_fn`` on
    ``axes`` of ``jax.devices()[:n]`` from the flax parameters ``init``,
    laid out by ``gspmd_shardings``: the losses and the final
    parameters."""
    model = jbert.Bert(jbert.bert_tiny())
    n = int(np.prod(list(axes.values())))
    mesh = jcreate_mesh(axes, devices=jax.devices()[:n])
    opt = optax.adamw(1e-3)
    toks = jnp.asarray(batch["tokens"])
    labels, mask = jnp.asarray(batch["labels"]), jnp.asarray(batch["mask"])

    def loss_fn(logits, _tokens):
        return jbert.mlm_loss(logits, labels, mask)

    places, _ = gspmd_shardings(model, opt, jax.random.PRNGKey(0), toks,
                                mesh, LOGICAL_RULES)
    params = jax.tree_util.tree_map(jax.device_put, init, places)
    state = GSPMDTrainState(jnp.zeros((), jnp.int32), params,
                            opt.init(params))
    step = make_gspmd_train_step(model, opt, mesh, LOGICAL_RULES,
                                 loss_fn=loss_fn)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, toks)
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, state.params)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bert_mp")
    batch = _batch()
    np.savez(tmp / "batch.npz", **batch)
    init = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(
        jbert.Bert(jbert.bert_tiny()).init(
            jax.random.PRNGKey(0), jnp.asarray(batch["tokens"]))["params"]))
    with open(tmp / "init.pkl", "wb") as f:
        pickle.dump(init, f)
    (tmp / "cases.json").write_text(json.dumps(CASES))
    wait = mp.start_worlds(tmp, _WORKER, (2, 4))
    # JAX's steps while the worlds run
    tcfg = tbert.bert_tiny()
    want = {}
    for name, (_, axes) in CASES.items():
        losses, params = _jax_gspmd(axes, batch, init)
        want[name] = (losses, {k: v.numpy() for k, v in
                               convert.bert_params_from_flax(
                                   params, tcfg).items()})
    wait()
    got = {n: [json.load(open(tmp / f"rank{r}_{n}.json")) for r in range(n)]
           for n in (2, 4)}
    return tmp, got, want


def _ranks(worlds, name):
    return worlds[1][CASES[name][0]]


@pytest.mark.parametrize("name", sorted(CASES))
def test_losses_match_jax(worlds, name):
    _, _, want = worlds
    jlosses, _ = want[name]
    for r in _ranks(worlds, name):
        np.testing.assert_allclose(r[name]["losses"], jlosses, rtol=1e-5)
    assert jlosses[-1] < jlosses[0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_parameters_after_three_steps_match_jax(worlds, name):
    tmp, _, want = worlds
    _, params = want[name]
    got = dict(np.load(tmp / f"{name}.npz"))
    assert sorted(got) == sorted(params)
    for k, w in params.items():
        if k.endswith("wk.bias"):
            # Adding b to every key adds q.b to every score of a row, which
            # the softmax cancels: this bias's gradient is 0 in exact
            # arithmetic and rounding noise on either side, which AdamW
            # turns into steps of +-lr in no particular direction. Both
            # sides must stay within those steps of the zero init.
            for v in (got[k], w):
                assert np.abs(v).max() <= STEPS * 1e-3 * (1 + 1e-3), k
            continue
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_blocks_bit_identical_on_their_holders(worlds, name):
    assert [r[name]["differ"] for r in _ranks(worlds, name)] == \
        [0] * CASES[name][0]


@pytest.mark.parametrize("name", ["dp2tp2", "fsdp2"])
def test_uneven_mask_counts_take_the_global_count(worlds, name):
    """The data shards mask different numbers of positions. JAX divides
    the summed loss by the global count, and so does the port (its first
    loss meets JAX's at 1e-5); the mean of the shards' means, each over its
    own count, misses it by far more."""
    _, _, want = worlds
    ranks = _ranks(worlds, name)
    counts = {r[name]["coords"].get("dp", r[name]["coords"].get("fsdp")):
              (r[name]["shard_count"], r[name]["shard_mean"]) for r in ranks}
    assert len(counts) == 2
    (c0, m0), (c1, m1) = counts.values()
    assert c0 != c1
    first = want[name][0][0]
    assert abs((m0 + m1) / 2 - first) > 10 * 1e-5 * first
    global_mean = (c0 * m0 + c1 * m1) / (c0 + c1)
    np.testing.assert_allclose(global_mean, first, rtol=1e-5)


#: The collectives a step of ``bert_tiny`` (2 layers, remat off). Under
#: tp: 1 all-reduce for the table, 4 a layer (after ``wo`` and ``ffn_out``
#: forward, before ``wq``/``wk``/``wv`` and ``ffn_in`` backward), 1 before
#: the head backward and 2 for the loss. Under fsdp: a layer's six dense
#: weights and ``mlm_transform``'s, each gathered once and reduce-scattered
#: once; the tables, the biases and the LayerNorms are whole.
COUNTS = {
    "tp2": {"all_gather": 0, "reduce_scatter": 0, "tp_all_reduce": 12},
    "fsdp2": {"all_gather": 13, "reduce_scatter": 13, "tp_all_reduce": 0},
    "dp2tp2": {"all_gather": 0, "reduce_scatter": 0, "tp_all_reduce": 12},
    "fsdp2tp2": {"all_gather": 13, "reduce_scatter": 13,
                 "tp_all_reduce": 12},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_collectives_per_step(worlds, name):
    for r in _ranks(worlds, name):
        assert r[name]["counts"] == [COUNTS[name]] * STEPS


@pytest.fixture
def world_of_four(monkeypatch):
    """A world of one that makes meshes of four: its size patched and
    ``new_group`` recording the rows (``tests/test_torch_port_fsdp.py``).
    """
    import torch.distributed as dist

    import horovod_tpu_torch as thvd
    from horovod_tpu_torch.core import context_api
    thvd.init(device="cpu")
    monkeypatch.setattr(context_api, "size", lambda: 4)
    monkeypatch.setattr(dist, "new_group", lambda ranks: tuple(ranks))
    try:
        yield
    finally:
        monkeypatch.undo()
        thvd.shutdown()


def test_bert_on_sp_raises(world_of_four):
    from horovod_tpu_torch.parallel import create_mesh
    mesh = create_mesh({"dp": 2, "sp": 2})
    with pytest.raises(ValueError, match="sp axis.*ROADMAP.md, section C"):
        tbert.Bert(tbert.bert_tiny(), device="cpu", mesh=mesh)


def test_uneven_vocabulary_split_raises(world_of_four):
    """BERT-Large's vocabulary, 30522, splits over tp 2 but not over tp 4,
    where XLA pads and the port refuses (ROADMAP.md, section C)."""
    from horovod_tpu_torch.parallel import create_mesh, sharding
    names = tbert.TABLE_NAMES["tok_embedding"]
    place = sharding.placement(create_mesh({"dp": 2, "tp": 2}), names,
                               (30522, 1024))
    assert place.local_shape() == (15261, 1024)
    cfg = dataclasses.replace(tbert.bert_tiny(), vocab_size=30522)
    with pytest.raises(ValueError, match="30522 is not divisible"):
        tbert.Bert(cfg, device="cpu", mesh=create_mesh({"tp": 4}))


def test_first_use_rule_places_mlm_transform(world_of_four):
    """``("embed", "embed_fsdp")``: both names map to fsdp, and flax gives
    the axis to the first dim that asks (the kernel's ``in``), leaving the
    other whole; the port's ``[out, in]`` weight is then split on dim 1,
    and its bias is whole."""
    from horovod_tpu_torch.parallel import create_mesh, sharding
    mesh = create_mesh({"fsdp": 4})
    names = tbert.DENSE_NAMES["mlm_transform"]
    flax_order = sharding.placement(mesh, names, (64, 32))
    assert [a and a.name for a in flax_order.axes] == ["fsdp", None]
    w = sharding.kernel_placement(mesh, names, 64, 32)
    assert w.shape == (32, 64) and w.local_shape() == (32, 16)
    assert sharding.bias_placement(w).local_shape() == (32,)
    model = tbert.Bert(tbert.bert_tiny(), device="cpu", mesh=mesh)
    assert model.mlm_transform.weight.shape == (64, 16)
    assert model.mlm_transform.bias.shape == (64,)
