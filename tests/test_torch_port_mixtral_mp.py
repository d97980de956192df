"""Model-parallel Mixtral in the port against the JAX package, on the CPU.

Gloo worlds of 2 and 4 processes, started side by side once for the module,
train ``mixtral_tiny`` (f32; dim 64, hidden 128, 4/2 heads, 8 experts top
2) on a seeded 4 x 32 batch, each rank holding its ``[E/ep, D/fsdp,
M/tp]`` block of every expert bank and its block of every dense parameter,
cut from the flax init by ``convert.mixtral_params_from_flax(...,
mesh=mesh)``:

- without drops (capacity factor 4 = E / top_k) and without the aux loss,
  three AdamW steps (lr 1e-3, weight decay 1e-4) on ``{"fsdp": 2}``,
  ``{"tp": 2}`` (world of 2), ``{"fsdp": 2, "ep": 2}`` and ``{"ep": 2,
  "tp": 2}`` (world of 4) against JAX's ``make_gspmd_train_step`` on the
  same mesh of ``jax.devices()[:n]``, from the same flax init;
- with drops (capacity factor 0.5) and the aux loss (0.02), where each
  rank routes its own tokens, against the mean over the data shards of
  JAX's single-device value and gradient (each shard routed alone,
  ``tests/test_torch_port_mixtral.py``'s oracle): three ``optax.adamw``
  steps on ``{"ep": 2, "tp": 2}``, and the deferred step
  (``deferred_pair(every=2)``, 4 steps) on ``{"fsdp": 2, "ep": 2}``
  against JAX's ``deferred_pair`` transforms, skip and apply in turn.

Losses within rtol 1e-5. The whole parameters after the steps, gathered
by ``sharding.full_state_dict``, within 1e-4 absolute plus relative of
JAX's: AdamW's first steps are ``lr x sign(g)`` where a gradient element
is near zero, so a summation-order gap there moves a parameter by up to 2
lr = 2e-3 (the bound of ``tests/test_torch_port_tp.py``). The deferred
run's bank is held normwise, within :data:`DEFERRED_NORMWISE`: its one
AdamW step so far, at 2 lr, is that sign step on every element (measured
gaps 4e-6 to 2.4e-5).

Every case also holds each block bit-identical on the ranks that hold it,
the tp ranks' routing counts equal (they route the same tokens), and, on
the skip steps of the deferred run, every bank block without a gradient
and unchanged. The collectives a step are counted on the no-drop meshes.
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
from horovod_tpu.models import mixtral as jmixtral
from horovod_tpu.models.llama import LOGICAL_RULES
from horovod_tpu.optimizer import deferred_pair as jdeferred_pair
from horovod_tpu.parallel import create_mesh as jcreate_mesh
from horovod_tpu.train import (gspmd_shardings, make_gspmd_train_step,
                               next_token_loss)
from horovod_tpu.train.gspmd import GSPMDTrainState

from horovod_tpu_torch import convert
from horovod_tpu_torch.models import mixtral as tmixtral
from horovod_tpu_torch.optimizer import is_expert_param

AUX = 0.02
STEPS, DEFERRED_STEPS, EVERY = 3, 4, 2
#: The deferred run's bank after its 4 steps, normwise (module doc).
DEFERRED_NORMWISE = 1e-4

#: name -> (world size, axes, capacity factor, aux weight, oracle)
CASES = {
    "fsdp2": (2, {"fsdp": 2}, 4.0, 0.0, "gspmd"),
    "tp2": (2, {"tp": 2}, 4.0, 0.0, "gspmd"),
    "fsdp2ep2": (4, {"fsdp": 2, "ep": 2}, 4.0, 0.0, "gspmd"),
    "ep2tp2": (4, {"ep": 2, "tp": 2}, 4.0, 0.0, "gspmd"),
    "fsdp2ep2-deferred": (4, {"fsdp": 2, "ep": 2}, 0.5, AUX, "deferred"),
    "ep2tp2-drops": (4, {"ep": 2, "tp": 2}, 0.5, AUX, "shards"),
}

_WORKER = textwrap.dedent("""
    import dataclasses
    import json
    import pickle
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.models.mixtral import (Mixtral, mixtral_tiny,
                                                  router_load)
    from horovod_tpu_torch.optimizer import deferred_pair, is_expert_param
    from horovod_tpu_torch.parallel import create_mesh, moe, sharding
    from horovod_tpu_torch.train import (create_gspmd_train_state,
                                         make_gspmd_deferred_train_step,
                                         make_gspmd_train_step,
                                         mesh_param_groups, shard_tokens)

    data_dir = sys.argv[1]
    torch.set_num_threads(1)  # six ranks and JAX share the host's cores
    hvd.init(device="cpu")
    rank, n = hvd.rank(), hvd.size()
    cases = json.load(open(f"{data_dir}/cases.json"))
    steps, deferred_steps, every = json.load(open(f"{data_dir}/steps.json"))
    tokens = torch.from_numpy(np.load(f"{data_dir}/tokens.npy"))
    out = {}
    for name, (size, axes, cf, aux, oracle) in cases.items():
        if size != n:
            continue
        cfg = dataclasses.replace(mixtral_tiny(), capacity_factor=cf)
        mesh = create_mesh(axes)
        with open(f"{data_dir}/init.pkl", "rb") as f:
            sd = convert.mixtral_params_from_flax(pickle.load(f), cfg,
                                                  mesh=mesh)
        model = Mixtral(cfg, device="cpu", seed=rank, mesh=mesh)
        model.load_state_dict(sd)
        if oracle == "deferred":
            pair = deferred_pair(1e-3, every=every)
            state = create_gspmd_train_state(model, pair.apply, mesh)
            opt = state.optimizer
            step = make_gspmd_deferred_train_step(model, pair, mesh,
                                                  aux_weight=aux)
            n_steps = deferred_steps
        else:
            opt = hvd.DistributedOptimizer(
                torch.optim.AdamW(mesh_param_groups(model, mesh), lr=1e-3,
                                  weight_decay=1e-4),
                named_parameters=model.named_parameters())
            state = create_gspmd_train_state(model, opt, mesh)
            step = make_gspmd_train_step(model, opt, mesh, aux_weight=aux)
            n_steps = steps
        bank = [p for k, p in model.named_parameters()
                if is_expert_param(k)]
        shard = shard_tokens(tokens, mesh)
        res = {"losses": [], "counts": [], "loads": [], "skips_ok": True}
        for i in range(n_steps):
            before = [p.detach().clone() for p in bank]
            sharding.reset_counts()
            moe.expert_alltoall.launches = 0
            state, loss = step(state, shard)
            res["losses"].append(loss.item())
            res["counts"].append(dict(sharding.counts,
                                      all_to_all=moe.expert_alltoall.launches))
            res["loads"].append(router_load(model))
            if oracle == "deferred" and (i + 1) % every:
                res["skips_ok"] &= all(
                    p.grad is None and torch.equal(p, w)
                    for p, w in zip(bank, before))
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


def _cfgs(capacity_factor):
    j = dataclasses.replace(jmixtral.mixtral_tiny(),
                            capacity_factor=capacity_factor)
    t = dataclasses.replace(tmixtral.mixtral_tiny(),
                            capacity_factor=capacity_factor)
    return j, t


def _tokens():
    return np.random.RandomState(0).randint(0, 255, (4, 32))


def _jax_gspmd(jcfg, axes, toks, init):
    """Three AdamW steps of JAX's GSPMD step on ``axes`` of
    ``jax.devices()[:n]`` from the flax parameters ``init``, laid out by
    ``gspmd_shardings`` as ``create_gspmd_train_state`` lays them out: the
    losses and the final parameters."""
    model = jmixtral.Mixtral(jcfg)
    n = int(np.prod(list(axes.values())))
    mesh = jcreate_mesh(axes, devices=jax.devices()[:n])
    opt = optax.adamw(1e-3)
    toks = jnp.asarray(toks)
    places, _ = gspmd_shardings(model, opt, jax.random.PRNGKey(0), toks,
                                mesh, LOGICAL_RULES)
    params = jax.tree_util.tree_map(jax.device_put, init, places)
    state = GSPMDTrainState(jnp.zeros((), jnp.int32), params,
                            opt.init(params))
    step = make_gspmd_train_step(model, opt, mesh, LOGICAL_RULES)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, toks)
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, state.params)


def _shard_oracle(vg, params, toks, shards, deferred):
    """Steps on the mean over ``shards`` batch shards of JAX's
    single-device value and gradient ``vg``: three of ``optax.adamw``, or
    with ``deferred`` the steps of JAX's ``deferred_pair(every=2)``, its
    skip transform on odd steps and its apply transform on even ones."""
    rows = toks.shape[0] // shards
    pair = jdeferred_pair(1e-3, every=EVERY)
    opt = pair.apply if deferred else optax.adamw(1e-3)
    st = opt.init(params)
    losses = []
    for i in range(DEFERRED_STEPS if deferred else STEPS):
        if deferred:
            opt = pair.skip if (i + 1) % EVERY else pair.apply
        outs = [vg(params, jnp.asarray(toks[j * rows:(j + 1) * rows]))
                for j in range(shards)]
        losses.append(float(np.mean([float(o[0]) for o in outs])))
        g = jax.tree_util.tree_map(lambda *x: sum(x) / shards,
                                   *[o[1] for o in outs])
        updates, st = opt.update(g, st, params)
        params = optax.apply_updates(params, updates)
    return losses, params


def _single_device_vg(jcfg):
    model = jmixtral.Mixtral(jcfg)

    def loss_fn(p, t):
        logits, mods = model.apply({"params": p}, t, mutable=["losses"])
        aux = sum(jnp.sum(v) for v in jax.tree_util.tree_leaves(mods))
        return next_token_loss(logits, t) + AUX * aux

    return jax.jit(jax.value_and_grad(loss_fn))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mixtral_mp")
    toks = _tokens()
    np.save(tmp / "tokens.npy", toks)
    # one flax init serves every case: the capacity factor is not a weight
    jcfg, _ = _cfgs(4.0)
    init = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(
        jmixtral.Mixtral(jcfg).init(jax.random.PRNGKey(0),
                                    jnp.asarray(toks))["params"]))
    with open(tmp / "init.pkl", "wb") as f:
        pickle.dump(init, f)
    (tmp / "cases.json").write_text(json.dumps(CASES))
    (tmp / "steps.json").write_text(json.dumps([STEPS, DEFERRED_STEPS,
                                                EVERY]))
    wait = mp.start_worlds(tmp, _WORKER, (2, 4))
    # JAX's steps while the worlds run
    want, vg = {}, None
    for name, (n, axes, cf, aux, oracle) in CASES.items():
        jcfg, tcfg = _cfgs(cf)
        if oracle == "gspmd":
            losses, params = _jax_gspmd(jcfg, axes, toks, init)
        else:
            vg = vg or _single_device_vg(jcfg)
            shards = axes.get("fsdp", 1) * axes.get("ep", 1)
            losses, params = _shard_oracle(vg, init, toks, shards,
                                           oracle == "deferred")
        want[name] = (losses, {k: v.numpy() for k, v in
                               convert.mixtral_params_from_flax(
                                   params, tcfg).items()})
    wait()
    got = {n: [json.load(open(tmp / f"rank{r}_{n}.json")) for r in range(n)]
           for n in (2, 4)}
    return tmp, got, want


@pytest.mark.parametrize("name", sorted(CASES))
def test_losses_match_jax(worlds, name):
    _, got, want = worlds
    jlosses, _ = want[name]
    for r in got[CASES[name][0]]:
        np.testing.assert_allclose(r[name]["losses"], jlosses, rtol=1e-5)
    assert jlosses[-1] < jlosses[0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_parameters_after_the_steps_match_jax(worlds, name):
    tmp, _, want = worlds
    _, params = want[name]
    got = dict(np.load(tmp / f"{name}.npz"))
    assert sorted(got) == sorted(params)
    for k, w in params.items():
        if CASES[name][4] == "deferred" and is_expert_param(k):
            gap = np.linalg.norm(got[k] - w) / np.linalg.norm(w)
            assert gap < DEFERRED_NORMWISE, (k, gap)
            continue
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_blocks_bit_identical_on_their_holders(world_ranks, name):
    assert [r[name]["differ"] for r in world_ranks(name)] == \
        [0] * CASES[name][0]


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items()
                                        if "tp" in c[1]))
def test_tp_ranks_route_alike(world_ranks, name):
    """The tp ranks of a row see the same tokens and hold the same
    router: their routing counts are equal, step by step."""
    ranks = world_ranks(name)
    for r in ranks:
        peers = [q for q in ranks if all(
            q[name]["coords"][a] == r[name]["coords"][a]
            for a in r[name]["coords"] if a != "tp")]
        assert len(peers) == 2
        assert peers[0][name]["loads"] == peers[1][name]["loads"]


def test_deferred_skip_steps_leave_the_bank(world_ranks):
    ranks = world_ranks("fsdp2ep2-deferred")
    assert all(r["fsdp2ep2-deferred"]["skips_ok"] for r in ranks)


#: The collectives a step of ``mixtral_tiny`` (2 layers, remat off). Under
#: fsdp: 10 sharded parameters a layer (2 norm scales, 4 attention weights,
#: the router and the 3 banks) and the final norm and head, each gathered
#: once and reduce-scattered once. Under ep: 2 all-to-alls a layer forward,
#: 2 backward. Under tp: 1 all-reduce for the embedding, 4 a layer (after
#: ``wo`` and ``w2`` forward, before ``wq``/``wk``/``wv`` and the experts'
#: ``w1``/``w3`` backward), 1 before the head backward and 2 for the loss.
COUNTS = {
    "fsdp2": {"all_gather": 22, "reduce_scatter": 22, "tp_all_reduce": 0,
              "all_to_all": 0},
    "tp2": {"all_gather": 0, "reduce_scatter": 0, "tp_all_reduce": 12,
            "all_to_all": 0},
    "fsdp2ep2": {"all_gather": 22, "reduce_scatter": 22, "tp_all_reduce": 0,
                 "all_to_all": 8},
    "ep2tp2": {"all_gather": 0, "reduce_scatter": 0, "tp_all_reduce": 12,
               "all_to_all": 8},
}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_collectives_per_step(world_ranks, name):
    for r in world_ranks(name):
        assert r[name]["counts"] == [COUNTS[name]] * STEPS


def test_deferred_skip_step_reduces_no_bank(world_ranks):
    """On a skip step the bank takes no gradient: its 3 a layer gathers
    stay, its reduce-scatters go (22 - 6 = 16)."""
    for r in world_ranks("fsdp2ep2-deferred"):
        counts = r["fsdp2ep2-deferred"]["counts"]
        for i, c in enumerate(counts):
            skip = (i + 1) % EVERY
            assert c["all_gather"] == 22
            assert c["reduce_scatter"] == (16 if skip else 22)


@pytest.fixture(scope="module")
def world_ranks(worlds):
    _, got, _ = worlds
    return lambda name: got[CASES[name][0]]


def test_chip_smoke_routing_plan_replays_and_counts():
    """``chip_smoke.py``'s ``routing_plan``, with which its bf16 tp parity
    cells replay the whole model's routing: replaying a model's own plan
    gives bit-identical gradients and counts no flip; a plan that sends
    every token of layer 0 to experts 0 and 1 routes there, with the
    gates of the model's own probabilities (layer 0's router gradient
    moves, the counted flips are the tokens the plan moved)."""
    import importlib.util
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", mp.REPO + "/chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = dataclasses.replace(tmixtral.mixtral_tiny(), capacity_factor=4.0,
                              remat=True)
    model = tmixtral.Mixtral(cfg, seed=0, mesh=None, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)))

    def grads(mode, plan):
        model.zero_grad()
        with cs.routing_plan(torch, model, mode, plan):
            model(tok).square().mean().backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    plan = {}
    ref = grads("record", plan)
    assert sorted(plan) == [0, 1] and plan[0].shape == (64, 2)
    own = dict(plan, flips={})
    for k, g in grads("force", own).items():
        assert torch.equal(g, ref[k]), k
    assert own["flips"] == {0: 0, 1: 0}
    moved = dict(plan, flips={})
    moved[0] = torch.tensor([[0, 1]]).expand(64, 2).contiguous()
    got = grads("force", moved)
    assert model.blocks[0].moe.load[0].tolist() == [64, 64] + [0] * 6
    want = int((plan[0].sort(-1)[0] != moved[0]).any(-1).sum())
    assert moved["flips"][0] == want > 0
    assert not torch.equal(got["blocks.0.moe.router.weight"],
                           ref["blocks.0.moe.router.weight"])
    counted = dict(plan, flips={})
    grads("compare", counted)
    assert counted["flips"] == {0: 0, 1: 0}
