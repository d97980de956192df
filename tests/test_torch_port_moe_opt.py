"""The port's MoE optimizer levers against the JAX package's
``optimizer/moe_opt.py`` and optax, on the CPU.

- ``_stochastic_round`` is bit-equal to JAX's given the same
  ``jax.random.bits`` noise, and unbiased.
- Every ``moe_adamw`` variant ("adamw", "bf16_nu", "bf16_munu",
  "factored", "deferred") and ``deferred_pair`` track optax over 5 steps of
  the same seeded gradients within 1e-5 (absolute and relative). The bf16
  variants run with stochastic rounding off on both sides (the noise
  streams differ); a bf16 moment that lands one ulp apart moves an update by
  about 0.4 % of lr = 1e-3, inside the tolerance. The factored case has an
  expert tensor whose two largest dims reach 128, so optax factors it.
- On the deferred pair's skip steps the bank's ``.grad`` is None and its
  parameters and state do not change; a learning-rate schedule raises.
- The factored variant on an expert bank split over ``{"ep": 2}`` and
  ``{"fsdp": 2, "ep": 2}`` (gloo worlds of 2 and 4, started side by side)
  tracks optax on the whole bank within 1e-5: optax applies the factored
  means and both block RMS rules to the whole tensor.
"""

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_mp as mp
from horovod_tpu.optimizer import moe_opt as jopt

from horovod_tpu_torch.optimizer import moe_opt as topt

SHAPES = {"dense": (16, 8), "moe.w1": (2, 128, 160), "moe.w2": (2, 8, 4)}
LR = 1e-3
STEPS = 5


def _params():
    rng = np.random.RandomState(0)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(step):
    rng = np.random.RandomState(100 + step)
    return {k: (0.1 * rng.randn(*s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _tree(flat):
    """The port's names -> the JAX package's nested tree (``moe/w1``)."""
    return {"dense": jnp.asarray(flat["dense"]),
            "moe": {"w1": jnp.asarray(flat["moe.w1"]),
                    "w2": jnp.asarray(flat["moe.w2"])}}


def _flat(tree):
    return {"dense": np.asarray(tree["dense"]),
            "moe.w1": np.asarray(tree["moe"]["w1"]),
            "moe.w2": np.asarray(tree["moe"]["w2"])}


def _torch_params():
    return {k: torch.nn.Parameter(torch.from_numpy(v))
            for k, v in _params().items()}


def test_stochastic_round_is_bit_equal_given_the_same_noise():
    rng = np.random.RandomState(5)
    x = np.concatenate([rng.randn(4000).astype(np.float32) * 10 ** e
                        for e in (-6, 0, 6)]).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jopt._stochastic_round(key, jnp.asarray(x), jnp.bfloat16)
    noise = np.asarray(jax.random.bits(key, shape=x.shape, dtype=jnp.uint32))
    got = topt._stochastic_round(torch.from_numpy(x), torch.bfloat16,
                                 noise=torch.from_numpy(noise.astype(
                                     np.int64)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(want).view(np.int16))


def test_stochastic_round_is_unbiased():
    x = torch.full((4096,), 1.0 + 2e-3)   # bf16 ulp at 1.0: 2^-8
    gen = torch.Generator().manual_seed(0)
    out = topt._stochastic_round(x, torch.bfloat16, gen).float()
    assert abs(out.mean().item() - (1.0 + 2e-3)) < 5e-4
    assert len(torch.unique(out)) == 2   # it straddles


def _jax_variant(variant):
    if variant in ("bf16_nu", "bf16_munu"):
        mu = jnp.bfloat16 if variant == "bf16_munu" else None
        expert = jopt.adamw_low_precision(LR, mu_dtype=mu,
                                          nu_dtype=jnp.bfloat16,
                                          stochastic_rounding=False)
        return jopt.partition({"dense": optax.adamw(LR), "expert": expert},
                              lambda p: "expert" if jopt.is_expert_param(p)
                              else "dense")
    return jopt.moe_adamw(LR, expert_variant=variant)


def _torch_variant(variant):
    if variant in ("bf16_nu", "bf16_munu"):
        mu = torch.bfloat16 if variant == "bf16_munu" else None
        expert = topt.adamw_low_precision(LR, mu_dtype=mu,
                                          nu_dtype=torch.bfloat16,
                                          stochastic_rounding=False)
        return topt.partition({"dense": topt.adamw(LR), "expert": expert},
                              lambda n: "expert" if topt.is_expert_param(n)
                              else "dense")
    return topt.moe_adamw(LR, expert_variant=variant)


@pytest.mark.parametrize("variant", ["adamw", "bf16_nu", "bf16_munu",
                                     "factored", "deferred"])
def test_moe_adamw_variant_tracks_optax(variant):
    tx = _jax_variant(variant)
    params = _tree(_params())
    state = tx.init(params)
    tp = _torch_params()
    opt = topt.optimizer_for(_torch_variant(variant), tp.items())
    for step in range(STEPS):
        g = _grads(step)
        updates, state = tx.update(_tree(g), state, params)
        params = optax.apply_updates(params, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, want in _flat(params).items():
            np.testing.assert_allclose(tp[k].detach().numpy(), want,
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {step} {k}")
    if variant.startswith("bf16"):
        st = opt.state[tp["moe.w1"]]
        assert st["exp_avg_sq"].dtype == torch.bfloat16
        assert st["exp_avg"].dtype == (torch.bfloat16 if variant ==
                                       "bf16_munu" else torch.float32)
    if variant == "factored":
        assert "v_row" in opt.state[tp["moe.w1"]]     # factored
        assert "v" in opt.state[tp["moe.w2"]]         # too small to factor


def test_deferred_pair_tracks_optax_and_freezes_the_bank():
    jpair = jopt.deferred_pair(LR, every=4)
    params = _tree(_params())
    state = jpair.apply.init(params)
    pair = topt.deferred_pair(LR, every=4)
    tp = _torch_params()
    opt = topt.optimizer_for(pair.apply, tp.items())
    assert pair.skip.transforms["expert"]["frozen"]
    for step in range(1, 2 * 4 + 1):
        g = _grads(step)
        skip = step % jpair.every != 0
        tx = jpair.skip if skip else jpair.apply
        updates, state = tx.update(_tree(g), state, params)
        params = optax.apply_updates(params, updates)
        before = {k: (tp[k].detach().clone(),
                      {s: v.clone() for s, v in opt.state[tp[k]].items()
                       if torch.is_tensor(v)})
                  for k in ("moe.w1", "moe.w2")}
        for k, p in tp.items():
            # what make_gspmd_deferred_train_step does on a skip step
            p.grad = None if skip and topt.is_expert_param(k) else \
                torch.from_numpy(g[k])
        opt.step()
        for k, want in _flat(params).items():
            np.testing.assert_allclose(tp[k].detach().numpy(), want,
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {step} {k}")
        if skip:
            for k, (w, st) in before.items():
                assert tp[k].grad is None
                assert torch.equal(tp[k], w)
                for s, v in st.items():
                    assert torch.equal(opt.state[tp[k]][s], v)


def test_schedule_raises():
    with pytest.raises(ValueError, match="constant learning rate"):
        topt.deferred_pair(lambda step: 1e-3)
    with pytest.raises(ValueError, match="constant learning rate"):
        topt.moe_adamw(lambda step: 1e-3, expert_variant="deferred")
    with pytest.raises(ValueError, match="unknown expert_variant"):
        topt.moe_adamw(1e-3, expert_variant="sgd")


def test_low_precision_adam_tracks_f32_adam():
    """bf16-stored moments with stochastic rounding stay close to exact f32
    Adam over a short run, as the JAX package's test of the same name."""
    ref, lp = {}, {}
    gen = torch.Generator().manual_seed(0)
    for i in range(10):
        g = torch.from_numpy(_grads(i)["moe.w2"])
        u_ref = topt.scale_by_adam_low_precision(g, ref)
        u_lp = topt.scale_by_adam_low_precision(
            g, lp, mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16,
            generator=gen)
    np.testing.assert_allclose(u_lp.numpy(), u_ref.numpy(), rtol=0.06,
                               atol=0.02)
    assert lp["exp_avg"].dtype == lp["exp_avg_sq"].dtype == torch.bfloat16


def test_is_expert_param_on_the_port_names():
    for name in ("blocks.0.moe.w1", "blocks.3.moe.w2", "moe.w3",
                 "block_0/moe/w1"):
        assert topt.is_expert_param(name)
    for name in ("blocks.0.moe.router.weight", "blocks.0.mlp.w1.weight",
                 "blocks.0.attn.wq.weight", "embedding"):
        assert not topt.is_expert_param(name)


# -------------------------------------- Adafactor on a sharded expert bank

#: The bank of the sharded Adafactor worlds, whole, and its logical names.
#: Under fsdp the bank's D = 192 splits to 96, under the 128 of
#: ``min_dim_size_to_factor``: a block would not be factored at all, where
#: optax factors the whole bank over its two largest dims (192, 160). The
#: second expert is drawn 4 times larger, so the RMS of one expert's block
#: is not the bank's.
BANK = {"moe.w1": ((2, 192, 160), ("experts", "embed", "mlp")),
        "moe.w2": ((2, 8, 4), ("experts", "mlp", "embed")),
        "dense": ((16, 8), (None, None))}
SHARDED_MESHES = {2: [{"ep": 2}], 4: [{"fsdp": 2, "ep": 2}]}

_ADAFACTOR_WORKER = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.optimizer import moe_opt
    from horovod_tpu_torch.parallel import create_mesh, sharding

    data_dir = sys.argv[1]
    hvd.init(device="cpu")
    rank, n = hvd.rank(), hvd.size()
    bank = json.load(open(f"{data_dir}/bank.json"))
    d = dict(np.load(f"{data_dir}/bank.npz"))
    out = {}
    for axes in json.load(open(f"{data_dir}/meshes{n}.json")):
        mesh = create_mesh(axes)
        name = "-".join(f"{a}{s}" for a, s in axes.items())
        params, places = {}, {}
        for k, (shape, names) in bank.items():
            place = sharding.placement(mesh, names, shape)
            p = torch.nn.Parameter(
                place.block(torch.from_numpy(d[f"param-{k}"])).clone())
            sharding.set_placement(p, place)
            params[k], places[k] = p, place
        opt = moe_opt.optimizer_for(
            moe_opt.moe_adamw(1e-3, expert_variant="factored"),
            params.items())
        for step in range(int(d["steps"])):
            for k, p in params.items():
                p.grad = places[k].block(
                    torch.from_numpy(d[f"grad{step}-{k}"])).clone()
            opt.step()
        for k, p in params.items():
            out[f"{name}-{k}"] = p.detach().numpy().copy()
            out[f"{name}-{k}-start"] = np.asarray(
                [a.index * (s // a.size) if a is not None else 0
                 for s, a in zip(places[k].shape, places[k].axes)])
    np.savez(f"{data_dir}/rank{rank}_{n}.npz", **out)
    hvd.shutdown()
""")


@pytest.fixture(scope="module")
def sharded_adafactor(tmp_path_factory):
    """Five Adafactor steps (``moe_adamw(expert_variant="factored")``) of
    :data:`BANK` on each mesh of :data:`SHARDED_MESHES`, every rank
    holding its block, in gloo worlds of 2 and 4 started side by side;
    beside optax's on the whole tensors."""
    import json

    tmp = tmp_path_factory.mktemp("adafactor_worlds")
    rng = np.random.RandomState(3)
    d = {"steps": np.asarray(STEPS)}
    for k, (shape, _) in BANK.items():
        w = rng.randn(*shape).astype(np.float32)
        if k.startswith("moe"):
            w[1] *= 4.0
        d[f"param-{k}"] = w
        for s in range(STEPS):
            d[f"grad{s}-{k}"] = (0.1 * rng.randn(*shape)).astype(np.float32)
    np.savez(tmp / "bank.npz", **d)
    (tmp / "bank.json").write_text(json.dumps(BANK))
    for n, meshes in SHARDED_MESHES.items():
        (tmp / f"meshes{n}.json").write_text(json.dumps(meshes))
    wait = mp.start_worlds(tmp, _ADAFACTOR_WORKER, SHARDED_MESHES)
    # optax on the whole tensors, while the worlds run
    tx = jopt.moe_adamw(LR, expert_variant="factored")
    params = {"dense": jnp.asarray(d["param-dense"]),
              "moe": {"w1": jnp.asarray(d["param-moe.w1"]),
                      "w2": jnp.asarray(d["param-moe.w2"])}}
    state = tx.init(params)
    for s in range(STEPS):
        g = {"dense": jnp.asarray(d[f"grad{s}-dense"]),
             "moe": {"w1": jnp.asarray(d[f"grad{s}-moe.w1"]),
                     "w2": jnp.asarray(d[f"grad{s}-moe.w2"])}}
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
    wait()
    got = {n: [dict(np.load(tmp / f"rank{r}_{n}.npz")) for r in range(n)]
           for n in SHARDED_MESHES}
    return got, _flat(params)


@pytest.mark.parametrize("n,axes", [(n, a) for n, ms in SHARDED_MESHES.items()
                                    for a in ms],
                         ids=["ep2", "fsdp2-ep2"])
def test_factored_on_a_sharded_bank_tracks_optax_on_the_whole(
        sharded_adafactor, n, axes):
    """optax applies the factored moments' means and both block RMS rules
    (``clip_by_block_rms``, ``scale_by_param_block_rms``) to each whole
    tensor; every rank's block after 5 steps must be that block of optax's
    result, within 1e-5 (absolute and relative), on ``{"ep": 2}`` and on
    ``{"fsdp": 2, "ep": 2}``."""
    got, want = sharded_adafactor
    name = "-".join(f"{a}{s}" for a, s in axes.items())
    for r, res in enumerate(got[n]):
        for k, w in want.items():
            block = res[f"{name}-{k}"]
            idx = tuple(slice(int(a), int(a) + b) for a, b in
                        zip(res[f"{name}-{k}-start"], block.shape))
            np.testing.assert_allclose(block, w[idx], rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} {k}")
