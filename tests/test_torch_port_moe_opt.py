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
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

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
