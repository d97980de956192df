"""Remat, scan layout, tied embeddings and the config fields of the port's
Llama and BERT against the JAX package's, on the CPU.

- Each remat arm of ``with_remat_policy`` (``none``, ``dots``,
  ``dots_attn``, ``attn``, ``full``) gives ``llama_tiny`` the loss and
  gradients of remat off bit for bit: the recompute repeats the same CPU
  arithmetic, and a saved output is the same tensor.
- B1's custom op (``hvd::fa_fwd``) runs per step, with ``use_flash=True``
  (on the CPU the op is B1's plain version): twice a layer under ``dots``
  and ``full`` (the forward, then the recompute), once under ``none``,
  ``dots_attn`` and ``attn``, whose policies save its outputs as JAX's save
  ``attn_out``, ``attn_lse_m`` and ``attn_lse_l``. The materialised
  branch's context op (``hvd::attn_context``, JAX's ``attn_out`` tag) runs
  the same number of times.
- ``with_remat_policy`` and the policy check raise JAX's errors, word for
  word; the configs carry JAX's fields and defaults.
- ``tie_embeddings``: logits and gradients against JAX's ``Llama`` with
  ``tie_embeddings=True`` within 1e-4 (f32, summation order only, the
  tolerance of ``tests/test_torch_port_llama.py``), weights carried by
  ``convert.py`` both ways.
- BERT-tiny with ``remat=True`` against JAX's with ``remat=True``: logits
  and gradients within 1e-4, the loss within 1e-5 (the tolerances of
  ``tests/test_torch_port_bert.py``).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from horovod_tpu.models import bert as jbert
from horovod_tpu.models import llama as jllama
from horovod_tpu.train.gspmd import next_token_loss as j_next_token_loss
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import bert as tbert
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.train import masked_label_loss, next_token_loss

ARMS = ("none", "dots", "dots_attn", "attn", "full")
#: B1 runs per layer per step under each arm.
B1_PER_LAYER = {"none": 1, "dots": 2, "dots_attn": 1, "attn": 1, "full": 2}
TOL = 1e-4


def _close(what, got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _tokens(seed=0, B=2, T=16, vocab=256):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, vocab,
                                                                (B, T)))


class _CountOp(TorchDispatchMode):
    """Counts the runs of one op (a saved output replayed by a
    selective-checkpoint recompute does not run it)."""

    def __init__(self, op):
        super().__init__()
        self.op, self.n = op, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func == self.op
        return func(*args, **(kwargs or {}))


def _step_grads(arm, use_flash, op=None):
    """Loss and gradients of one step of ``llama_tiny`` under ``arm``, and
    the runs of ``op`` in it."""
    cfg = tllama.with_remat_policy(
        dataclasses.replace(tllama.llama_tiny(), use_flash=use_flash), arm)
    model = tllama.Llama(cfg, device="cpu", seed=0)
    tokens = _tokens()
    counter = _CountOp(op)
    with counter:
        loss = next_token_loss(model(tokens), tokens)
        loss.backward()
    return (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
            counter.n)


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("arm", ARMS)
def test_remat_arm_gradients_equal_remat_off(arm, use_flash):
    loss, grads, _ = _step_grads(arm, use_flash)
    want_loss, want, _ = _step_grads("none", use_flash)
    assert torch.equal(loss, want_loss)
    assert grads.keys() == want.keys()
    for name, g in grads.items():
        assert torch.equal(g, want[name]), name


@pytest.mark.parametrize("arm", ARMS)
def test_b1_calls_per_step_under_each_arm(arm):
    layers = tllama.llama_tiny().n_layers
    fa.reset_launch_counts()
    _, _, runs = _step_grads(arm, True, torch.ops.hvd.fa_fwd.default)
    assert fa.fa_fwd.calls == B1_PER_LAYER[arm] * layers
    assert runs == fa.fa_fwd.calls
    assert fa.fa_fwd.launches == 0  # the CPU runs no kernel


@pytest.mark.parametrize("arm", ARMS)
def test_materialised_context_is_saved_like_b1(arm):
    layers = tllama.llama_tiny().n_layers
    _, _, runs = _step_grads(arm, False, torch.ops.hvd.attn_context.default)
    assert runs == B1_PER_LAYER[arm] * layers


def test_remat_policy_vocabulary_and_errors_match_jax():
    assert set(tllama._REMAT_POLICIES) == set(jllama._REMAT_POLICIES)
    for arm in ARMS:
        got = tllama.with_remat_policy(tllama.llama3_8b(), arm)
        want = jllama.with_remat_policy(jllama.llama3_8b(), arm)
        assert (got.remat, got.remat_policy) == (want.remat,
                                                 want.remat_policy)
    messages = []
    for mod in (jllama, tllama):
        with pytest.raises(ValueError) as e:
            mod.with_remat_policy(mod.llama_tiny(), "dot")
        messages.append(str(e.value))
        with pytest.raises(ValueError) as e:
            mod._remat(None, "dot")
        messages.append(str(e.value))
    assert messages[:2] == messages[2:]
    cfg = dataclasses.replace(tllama.llama_tiny(), remat=True,
                              remat_policy="dot")
    with pytest.raises(ValueError, match=r"remat_policy 'dot' not in"):
        tllama.Llama(cfg, device="cpu")(_tokens())


FIELDS = ("remat", "remat_policy", "scan_layers", "tie_embeddings",
          "attention_impl", "use_flash")


@pytest.mark.parametrize("make", ["llama3_8b", "llama_tiny", "bert_large",
                                  "bert_tiny"])
def test_configs_carry_the_jax_fields_and_defaults(make):
    jmod, tmod = ((jllama, tllama) if make.startswith("llama")
                  else (jbert, tbert))
    want = dataclasses.asdict(getattr(jmod, make)())
    got = dataclasses.asdict(getattr(tmod, make)())
    fields = [f for f in FIELDS if f in want]
    assert {f: got[f] for f in fields} == {f: want[f] for f in fields}
    assert len(fields) == (6 if make.startswith("llama") else 3)


@pytest.mark.parametrize("n_layers, scan, want", [
    (2, "auto", False), (8, "auto", False), (9, "auto", True),
    (32, "auto", True), (32, False, False), (2, True, True)])
def test_scan_layers_chooses_the_checkpoint_layout(n_layers, scan, want):
    """``resolve_scan_layers`` as JAX's, and ``convert`` writes the layout
    it names when none is given."""
    tcfg = dataclasses.replace(tllama.llama_tiny(), n_layers=n_layers,
                               scan_layers=scan)
    jcfg = dataclasses.replace(jllama.llama_tiny(), n_layers=n_layers,
                               scan_layers=scan)
    assert tllama.SCAN_LAYERS_AUTO_THRESHOLD == \
        jllama.SCAN_LAYERS_AUTO_THRESHOLD
    assert tllama.resolve_scan_layers(tcfg) is jllama.resolve_scan_layers(
        jcfg) is want
    sd = tllama.Llama(tcfg, device="cpu").state_dict()
    tree = convert.llama_params_to_flax(sd, tcfg)
    assert ("layers" in tree) is want
    assert ("block_0" in tree) is not want


def _tied_models():
    jcfg = dataclasses.replace(jllama.llama_tiny(), tie_embeddings=True)
    jmodel = jllama.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.asarray(_tokens().numpy()))
    tcfg = dataclasses.replace(tllama.llama_tiny(), tie_embeddings=True)
    tmodel = tllama.Llama(tcfg, device="cpu")
    tmodel.load_state_dict(convert.llama_params_from_flax(params, tcfg))
    return jmodel, params, tmodel


def test_tied_embeddings_logits_and_gradients_match_jax():
    jmodel, params, tmodel = _tied_models()
    assert "lm_head" not in nn.meta.unbox(params)["params"]
    assert tmodel.lm_head is None
    assert not any(n.startswith("lm_head") for n in tmodel.state_dict())
    tokens = _tokens(2)
    jt = jnp.asarray(tokens.numpy())

    def jloss(p):
        logits = jmodel.apply(p, jt)
        return j_next_token_loss(logits, jt), logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    logits = tmodel(tokens)
    loss = next_token_loss(logits, tokens)
    loss.backward()
    _close("logits", logits.detach().numpy(), jlogits)
    _close("loss", loss.item(), float(jl))
    grads = convert.llama_params_to_flax(
        {n: p.grad for n, p in tmodel.named_parameters()}, tmodel.cfg)
    jflat = jax.tree_util.tree_leaves_with_path(nn.meta.unbox(jg)["params"])
    tflat = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert len(jflat) == len(tflat)
    for path, g in jflat:
        _close(jax.tree_util.keystr(path), tflat[path], g)


def test_tied_embeddings_convert_round_trip():
    _, params, tmodel = _tied_models()
    back = convert.llama_params_to_flax(tmodel.state_dict(), tmodel.cfg)
    want = jax.tree_util.tree_leaves_with_path(
        nn.meta.unbox(params)["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(want) == len(got)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


def test_bert_tiny_with_remat_matches_jax():
    jcfg = dataclasses.replace(jbert.bert_tiny(), remat=True)
    rng = np.random.RandomState(1)
    B, T = 3, 24
    tokens = rng.randint(0, 256, (B, T))
    mask = np.arange(T)[None, :] < np.array([T, T - 7, 5])[:, None]
    labels = np.where((rng.rand(B, T) < 0.3) & mask,
                      rng.randint(0, 256, (B, T)), -1)
    jmodel = jbert.Bert(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens),
                         jnp.asarray(mask), train=False)

    def jloss(p):
        logits = jmodel.apply(p, jnp.asarray(tokens), jnp.asarray(mask),
                              train=True)
        y = jnp.asarray(labels)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.maximum(y, 0))
        valid = y >= 0
        return (ce * valid).sum() / jnp.maximum(valid.sum(), 1), logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tcfg = dataclasses.replace(tbert.bert_tiny(), remat=True)
    tmodel = tbert.Bert(tcfg, device="cpu")
    tmodel.load_state_dict(convert.bert_params_from_flax(params, tcfg))
    logits = tmodel(torch.from_numpy(tokens), torch.from_numpy(mask))
    loss = masked_label_loss(logits, torch.from_numpy(labels))
    loss.backward()
    _close("logits", logits.detach().numpy(), jlogits)
    _close("loss", loss.item(), float(jl), tol=1e-5)
    want = convert.bert_params_from_flax(jg, tcfg)
    for name, p in tmodel.named_parameters():
        _close(f"grad {name}", p.grad.numpy(), want[name].numpy())
