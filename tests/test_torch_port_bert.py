"""The port's BERT against the JAX package's, on the CPU.

``bert_tiny`` flax parameters are carried across by
``horovod_tpu_torch.convert``; the same tokens and a ragged key-padding mask
(rows of different real lengths), made from a seed with numpy, go through
both models, in f32. Logits and every parameter's gradient agree within
1e-4 and the loss within 1e-5 (summation order only), with flash attention
off on both sides, and with it on on both: the JAX kernels in Pallas
interpret mode, the port's wrappers through their plain versions (the
tensors lie on the CPU).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import bert as jbert
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import bert as tbert
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.train import masked_label_loss, mlm_loss

TOL = 1e-4


def _inputs(seed=0, B=3, T=24, vocab=256):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (B, T))
    lengths = np.array([T, T - 7, 5])[:B]
    mask = np.arange(T)[None, :] < lengths[:, None]
    raw = rng.randint(0, vocab, (B, T))
    picked = (rng.rand(B, T) < 0.3) & mask
    labels = np.where(picked, raw, -1)
    return tokens, mask, labels


def _models(use_flash):
    jcfg = dataclasses.replace(jbert.bert_tiny(), use_flash=use_flash)
    tokens, mask, _ = _inputs()
    jmodel = jbert.Bert(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens),
                         jnp.asarray(mask), train=False)
    # Move the LayerNorm parameters off their ones and zeros.
    rng = np.random.RandomState(7)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(
            *np.shape(a)).astype(np.float32)), params)
    tcfg = dataclasses.replace(tbert.bert_tiny(), use_flash=use_flash)
    tmodel = tbert.Bert(tcfg, device="cpu")
    tmodel.load_state_dict(convert.bert_params_from_flax(params, tcfg))
    return jmodel, params, tmodel, tcfg


def _jax_masked_loss(logits, y):
    """``benchmarks/bert.py``'s loss: -1 labels carry the mask."""
    valid = y >= 0
    ce = optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.maximum(y, 0))
    return (ce * valid).sum() / jnp.maximum(valid.sum(), 1)


def _close(what, got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("use_flash", [False, True])
def test_logits_loss_and_gradients_match_flax(use_flash, monkeypatch):
    jmodel, params, tmodel, tcfg = _models(use_flash)
    tokens, mask, labels = _inputs(1)

    def jloss(p):
        logits = jmodel.apply(p, jnp.asarray(tokens), jnp.asarray(mask),
                              train=True)
        return _jax_masked_loss(logits, jnp.asarray(labels)), logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    calls = []
    real = fa._FlashAttention.apply
    monkeypatch.setattr(fa._FlashAttention, "apply",
                        lambda *a: calls.append(a[4]) or real(*a))
    logits = tmodel(torch.from_numpy(tokens), torch.from_numpy(mask))
    loss = masked_label_loss(logits, torch.from_numpy(labels))
    loss.backward()
    # Flash on: each layer's attention went through the kernels' wrapper,
    # not causal.
    assert calls == ([False] * tcfg.n_layers if use_flash else [])
    assert logits.dtype == torch.float32
    _close("logits", logits.detach().numpy(), jlogits)
    _close("loss", loss.item(), float(jl), tol=1e-5)
    want = convert.bert_params_from_flax(jg, tcfg)
    for name, p in tmodel.named_parameters():
        _close(f"grad {name}", p.grad.numpy(), want[name].numpy())


def test_padded_keys_do_not_reach_the_real_tokens():
    """Changing the tokens under the padding leaves every real position's
    logits as they were, on both attention paths."""
    _, _, tmodel, _ = _models(False)
    tokens, mask, _ = _inputs(2)
    other = np.where(mask, tokens, (tokens + 1) % 256)
    for flash in (False, True):
        tmodel.cfg = dataclasses.replace(tmodel.cfg, use_flash=flash)
        for layer in tmodel.layers:
            layer.c = tmodel.cfg
        with torch.no_grad():
            a = tmodel(torch.from_numpy(tokens), torch.from_numpy(mask))
            b = tmodel(torch.from_numpy(other), torch.from_numpy(mask))
        m = torch.from_numpy(mask)
        torch.testing.assert_close(a[m], b[m], rtol=1e-5, atol=1e-5)


def test_mlm_losses_match_the_reference():
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 9, 31).astype(np.float32) * 3
    labels = rng.randint(0, 31, (2, 9))
    mask = rng.rand(2, 9) < 0.4
    want = jbert.mlm_loss(jnp.asarray(logits), jnp.asarray(labels),
                          jnp.asarray(mask))
    got = mlm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                   torch.from_numpy(mask))
    _close("mlm_loss", got.item(), float(want), tol=1e-6)
    assert tbert.mlm_loss is mlm_loss
    y = np.where(mask, labels, -1)
    want = _jax_masked_loss(jnp.asarray(logits), jnp.asarray(y))
    got = masked_label_loss(torch.from_numpy(logits), torch.from_numpy(y))
    _close("masked label loss", got.item(), float(want), tol=1e-6)
    # No position selected: 0, not NaN, as the reference's max(sum, 1).
    none = torch.zeros(2, 9, dtype=torch.bool)
    assert mlm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                    none).item() == 0.0


def test_converters_round_trip():
    _, params, tmodel, tcfg = _models(False)
    back = convert.bert_params_to_flax(tmodel.state_dict(), tcfg)
    p = nn.meta.unbox(params["params"])  # the logical-partitioning boxes
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(p))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("n_layers", [1, 2])
def test_bert_large_widths_have_the_reference_parameter_count(n_layers):
    """BERT-Large's widths in both packages, cut to one and two layers so the
    port's side fits the test's memory, counted from shapes on the JAX side
    (no token-type embedding: the JAX model declares ``type_vocab`` and
    never uses it)."""
    jcfg = dataclasses.replace(jbert.bert_large(), n_layers=n_layers)
    shapes = jax.eval_shape(lambda: jbert.Bert(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), train=False))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes))
    cfg = dataclasses.replace(tbert.bert_large(), n_layers=n_layers)
    model = tbert.Bert(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == want
