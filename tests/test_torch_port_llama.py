"""The port's Llama against the JAX package's, on the CPU.

``llama_tiny`` flax parameters are carried across by
``horovod_tpu_torch.convert``; the same tokens, made from a seed with numpy,
go through both models. The configuration is f32, so logits, the loss and
every parameter's gradient must agree within 1e-4 (summation order only).
Each place where a port of this model is likely to go wrong (GQA, RoPE,
RMSNorm, bf16 dense layers) has a test of its own.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jllama
from horovod_tpu.train.gspmd import next_token_loss as j_next_token_loss
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import _flash
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.train import next_token_loss

TOL = 1e-4
LAYOUTS = ("unrolled", "scanned")


def _tokens(seed=0, B=2, T=16, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (B, T))


def _jax_model(layout):
    cfg = dataclasses.replace(jllama.llama_tiny(),
                              scan_layers=layout == "scanned")
    model = jllama.Llama(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(_tokens()))
    return model, params


def _port_model(params, use_flash):
    cfg = dataclasses.replace(tllama.llama_tiny(), use_flash=use_flash)
    model = tllama.Llama(cfg, device="cpu")
    model.load_state_dict(convert.llama_params_from_flax(params, cfg))
    return model


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_logits_match(layout, use_flash):
    jmodel, params = _jax_model(layout)
    tokens = _tokens(1)
    want = jmodel.apply(params, jnp.asarray(tokens))
    got = _port_model(params, use_flash)(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    _close(got.detach().numpy(), want)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_loss_and_gradients_match(layout, use_flash):
    jmodel, params = _jax_model(layout)
    tokens = _tokens(2)

    def jloss(p):
        return j_next_token_loss(jmodel.apply(p, jnp.asarray(tokens)),
                                 jnp.asarray(tokens))

    jl, jg = jax.value_and_grad(jloss)(params)
    model = _port_model(params, use_flash)
    t = torch.from_numpy(tokens)
    loss = next_token_loss(model(t), t)
    loss.backward()
    _close(loss.item(), jl)
    grads = convert.llama_params_to_flax(
        {n: p.grad for n, p in model.named_parameters()}, model.cfg,
        scanned=layout == "scanned")
    jflat = jax.tree_util.tree_leaves_with_path(nn.meta.unbox(jg)["params"])
    tflat = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert len(jflat) == len(tflat)
    for path, g in jflat:
        _close(tflat[path], g)


def test_masked_loss_matches():
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 8, 32).astype(np.float32)
    tokens = rng.randint(0, 32, (2, 8))
    mask = rng.rand(2, 8) > 0.3
    want = j_next_token_loss(jnp.asarray(logits), jnp.asarray(tokens),
                             jnp.asarray(mask))
    got = next_token_loss(torch.from_numpy(logits), torch.from_numpy(tokens),
                          torch.from_numpy(mask))
    _close(got.item(), want, tol=1e-6)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_convert_round_trip(layout):
    _, params = _jax_model(layout)
    cfg = tllama.llama_tiny()
    back = convert.llama_params_to_flax(
        convert.llama_params_from_flax(params, cfg), cfg,
        scanned=layout == "scanned")
    want = jax.tree_util.tree_leaves_with_path(nn.meta.unbox(params)["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(want) == len(got)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


def test_gqa_is_repeat_interleave():
    """``jnp.repeat(k, rep, axis=2)`` repeats each KV head in a row; the
    port's ``repeat_interleave`` matches it and ``Tensor.repeat`` would
    not."""
    k = np.random.RandomState(4).randn(1, 3, 2, 4).astype(np.float32)
    want = np.asarray(jnp.repeat(jnp.asarray(k), 4, axis=2))
    got = torch.repeat_interleave(torch.from_numpy(k), 4, dim=2).numpy()
    np.testing.assert_array_equal(got, want)
    tiled = torch.from_numpy(k).repeat(1, 1, 4, 1).numpy()
    assert not np.array_equal(tiled, want)


def test_rope_rotates_halves_like_jax():
    x = np.random.RandomState(5).randn(2, 7, 3, 16).astype(np.float32)
    pos = np.arange(7)[None, :]
    want = jllama.rope(jnp.asarray(x), jnp.asarray(pos), 5e5)
    got = tllama.rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5)
    _close(got.numpy(), want, tol=1e-6)


def test_rmsnorm_matches_flax_in_bf16():
    """f32 statistics and f32 scale, then one cast to bf16: the outputs are
    the same bf16 values."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 5, 32).astype(np.float32)
    scale = rng.randn(32).astype(np.float32)
    want = jllama.RMSNorm(1e-5, jnp.bfloat16).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
    norm = tllama.RMSNorm(32, 1e-5, torch.bfloat16, "cpu")
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
    got = norm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))


def test_dense_casts_like_flax_dense_bf16():
    """``nn.Dense(dtype=bf16)`` casts input and kernel to bf16 and returns
    bf16; within one bf16 ulp (2^-7 relative) of each other."""
    rng = np.random.RandomState(7)
    x = rng.randn(4, 32).astype(np.float32)
    w = rng.randn(32, 8).astype(np.float32) / 6
    want = nn.Dense(8, use_bias=False, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(w)}}, jnp.asarray(x))
    dense = tllama.Dense(32, 8, torch.bfloat16, "cpu")
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(w.T))
    got = dense(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    ref = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), ref,
                               atol=2 ** -7 * np.abs(ref).max())


def test_resolve_flash_order(monkeypatch):
    """Explicit flag, then ``HOROVOD_FLASH_ATTENTION``, then automatic:
    kernels for CUDA tensors at T >= 128 (the crossover measured on the
    H100), the plain path on the CPU."""
    monkeypatch.delenv("HOROVOD_FLASH_ATTENTION", raising=False)
    assert _flash.AUTO_MIN_SEQ == 128
    assert _flash.resolve_flash(None, 4096, "cpu") is False
    assert _flash.resolve_flash(None, 4096, "cuda") is True
    assert _flash.resolve_flash(None, 128, "cuda") is True
    assert _flash.resolve_flash(None, 127, "cuda") is False
    assert _flash.resolve_flash(True, 16, "cpu") is True
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "1")
    assert _flash.resolve_flash(None, 16, "cpu") is True
    assert _flash.resolve_flash(False, 4096, "cuda") is False
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "0")
    assert _flash.resolve_flash(None, 4096, "cuda") is False


def test_bf16_embedding_and_lm_head_match_jax_casts():
    """The f32 table is gathered, then cast to bf16; the LM head takes bf16
    inputs and returns f32 logits accumulated in f32 with no bf16 rounding,
    as JAX's head: per element within 1e-5 (|ref| + RMS(ref)), summation
    order only."""
    rng = np.random.RandomState(8)
    table = rng.randn(256, 64).astype(np.float32)
    tokens = rng.randint(0, 256, (2, 5))
    cfg = dataclasses.replace(tllama.llama_tiny(), dtype=torch.bfloat16)
    model = tllama.Llama(cfg, device="cpu")
    with torch.no_grad():
        model.embedding.copy_(torch.from_numpy(table))
    got = model.embedding[torch.from_numpy(tokens)].to(cfg.dtype).detach()
    want = jnp.take(jnp.asarray(table), jnp.asarray(tokens),
                    axis=0).astype(jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    x = rng.randn(2, 5, 64).astype(np.float32)
    w = (rng.randn(64, 256) / 8).astype(np.float32)
    want = jnp.einsum("btd,dv->btv", jnp.asarray(x).astype(jnp.bfloat16),
                      jnp.asarray(w).astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)
    with torch.no_grad():
        model.lm_head.weight.copy_(torch.from_numpy(w.T))
        logits = model.lm_head(torch.from_numpy(x)).float()
    assert logits.dtype == torch.float32
    ref = np.asarray(want)
    tol = 1e-5 * (np.abs(ref) + np.sqrt(np.mean(ref.astype(np.float64) ** 2)))
    assert (np.abs(logits.numpy() - ref) <= tol).all()
