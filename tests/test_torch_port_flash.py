"""The port's flash attention against the JAX package's, on the CPU.

The same inputs, made from a seed with numpy, go through
``horovod_tpu.ops.flash_attention`` (its Pallas kernels in interpret mode,
as its own tests run them) and through ``horovod_tpu_torch.ops.
flash_attention``, whose wrappers take the plain PyTorch versions of the CUDA
kernels for CPU tensors. Everything is f32, so the tolerance is 1e-5: the
two sides differ only in summation order.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as tfa

# horovod_tpu.ops re-exports the function under the module's name.
jfa = importlib.import_module("horovod_tpu.ops.flash_attention")

TOL = 1e-5
# (Tq, Tk, causal, kv lengths or None): causal and not, cross-attention with
# unequal lengths, a padding mask, and T that is no multiple of the block.
CASES = {
    "causal": (32, 32, True, None),
    "noncausal": (32, 32, False, None),
    "cross": (24, 40, False, None),
    "kv_mask": (32, 32, False, (20, 32)),
    "ragged": (40, 40, True, None),
}
BLOCK = 16


def _inputs(Tq, Tk, lengths, seed=0, B=2, H=2, D=16):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Tq, H, D).astype(np.float32)
    k = rng.randn(B, Tk, H, D).astype(np.float32)
    v = rng.randn(B, Tk, H, D).astype(np.float32)
    mask = None
    if lengths is not None:
        mask = np.arange(Tk)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, mask


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_reference_and_interpret_kernel(case):
    Tq, Tk, causal, lengths = CASES[case]
    q, k, v, mask = _inputs(Tq, Tk, lengths)
    scale = q.shape[-1] ** -0.5
    bias = None if mask is None else np.where(mask, 0.0, -1e30).astype(
        np.float32)
    o, m, l = tfa.fa_fwd(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v),
                         None if bias is None else torch.from_numpy(bias),
                         causal=causal, scale=scale)
    ro, rm, rl = jfa._reference_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), causal=causal,
        scale=scale)
    for a, b in ((o, ro), (m, rm), (l, rl)):
        _close(a.numpy(), b)
    jo, (jm, jl) = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_mask=None if mask is None else jnp.asarray(mask),
        block_q=BLOCK, block_k=BLOCK, return_residuals=True)
    po, (pm, pl) = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_mask=None if mask is None else torch.from_numpy(
            mask), block_q=BLOCK, block_k=BLOCK, return_residuals=True)
    for a, b in ((po, jo), (pm, jm), (pl, jl)):
        _close(a.detach().numpy(), b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_interpret_backward_kernels(case):
    """Port autograd (plain dQ and dK/dV) against ``jax.grad`` through the
    interpret-mode B2 and B3 kernels (the no-residual path)."""
    Tq, Tk, causal, lengths = CASES[case]
    q, k, v, mask = _inputs(Tq, Tk, lengths, seed=1)
    w = np.random.RandomState(2).randn(*q.shape).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, kv_mask=jmask,
                                block_q=BLOCK, block_k=BLOCK)
        return jnp.sum(o * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=causal,
                            kv_mask=None if mask is None
                            else torch.from_numpy(mask))
    (o * torch.from_numpy(w)).sum().backward()
    for t, g in zip((tq, tk, tv), jg):
        _close(t.grad.numpy(), g)


def test_residual_path_gradients_match():
    """``return_residuals=True``: m and l carry cotangents; both sides
    differentiate through the plain recompute."""
    q, k, v, _ = _inputs(32, 32, None, seed=3)
    rng = np.random.RandomState(4)
    wo = rng.randn(*q.shape).astype(np.float32)
    wm = rng.randn(2, 2, 32).astype(np.float32)
    wl = rng.randn(2, 2, 32).astype(np.float32)

    def jloss(q, k, v):
        o, (m, l) = jfa.flash_attention(q, k, v, causal=True, block_q=BLOCK,
                                        block_k=BLOCK,
                                        return_residuals=True)
        return jnp.sum(o * wo) + jnp.sum(m * wm) + jnp.sum(l * wl)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, (m, l) = tfa.flash_attention(tq, tk, tv, causal=True,
                                    return_residuals=True)
    loss = ((o * torch.from_numpy(wo)).sum() + (m * torch.from_numpy(wm)).sum()
            + (l * torch.from_numpy(wl)).sum())
    loss.backward()
    for t, g in zip((tq, tk, tv), jg):
        _close(t.grad.numpy(), g)


def test_merge_partials_matches_jax_and_full_attention():
    """Two partials over disjoint key halves merge to full attention, with
    the same arithmetic as the JAX merge; a partial that saw no key (l == 0)
    contributes nothing."""
    q, k, v, _ = _inputs(32, 32, None, seed=5)
    scale = q.shape[-1] ** -0.5
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    p1 = tfa.fa_fwd(tq, tk[:, :16], tv[:, :16], causal=False, scale=scale)
    p2 = tfa.fa_fwd(tq, tk[:, 16:], tv[:, 16:], causal=False, scale=scale)
    merged = tfa.merge_partials(p1, p2)
    full = tfa.fa_fwd(tq, tk, tv, causal=False, scale=scale)
    for a, b in zip(merged, full):
        _close(a.numpy(), b.numpy())
    jmerged = jfa.merge_partials(
        tuple(jnp.asarray(x.numpy()) for x in p1),
        tuple(jnp.asarray(x.numpy()) for x in p2))
    for a, b in zip(merged, jmerged):
        _close(a.numpy(), b)
    none_seen = torch.full((2, 16), tfa.NEG_INF)
    empty = tfa.fa_fwd(tq, tk[:, 16:], tv[:, 16:], none_seen, causal=False,
                       scale=scale)
    assert float(empty[2].abs().max()) == 0.0
    assert float(empty[0].abs().max()) == 0.0
    for a, b in zip(tfa.merge_partials(p1, empty), p1):
        _close(a.numpy(), b.numpy())


def test_plain_backward_matches_jax_backward_call():
    """The plain dQ and dK/dV versions — what the CUDA kernels are held to
    on the card — against the JAX backward call on the same saved
    statistics, padding and a kv mask included."""
    q, k, v, mask = _inputs(40, 40, (27, 40), seed=6)
    do = np.random.RandomState(7).randn(*q.shape).astype(np.float32)
    scale = q.shape[-1] ** -0.5
    bias = np.where(mask, 0.0, -1e30).astype(np.float32)
    B, T, H, D = q.shape
    tq, tk, tv, tdo, tb = (torch.from_numpy(x) for x in (q, k, v, do, bias))
    o, m, l = tfa.fa_fwd(tq, tk, tv, tb, causal=True, scale=scale)
    dsum = tfa._row_dsum(tdo, o)
    dq = tfa.fa_bwd_dq(tq, tk, tv, tdo, m, l, dsum, tb, causal=True,
                       scale=scale)
    dk, dv = tfa.fa_bwd_dkv(tq, tk, tv, tdo, m, l, dsum, tb, causal=True,
                            scale=scale)
    fold = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, T, D)
    fb = jnp.broadcast_to(jnp.asarray(bias)[:, None, :],
                          (B, H, T)).reshape(B * H, T)
    jdq, jdk, jdv = jfa._fa_bwd_call(
        fold(q), fold(k), fold(v), fold(do), fold(o.numpy()),
        jnp.asarray(m.numpy()).reshape(B * H, T),
        jnp.asarray(l.numpy()).reshape(B * H, T), fb, causal=True,
        scale=scale, block_q=BLOCK, block_k=BLOCK, interpret=True,
        partition=False)
    for a, b in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _close(a.numpy(), np.asarray(b).reshape(B, H, T, D).transpose(
            0, 2, 1, 3))


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="head dims"):
        tfa._check(q, q, q, None)
    h = torch.zeros(1, 8, 2, 64, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa._check(h, h, h, None)
    x = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._check(x, x, x, None)
    stats = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="dO"):
        tfa._check_bwd(x, x.bfloat16(), stats, stats, stats)
    with pytest.raises(ValueError, match="float32"):
        tfa._check_bwd(x, x, stats, stats, torch.zeros(1, 8, 2))


def test_bf16_operands_must_be_16_byte_aligned():
    """The bf16 kernels load by TMA, which takes only 16-byte-aligned
    addresses: a bf16 view 2 bytes past an aligned one is refused, f32 is
    not checked, and an aligned bf16 tensor passes."""
    buf = torch.zeros(2 * 8 * 2 * 64 + 8, dtype=torch.bfloat16)
    aligned = buf[:-8].view(2, 8, 2, 64)
    assert aligned.data_ptr() % 16 == 0
    tfa._check_aligned(aligned)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._check_aligned(aligned, buf[1:-7].view(2, 8, 2, 64))
    tfa._check_aligned(torch.zeros(9)[1:])
