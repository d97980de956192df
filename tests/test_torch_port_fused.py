"""The port's Adasum combine and the bf16 LM head against the JAX package's,
on the CPU.

- ``fused_norms_dot`` and ``fused_combine`` (on CPU tensors, their plain
  versions: f64 sums rounded to f32, then each product and the sum rounded
  once in f32) against the JAX package's ``fused_norms_dot`` and
  ``fused_combine``, which run the Pallas kernels in interpret mode here,
  and against its plain ``_combine``; the shapes of ``tests/test_ops.py``
  plus 65,536 and 65,537 elements (one and just over one 512 x 128 TPU
  tile). The combine to rtol 1e-5, as those tests: both sides sum in f32 or
  better, in different orders; the sums as stated in their test.
- ``adasum_coefficients`` and ``_combine`` against the JAX package's.
- The dispatch: CPU tensors, small tensors and f64 tensors take the plain
  combine, and no kernel launch is counted.
- The LM head in bf16: logits and VJP against JAX's ``einsum`` with
  ``preferred_element_type=f32`` and its ``jax.vjp``, per element within
  ``1e-5 (|ref| + RMS(ref))`` (summation order only; the head used to round
  its logits to bf16, a relative error up to 2^-9).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.collectives import adasum as jadasum
from horovod_tpu.ops import fused as jfused
from horovod_tpu_torch.collectives import adasum as tadasum
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.ops import fused as tfused

SHAPES = [(1000,), (513, 7), (65536,), (65537,)]


def _pair(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("shape", SHAPES)
def test_norms_dot_matches_jax_kernel(shape):
    """Each sum within 1e-5 of the sum of its terms' magnitudes of the JAX
    kernel's f32 sum (a random dot cancels to ~sqrt(n) of that, so a bound
    relative to the dot itself would measure JAX's rounding), and within
    one f32 rounding of the exact f64 sum."""
    a, b = _pair(shape, 30)
    want = jfused.fused_norms_dot(jnp.asarray(a), jnp.asarray(b))
    got = tfused.fused_norms_dot(_t(a), _t(b))
    a64, b64 = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    for g, w, (x, y) in zip(got, want, ((a64, b64), (a64, a64), (b64, b64))):
        assert g.dtype == torch.float32 and g.shape == ()
        assert abs(float(g) - float(w)) <= 1e-5 * np.abs(x * y).sum()
        exact = float(x @ y)
        assert abs(float(g) - exact) <= 2 ** -24 * abs(exact)


@pytest.mark.parametrize("shape", SHAPES + ["zero-norm"])
def test_fused_combine_matches_jax_kernel_and_combine(shape):
    if shape == "zero-norm":  # tests/test_ops.py: a = 0 degrades to b
        a, b = np.zeros(64, np.float32), _pair((64,), 42)[1]
    else:
        a, b = _pair(shape, 40)
    got = tfused.fused_combine(_t(a), _t(b))
    assert got.shape == a.shape and got.dtype == torch.float32
    for want in (jfused.fused_combine(jnp.asarray(a), jnp.asarray(b)),
                 jadasum._combine(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert torch.equal(tfused.fused_combine(_t(b), _t(a)), got), \
        "combine is symmetric"
    out = torch.empty_like(got)
    assert tfused.fused_combine(_t(a), _t(b), out=out) is out
    assert torch.equal(out, got)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_combine_matches_jax_combine(shape):
    a, b = _pair(shape, 50)
    want = np.asarray(jadasum._combine(jnp.asarray(a), jnp.asarray(b)))
    got = tadasum._combine(_t(a), _t(b)).view(shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dot, na, nb, eps", [
    (3.0, 4.0, 9.0, 0.0),
    (-2.5, 0.0, 1.0, 0.0),     # a = 0: ca = 1
    (0.0, 0.0, 0.0, 0.0),      # both zero: plain sum
    (1.0, 0.5, 2.0, 1.0),      # a below eps
    (7.0, 7.0, 7.0, 0.0),      # a = b: ca = cb = 1/2
])
def test_adasum_coefficients_match_jax(dot, na, nb, eps):
    want = jfused.adasum_coefficients(*(jnp.float32(v) for v in
                                        (dot, na, nb)), eps)
    got = tfused.adasum_coefficients(
        *(torch.tensor(v, dtype=torch.float32) for v in (dot, na, nb)), eps)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert float(g) == float(w)


def test_dispatch_takes_the_plain_combine_off_the_card():
    """CPU tensors, small tensors and the f64 accumulate option take the
    plain combine: the same values as ``_combine``, and no kernel launch
    counted. Only a large f32 CUDA tensor would take the kernels."""
    tfused.reset_launch_counts()
    n = tadasum._FUSED_COMBINE_MIN_SIZE
    for size, dtype in ((n, torch.float32), (100, torch.float32),
                        (n, torch.float64)):
        a, b = (_t(x).to(dtype) for x in _pair((size,), 60))
        got = tadasum._combine_dispatch(a.clone(), b)
        assert got.dtype == dtype
        assert torch.equal(got, tadasum._combine(a, b))
    assert {k: f.launches for k, f in tfused.KERNELS.items()} == \
        {"norms_dot": 0, "combine": 0}

    def on(device, dtype, size):
        return types.SimpleNamespace(device=torch.device(device),
                                     dtype=dtype, numel=lambda: size)
    assert tadasum._uses_fused(on("cuda", torch.float32, n))
    assert not tadasum._uses_fused(on("cuda", torch.float32, n - 1))
    assert not tadasum._uses_fused(on("cuda", torch.float64, n))
    assert not tadasum._uses_fused(on("cuda", torch.bfloat16, n))
    assert not tadasum._uses_fused(on("cpu", torch.float32, n))


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    tol = 1e-5 * (np.abs(want) + rms)
    assert (np.abs(got - want) <= tol).all(), \
        float((np.abs(got - want) / tol).max())


def test_bf16_lm_head_logits_and_vjp_match_jax():
    """bf16 x and an f32 head weight: f32 logits from the bf16 product
    without rounding it, and the VJP's dtypes and values: dx in bf16, dW
    rounded to bf16 and returned as the f32 parameter's gradient."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 5, 64).astype(np.float32)
    w = (rng.randn(64, 256) / 8).astype(np.float32)   # flax [in, out]
    g = rng.randn(2, 5, 256).astype(np.float32)

    def head(x, w):
        return jnp.einsum("btd,dv->btv", x, w.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)

    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, vjp = jax.vjp(head, xb, jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    assert want_dx.dtype == jnp.bfloat16 and want_dw.dtype == jnp.float32

    lm = tllama.LMHead(64, 256, torch.bfloat16, "cpu")
    with torch.no_grad():
        lm.weight.copy_(_t(w.T))
    tx = _t(x).to(torch.bfloat16).requires_grad_()
    logits = lm(tx)
    assert logits.dtype == torch.float32 and logits.shape == (2, 5, 256)
    _close(logits, want)
    logits.backward(_t(g))
    assert tx.grad.dtype == torch.bfloat16
    assert lm.weight.grad.dtype == torch.float32
    _close(tx.grad, np.asarray(want_dx, np.float32))
    _close(lm.weight.grad.T, want_dw)
    # The old head, a bf16 product cast to f32, is off by up to 2^-9.
    old = torch.nn.functional.linear(tx.detach(), lm.weight.detach().to(
        torch.bfloat16)).float()
    with pytest.raises(AssertionError):
        _close(old, want)
