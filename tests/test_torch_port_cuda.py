"""Tests of the PyTorch port that need NVIDIA GPUs; each skips without them.

    python -m pytest tests/test_torch_port_cuda.py

- The three flash-attention kernels against their plain PyTorch versions on
  small cases the training shape of ``chip_smoke.py`` does not reach: head
  dims 64 and 128 in bf16 and f32, cross-attention, causal with Tq < Tk and
  Tq > Tk, ragged sequence edges over several tiles and under one, a key
  length off the 64-row tiles of the bf16 dQ kernel, a single query,
  key-padding bias, and rows that see no key; and the bf16 kernels'
  refusal of an operand that is not 16-byte aligned.
  Tolerances as in ``chip_smoke.py``, per element: ``|kernel - plain| <= r *
  (|plain| + RMS(plain))``, r = 2^-7 for bf16 outputs (each side rounds an
  f32 value summed in another order, and the two roundings land at most one
  bf16 ulp, at most 2^-7 of the magnitude, apart; the RMS term covers
  elements near zero) and r = 5e-5 for f32 outputs (f32 summation-order
  differences are near 1e-6 of the summed magnitudes).
- The Adasum kernels (B4 the three sums, B5 the combine) against their
  plain versions on edge cases: n = 65,536 and 1,000,003, a = 0, a = b,
  orthogonal vectors, and slices misaligned by the same and by different
  offsets (tolerances in the test).
- B1, B2 and B3 at BERT-Large's attention shape (8 x 512 tokens, 16 heads
  of 64, not causal, a ragged key-padding bias), in bf16 and f32.
- The bf16 LM head's cuBLAS products against its CPU version.
- The MoE's ``sorted_dispatch`` and ``sorted_combine`` forward and
  backward on the card: bit-identical twice, within 1e-6 of the CPU (``-k
  moe``).
- DLRM's sparse row update on the card: bit-identical twice with
  duplicate ids, untouched rows unchanged, within 1e-6 of the CPU; and the
  ep exchange's static-split layout on one card against the plain gather
  (``-k "sparse_adagrad or table_exchange"``).
- B1 as the custom op ``hvd::fa_fwd`` launches the kernel for CUDA tensors;
  a bf16 Llama under each remat arm against remat off (``-k remat``).
- ResNetTiny and a bottleneck ResNet with the space_to_depth stem, f32 with
  TF32 off, channels_last on the card against the plain layout on the CPU:
  logits, gradients and running statistics (``-k layout``).
- Across 2 and 4 GPUs (``-k hierarchical``), in a world declared 2 x 1 or 2
  x 2: the hierarchical all-reduce against the flat one per element, on a
  tensor and on ``DistributedOptimizer``'s hook path; ``hierarchical_adasum``
  with log2(cross) launches of B4 and B5 against the plain composition; and
  alltoall and allgather, flat and staged, bit-exact against plain
  constructions from point-to-point sends and broadcasts.
- Model parallelism of the other families on 2 GPUs: Mixtral on tp (the
  tp ranks route alike; logits against the whole model), an expert bank
  gathered over fsdp on its embed dim, and BERT on tp through B1-B3 on the
  local heads (``-k "route_alike or bank_gather or local_heads"``).
- ``ResNetTiny`` with SyncBatchNorm over NCCL on 2 and 4 GPUs against one
  process on the whole batch, with its all-reduces counted (``-k
  sync_batch_norm``).
- ``DistributedOptimizer(AdamW, op=Adasum)`` over NCCL on 2 and on 4 GPUs
  (``-k adasum``): log2(n) launches of B4 and B5 per step, ranks
  bit-identical, and rank 0's first combined gradient held to the plain
  butterfly of the gathered local gradients.
- The sentinel's digest on the card equal to the CPU's, the
  ``DistributedOptimizer`` bucket probe's finite bit and squared norm, and
  a NaN step withheld by ``make_train_step`` with the parameters bitwise
  unchanged (one GPU); the frontend's handles over NCCL on 2 GPUs (named
  ops in opposite orders, an uneven allgather, a mismatched name raising on
  both ranks); the watchdog rescuing a hung NCCL step within its deadline
  plus 2 s (``-k "digest_on_the_card or health_probe or frontend_handles or
  watchdog_rescues"``).
- The paged-KV decode on the card (``-k decode``): a small bf16 Llama's
  prefill and teacher-forced decode logits against ``Llama.forward``
  within 2^-5 normwise, the engine's greedy streams against the forward's
  argmax under the near-tie rule (a flip only where the reference's top-2
  margin is at most 2^-3 RMS of its row), and the engine over tp 2 on
  NCCL: the ranks' streams equal, and held to the one-card engine's under
  the near-tie rule.
- Data-parallel training across every GPU of the machine over NCCL, for two
  steps, with AdamW (lr 1e-4, weight decay 1e-4, the main path's settings)
  and with SGD and momentum. The ranks end bit-identical, and they are held
  to one process that trains on the whole global batch. With SGD, which is
  linear in the gradient, every parameter is within 1e-5. With AdamW:

  - the first step's reduced gradient is within 1e-4 of (|g| + RMS(g)) of
    the one process's: the same terms summed in another order. The worst
    reading on four H100s was 1.08e-5, in the embedding.
  - every parameter is within 1e-5 (absolute plus relative), except where
    the gradient lies within 100 eps (1e-6) of zero at some step and differs
    between the runs. There AdamW's first update, lr * g / (|g| + eps), is
    too steep a function of g. On four H100s, embedding element [429, 188]
    had a first-step gradient of -1.16e-8 in one process and -4.24e-8 across
    four ranks. That is an update of 0.537 lr against 0.809 lr, and it
    leaves the parameter 2.71e-5 apart. At 100 eps the slope has fallen far
    enough that a gradient difference of 1.2e-7 moves the parameter by
    about 1.2e-7. Such elements, 1,899 of 1,443,072 there, are held to the 4 lr
    that two AdamW steps on each side can move them.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    # The plain references in full f32 (hopper-kernels guide, section 6).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


# (Tq, Tk, H, D, dtype, causal, kv lengths or None)
CASES = {
    "bf16-d128-causal": (200, 200, 4, 128, torch.bfloat16, True, None),
    "bf16-d64-cross-bias": (100, 300, 4, 64, torch.bfloat16, False,
                            (300, 150)),
    "f32-d128-causal-bias": (130, 130, 2, 128, torch.float32, True,
                             (130, 77)),
    "f32-d64-causal-cross": (70, 200, 2, 64, torch.float32, True, None),
    "f32-d64-no-key-seen": (64, 96, 2, 64, torch.float32, False, (0, 50)),
    # The bf16 tensor-core kernels (B1-B3) on their tile edges: ragged T
    # over several tiles, a single query row, less than one tile, causal
    # cross-attention, and rows that see no key.
    "bf16-d128-causal-ragged": (1000, 1000, 2, 128, torch.bfloat16, True,
                                None),
    "bf16-d128-one-query": (1, 40, 2, 128, torch.bfloat16, False, None),
    "bf16-d64-t33": (33, 33, 2, 64, torch.bfloat16, False, None),
    "bf16-d64-causal-cross": (70, 200, 2, 64, torch.bfloat16, True, None),
    "bf16-d128-no-key-seen": (100, 130, 2, 128, torch.bfloat16, False,
                              (0, 77)),
    # B2's 64-row k-tiles: a key length that is not a multiple of 64 under a
    # bias, and causal attention with more queries than keys.
    "bf16-d128-cross-bias-ragged-k": (130, 1000, 2, 128, torch.bfloat16,
                                      False, (1000, 333)),
    "bf16-d64-causal-tq-gt-tk": (300, 100, 2, 64, torch.bfloat16, True, None),
}


def _close(what, got, ref):
    ref = ref.float()
    r = 2 ** -7 if got.dtype == torch.bfloat16 else 5e-5
    tol = r * (ref.abs() + ref.square().mean().sqrt())
    err = (got.float() - ref).abs()
    assert (err <= tol).all(), (
        f"{what}: {int((err > tol).sum())} elements off; worst err/tol "
        f"{(err / tol).max().item():.3f}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain_versions(cuda, case):
    check_kernels(2, *CASES[case])


#: BERT-Large's attention (``models/bert.py``) at 8 x 512 tokens: 16 heads
#: of 64, not causal, a key-padding bias whose rows hold 512, 480, ..., 288
#: real keys.
BERT_LENGTHS = tuple(512 - 32 * i for i in range(8))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_kernels_match_plain_versions_at_bert_shape(cuda, dtype):
    check_kernels(8, 512, 512, 16, 64, dtype, False, BERT_LENGTHS)


def check_kernels(B, Tq, Tk, H, D, dtype, causal, lengths):
    """B1, B2 and B3 against their plain versions on one case, each launched
    once (module doc's tolerances)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda T: torch.randn((B, T, H, D), generator=gen, device="cuda",
                               dtype=dtype)
    q, k, v, do = mk(Tq), mk(Tk), mk(Tk), mk(Tq)
    bias = None
    if lengths is not None:
        keep = (torch.arange(Tk, device="cuda")[None, :]
                < torch.tensor(lengths, device="cuda")[:, None])
        bias = torch.where(keep, 0.0, fa.NEG_INF).float()
    kw = dict(causal=causal, scale=D ** -0.5)
    before = {n: f.launches for n, f in fa.KERNELS.items()}
    o, m, l = fa.fa_fwd(q, k, v, bias, **kw)
    ro, rm, rl = fa._reference_partial(q, k, v, bias, **kw)
    _close("o", o, ro)
    torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, rl, rtol=1e-5, atol=1e-5)
    dsum = fa._row_dsum(do, o)
    args = (q, k, v, do, m, l, dsum, bias)
    _close("dq", fa.fa_bwd_dq(*args, **kw), fa._plain_bwd_dq(*args, **kw))
    dk, dv = fa.fa_bwd_dkv(*args, **kw)
    rdk, rdv = fa._plain_bwd_dkv(*args, **kw)
    _close("dk", dk, rdk)
    _close("dv", dv, rdv)
    torch.cuda.synchronize()
    assert {n: f.launches - before[n]
            for n, f in fa.KERNELS.items()} == dict.fromkeys(fa.KERNELS, 1)
    if lengths is not None and 0 in lengths:
        assert float(l[lengths.index(0)].abs().max()) == 0.0
        assert float(o[lengths.index(0)].abs().max()) == 0.0


def test_bf16_kernels_refuse_misaligned_operand(cuda):
    """The bf16 kernels load by TMA, which takes 16-byte-aligned addresses
    only: an operand 2 bytes past a 16-byte boundary is refused with
    ValueError before any launch, by the forward, the dQ and the dK/dV
    wrapper."""
    shape = (1, 64, 2, 64)
    n = 64 * 2 * 64
    buf = torch.randn(n + 8, device="cuda", dtype=torch.bfloat16)
    bad = buf[1:n + 1].view(shape)
    assert bad.data_ptr() % 16 == 2 and bad.is_contiguous()
    good = torch.randn(shape, device="cuda", dtype=torch.bfloat16)
    kw = dict(causal=True, scale=0.125)
    before = {k: f.launches for k, f in fa.KERNELS.items()}
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.fa_fwd(bad, good, good, **kw)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.fa_fwd(good, good, bad, **kw)
    o, m, l = fa.fa_fwd(good, good, good, **kw)
    dsum = fa._row_dsum(good, o)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.fa_bwd_dq(good, bad, good, good, m, l, dsum, **kw)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.fa_bwd_dq(good, good, good, bad, m, l, dsum, **kw)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.fa_bwd_dkv(good, good, good, bad, m, l, dsum, **kw)
    torch.cuda.synchronize()
    assert {k: f.launches - before[k] for k, f in fa.KERNELS.items()} == \
        {"fa_fwd": 1, "fa_bwd_dq": 0, "fa_bwd_dkv": 0}


def _fused_operands(case, gen):
    """(a, b) of one B4/B5 edge case, f32 on the card."""
    mk = lambda n: torch.randn(n, generator=gen, device="cuda")
    if case == "n65536":
        return mk(65536), mk(65536)
    if case == "ragged-1000003":
        return mk(1_000_003), mk(1_000_003)
    if case == "a-zero":
        return torch.zeros(70_001, device="cuda"), mk(70_001)
    if case == "a-equals-b":
        a = mk(70_001)
        return a, a.clone()
    if case == "orthogonal":  # disjoint supports: a.b = 0
        a, b = mk(70_000), mk(70_000)
        a[35_000:] = 0
        b[:35_000] = 0
        return a, b
    if case == "misaligned-same-offset":  # 4 bytes past a 16-byte boundary
        return mk(300_001)[1:], mk(300_001)[1:]
    if case == "misaligned-other-offset":  # the scalar path
        return mk(300_003)[1:-1], mk(300_004)[3:]
    raise ValueError(case)


FUSED_CASES = ("n65536", "ragged-1000003", "a-zero", "a-equals-b",
               "orthogonal", "misaligned-same-offset",
               "misaligned-other-offset")


@pytest.mark.parametrize("case", FUSED_CASES)
def test_adasum_kernels_match_plain_versions(cuda, case):
    """B4's three sums within 1e-6 of the sums of their terms' magnitudes
    (the plain version sums in f64; the kernel in f64 in another order),
    its coefficients within 1e-5 relative, and B5, given the same
    coefficients, per element within 2^-22 (|ca a| + |cb b|): both sides
    round ca a, cb b and their sum once each. The combine is symmetric
    bit for bit, and in place gives the same values."""
    from horovod_tpu_torch.ops import fused
    a, b = _fused_operands(case, torch.Generator(device="cuda").manual_seed(0))
    before = {k: f.launches for k, f in fused.KERNELS.items()}
    stats = fused._norms_dot_kernel(a, b)
    plain = fused._plain_norms_dot(a, b)
    a64, b64 = a.double(), b.double()
    for got, want, (x, y) in zip(stats[:3], plain,
                                 ((a64, b64), (a64, a64), (b64, b64))):
        assert abs(got.item() - want.item()) <= 1e-6 * (x * y).abs().sum()
    ca, cb = fused.adasum_coefficients(*plain)
    torch.testing.assert_close(stats[3:], torch.stack([ca, cb]), rtol=1e-5,
                               atol=0)
    out = fused._combine_kernel(a, b, stats)
    ref = fused._plain_scale_add(a, b, stats[3], stats[4])
    tol = 2 ** -22 * ((stats[3] * a).abs() + (stats[4] * b).abs())
    assert ((out - ref).abs() <= tol).all()
    got = fused.fused_combine(a, b)
    assert torch.equal(got, fused.fused_combine(b, a))
    if case == "a-zero":
        assert torch.equal(got, b)
    if case == "orthogonal":
        assert torch.equal(got, a + b)
    if case == "a-equals-b":
        torch.testing.assert_close(got, a, rtol=1e-6, atol=1e-6)
    work = a.clone()
    fused.fused_combine(work, b, out=work)
    assert torch.equal(work, got)
    torch.cuda.synchronize()
    assert {k: f.launches - before[k] for k, f in fused.KERNELS.items()} == \
        {"norms_dot": 4, "combine": 4}


def test_bf16_lm_head_on_the_card_matches_the_cpu(cuda):
    """The head's cuBLAS products against its CPU version (f32 products of
    the same operands). The card rounds the cotangent to bf16 before its
    backward products, so the CPU side is given that rounded cotangent:
    then only the summation order differs. Logits per element within 1e-5
    (|ref| + RMS); the bf16 gradients within one bf16 ulp, 2^-7 (|ref| +
    RMS), as two roundings of nearly equal f32 values."""
    from horovod_tpu_torch.models.llama import LMHead
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, 512, generator=gen).to(torch.bfloat16)
    g = torch.randn(64, 1000, generator=gen).to(torch.bfloat16).float()
    res = {}
    for dev in ("cpu", "cuda"):
        head = LMHead(512, 1000, torch.bfloat16, dev)
        with torch.no_grad():
            head.weight.copy_(torch.randn(1000, 512, generator=torch.Generator(
                ).manual_seed(1)) / 20)
        xd = x.detach().to(dev).requires_grad_()
        logits = head(xd)
        logits.backward(g.to(dev))
        res[dev] = [t.detach().float().cpu() for t in
                    (logits, xd.grad, head.weight.grad)]
        assert logits.dtype == torch.float32
    for what, got, ref in zip(("logits", "dx", "dW"), res["cuda"],
                              res["cpu"]):
        r = 1e-5 if what == "logits" else 2 ** -7
        tol = r * (ref.abs() + ref.square().mean().sqrt())
        ratio = ((got - ref).abs() / tol).max().item()
        assert ratio <= 1.0, f"{what}: worst err/tol {ratio:.3f}"


def test_b1_custom_op_launches_the_kernel_on_the_card(cuda):
    """B1 is the torch custom op ``hvd::fa_fwd``: for CUDA tensors the op
    launches the kernel (its launch counter moves, once per call), not the
    plain version, and agrees with the plain version within the bf16
    tolerance; the CPU implementation launches nothing."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn((1, 256, 4, 128), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    kw = dict(causal=True, scale=128 ** -0.5)
    fa.reset_launch_counts()
    o, m, l = torch.ops.hvd.fa_fwd(q, k, v, None, True, 128 ** -0.5)
    o2, _ = fa.flash_attention(q, k, v, return_residuals=True, **kw)
    torch.cuda.synchronize()
    assert (fa.fa_fwd.launches, fa.fa_fwd.calls) == (2, 2)
    ro, rm, rl = fa._reference_partial(q, k, v, **kw)
    _close("o", o, ro)
    _close("m", m, rm)
    _close("l", l, rl)
    assert torch.equal(o, o2)
    torch.ops.hvd.fa_fwd(q.cpu(), k.cpu(), v.cpu(), None, True, 0.1)
    assert (fa.fa_fwd.launches, fa.fa_fwd.calls) == (2, 3)


def _moe_pass(moe, plan, x, out, dbuf, dy, E, C, T):
    """``sorted_dispatch`` and ``sorted_combine`` forward and backward on
    the device of the inputs: the buffer, the combine, and the gradients of
    the tokens, the expert outputs and the combine weights."""
    x = x.clone().requires_grad_()
    out = out.clone().requires_grad_()
    weight = plan.weight.clone().requires_grad_()
    r = plan._replace(weight=weight)
    buf = moe.sorted_dispatch(x, r, E, C)
    y = moe.sorted_combine(out, r, T)
    torch.autograd.backward([buf, y], [dbuf, dy])
    return [buf.detach(), y.detach(), x.grad, out.grad, weight.grad]


@pytest.mark.parametrize("cap_factor", [1.25, 0.5])
def test_moe_dispatch_and_combine_on_the_card(cuda, cap_factor):
    """``sorted_dispatch`` and ``sorted_combine`` (gathers forward and
    backward, no atomics) on the card: two runs bit-identical, and within
    1e-6 of the CPU on f32 inputs: the buffer, the combine and the
    gradients of the tokens and expert outputs (gathers, and sums of k = 2
    terms) per element within 1e-6 absolute plus relative; the combine
    weights' gradient, a dot product over D = 256, within 1e-6 of the sum
    of its terms' magnitudes (the two devices sum the terms in different
    orders). One routing plan, made on the CPU, serves both devices; 0.5
    drops tokens."""
    from horovod_tpu_torch.parallel import moe
    T, E, D, k = 4096, 8, 256, 2
    C = max(1, int(cap_factor * k * T / E))
    gen = torch.Generator().manual_seed(3)
    logits, x, dy = (torch.randn(s, generator=gen)
                     for s in ((T, E), (T, D), (T, D)))
    out, dbuf = (torch.randn((E, C, D), generator=gen) for _ in range(2))
    plan = moe.topk_router_sorted(logits, E, C, k)
    if cap_factor < 1:
        assert (plan.dest == E * C).any()
    ref = _moe_pass(moe, plan, x, out, dbuf, dy, E, C, T)
    card = plan._replace(**{f: getattr(plan, f).cuda()
                            for f in plan._fields})
    inputs = [t.cuda() for t in (x, out, dbuf, dy)]
    first = _moe_pass(moe, card, *inputs, E, C, T)
    second = _moe_pass(moe, card, *inputs, E, C, T)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    for a, want in zip(first[:4], ref[:4]):
        np.testing.assert_allclose(a.cpu().numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    rows = torch.cat([out.reshape(E * C, D), out.new_zeros(1, D)])[plan.dest]
    terms = (rows.reshape(k, T, D) * dy).abs().sum(-1).reshape(-1)
    assert ((first[4].cpu() - ref[4]).abs() <= 1e-6 * terms).all()


def test_sparse_adagrad_update_on_the_card(cuda):
    """DLRM's row update on Criteo-width rows (4 tables of 100,000 x 64,
    2048 examples, ids drawn from 500 a table so rows repeat): two calls
    on the same inputs bit-identical (the duplicate sums are sorted
    segment sums, not atomics), rows no id names bit-unchanged, and the
    touched rows within 1e-6 relative and 1e-9 absolute of the CPU (the
    sums of up to about 20 duplicates in another order, through
    ``g / sqrt(acc)``)."""
    from horovod_tpu_torch.models.dlrm import sparse_adagrad_update
    T, R, D, B = 4, 100000, 64, 2048
    gen = torch.Generator().manual_seed(5)
    tables = torch.randn((T * R, D), generator=gen) * 0.01
    accum = torch.full_like(tables, 0.1)
    ids = (torch.randint(0, 500, (B, T), generator=gen)
           + torch.arange(T) * R).reshape(-1)
    grads = torch.randn((B * T, D), generator=gen) * 1e-3
    want = [t.clone() for t in (tables, accum)]
    sparse_adagrad_update(*want, ids, grads, 1e-2, 1e-7)
    outs = []
    for _ in range(2):
        got = [t.cuda() for t in (tables, accum)]
        sparse_adagrad_update(*got, ids.cuda(), grads.cuda(), 1e-2, 1e-7)
        outs.append([t.cpu() for t in got])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    untouched = torch.ones(T * R, dtype=torch.bool)
    untouched[ids] = False
    for got, before, ref in zip(outs[0], (tables, accum), want):
        assert torch.equal(got[untouched], before[untouched])
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                                   atol=1e-9)


def test_table_exchange_layout_on_the_card(cuda):
    """The ep exchange's static-split layout on one card, the all-to-alls
    done by hand (four ranks, 26 tables split 7, 7, 6, 6, 8 examples a
    rank, D = 64): every rank receives exactly the whole table's rows at
    its ids, in table order (``torch.equal`` with the plain gather)."""
    from horovod_tpu_torch.parallel import embedding
    n, b, T, R, D = 4, 8, 26, 1000, 64
    whole = torch.randn(T * R, D, device="cuda")
    sizes = embedding.table_split(T, n)
    starts = np.cumsum((0,) + sizes)
    ids = [torch.randint(0, R, (b, T), device="cuda") for _ in range(n)]
    sent = [embedding.by_owner(x, sizes).split([b * s for s in sizes])
            for x in ids]
    back = []
    for j in range(n):
        mine = torch.cat([sent[i][j] for i in range(n)]).reshape(-1,
                                                                 sizes[j])
        fid = (mine + torch.arange(sizes[j], device="cuda") * R).reshape(-1)
        back.append(whole[starts[j] * R:starts[j + 1] * R][fid].split(
            b * sizes[j]))
    for i in range(n):
        looked = embedding.from_owners(
            torch.cat([back[j][i] for j in range(n)]), sizes, b)
        fid = (ids[i] + torch.arange(T, device="cuda") * R).reshape(-1)
        assert torch.equal(looked, whole[fid].reshape(b, T, D))


@pytest.mark.parametrize("arm", ["dots", "dots_attn", "attn", "full"])
def test_remat_arms_match_remat_off_on_the_card(cuda, arm):
    """A bf16 Llama (head dim 128, T = 512, flash on) under each remat arm
    against remat off on the card: loss and every gradient per element
    within 2^-7 (|ref| + RMS(ref)), one bf16 ulp, as the recompute may
    repeat a product in another order (the embedding's scatter-add is not
    ordered); B1 launched twice a layer under "dots" and "full", once
    under the others, and B2, B3 once a layer."""
    from horovod_tpu_torch.models import llama as tllama
    from horovod_tpu_torch.train import next_token_loss
    base = tllama.LlamaConfig(vocab_size=1000, dim=512, n_layers=2,
                              n_heads=4, n_kv_heads=2, hidden_dim=1024,
                              max_seq_len=512, use_flash=True)
    tokens = torch.randint(0, 1000, (2, 512), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(0))
    out = {}
    for name in ("none", arm):
        model = tllama.Llama(tllama.with_remat_policy(base, name),
                             device="cuda", seed=0)
        fa.reset_launch_counts()
        loss = next_token_loss(model(tokens), tokens)
        loss.backward()
        torch.cuda.synchronize()
        out[name] = (loss.detach(), {n: p.grad for n, p in
                                     model.named_parameters()},
                     {k: f.launches for k, f in fa.KERNELS.items()})
    b1 = 4 if arm in ("dots", "full") else 2
    assert out[arm][2] == {"fa_fwd": b1, "fa_bwd_dq": 2, "fa_bwd_dkv": 2}
    assert out["none"][2] == {"fa_fwd": 2, "fa_bwd_dq": 2, "fa_bwd_dkv": 2}
    for name, g in [("loss", out["none"][0]), *out["none"][1].items()]:
        got = out[arm][0] if name == "loss" else out[arm][1][name]
        tol = 2 ** -7 * (g.abs() + g.square().mean().sqrt())
        ratio = ((got - g).abs() / tol).max().item()
        assert ratio <= 1.0, f"{name}: worst err/tol {ratio:.3f}"


@pytest.mark.parametrize("name", ["tiny", "bottleneck-s2d"])
def test_resnet_layout_on_the_card_matches_the_cpu(cuda, name):
    """The ResNet runs channels_last on the card and in the plain layout on
    the CPU (``models/resnet.py``). Same f32 weights and batch, TF32 off,
    one training forward and backward: logits, every parameter's gradient
    and the running statistics per element within 1e-4 (|ref| + RMS(ref)).
    Both sides compute in f32 in other summation orders (cuDNN against the
    CPU's convolutions), about 1e-6 of the magnitudes a layer; BatchNorm's
    normalisation and its backward carry that through the layers, and 1e-4
    leaves a margin of more than ten for it."""
    import torch.nn.functional as F
    from horovod_tpu_torch.models import resnet
    make = {
        "tiny": lambda dev: resnet.ResNetTiny(
            num_classes=10, dtype=torch.float32, device=dev),
        "bottleneck-s2d": lambda dev: resnet.ResNet(
            [1, 1], resnet.BottleneckResNetBlock, num_classes=10, width=8,
            dtype=torch.float32, stem="space_to_depth", device=dev),
    }[name]
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(8, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (8,), generator=gen)
    models = {"cpu": make("cpu"), "cuda": make("cuda")}
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    layouts = []
    models["cuda"].conv_init.register_forward_pre_hook(
        lambda mod, args: layouts.append(args[0].is_contiguous(
            memory_format=torch.channels_last)))
    res = {}
    for dev, model in models.items():
        logits = model(images.to(dev))
        F.cross_entropy(logits, labels.to(dev)).backward()
        res[dev] = {"logits": logits.detach().cpu()}
        res[dev].update({"grad/" + k: p.grad.cpu()
                         for k, p in model.named_parameters()})
        res[dev].update({"stat/" + k: b.cpu()
                         for k, b in model.named_buffers()
                         if b.is_floating_point()})
    assert layouts == [True]
    worst = {}
    for key, ref in res["cpu"].items():
        tol = 1e-4 * (ref.abs() + ref.square().mean().sqrt())
        worst[key] = ((res["cuda"][key] - ref).abs() / tol).max().item()
    key = max(worst, key=worst.get)
    print(f"resnet {name} layout: worst err/tol {worst[key]:.4f} at {key}")
    assert worst[key] <= 1.0, (key, worst[key])


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig
    from horovod_tpu_torch.ops import fused
    from horovod_tpu_torch.train import (create_train_state, make_train_step,
                                         next_token_loss)

    out_dir, device, opt_name = sys.argv[1:4]
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device=device)
    rank, size = hvd.rank(), hvd.size()
    cfg = LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, hidden_dim=512, max_seq_len=128,
                      dtype=torch.float32, use_flash=True, remat=False)
    model = Llama(cfg, seed=rank)  # ranks differ until the broadcast
    if opt_name == "sgd":
        inner = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    else:  # the main path's optimizer and settings
        inner = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                  weight_decay=1e-4)
    opt = hvd.DistributedOptimizer(
        inner, named_parameters=model.named_parameters(),
        op=hvd.Adasum if opt_name == "adasum" else hvd.Average)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, next_token_loss)
    tokens = torch.randint(0, cfg.vocab_size, (8, 128),
                           generator=torch.Generator().manual_seed(0))
    per = tokens.shape[0] // size
    shard = tokens[rank * per:(rank + 1) * per].to(hvd.device())
    losses, launches, out = [], [], {}
    synchronize = opt.synchronize

    def keep_local_grads():  # this rank's gradient, before the reduction
        for name, p in model.named_parameters():
            out[f"local{len(losses)}/{name}"] = p.grad.detach().cpu().numpy()
        synchronize()

    if opt_name == "adasum":
        opt.synchronize = keep_local_grads
    for s in range(2):
        fused.reset_launch_counts()
        state, loss = step(state, shard, shard)
        losses.append(loss.item())
        launches.append([f.launches for f in fused.KERNELS.values()])
        for name, p in model.named_parameters():  # the reduced gradient
            out[f"grad{s}/{name}"] = p.grad.detach().cpu().numpy()
    out.update({k: v.detach().cpu().numpy()
                for k, v in model.state_dict().items()})
    np.savez(f"{out_dir}/{opt_name}_w{size}_r{rank}.npz",
             losses=np.asarray(losses), launches=np.asarray(launches), **out)
    hvd.shutdown()
""")


_RESNET_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.collectives import ops
    from horovod_tpu_torch.models.resnet import ResNetTiny
    from horovod_tpu_torch.train import (batch_stats, create_train_state,
                                         make_train_step)

    out_dir, device, opt_name = sys.argv[1:4]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hvd.init(device=device)
    rank, size = hvd.rank(), hvd.size()
    model = ResNetTiny(num_classes=10, dtype=torch.float32,
                       sync_batch_norm=True, seed=rank)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, F.cross_entropy)
    gen = torch.Generator().manual_seed(0)
    images = torch.randn((8, 32, 32, 3), generator=gen)
    labels = torch.randint(0, 10, (8,), generator=gen)
    per = 8 // size
    own = slice(rank * per, (rank + 1) * per)
    losses, launches = [], []
    for s in range(2):
        ops.allreduce_async_.launches = 0
        state, loss = step(state, images[own].to(hvd.device()),
                           labels[own].to(hvd.device()))
        losses.append(loss.item())
        launches.append(ops.allreduce_async_.launches)
    norms = sum(1 for m in model.modules() if isinstance(m, hvd.SyncBatchNorm))
    out = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    np.savez(f"{out_dir}/{opt_name}_w{size}_r{rank}.npz",
             losses=np.asarray(losses), launches=np.asarray(launches),
             counts=np.asarray([len(opt.buckets), norms,
                                len(batch_stats(model))]), **out)
    hvd.shutdown()
""")


_COLLECTIVES_WORKER = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.collectives import ops
    from horovod_tpu_torch.core import context_api
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig
    from horovod_tpu_torch.ops import fused
    from horovod_tpu_torch.train import next_token_loss

    out_dir, _, name = sys.argv[1:4]
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    rank, n = hvd.rank(), hvd.size()
    stages = ops.hierarchical_allreduce_async_.launches
    gen = torch.Generator(device="cuda").manual_seed(rank)
    out = {"layout": [hvd.cross_size(), hvd.local_size()]}

    def bound_ratio(got, ref, local):
        # |got - ref| over 2^-21 sum_i |x_i| / n, the summation-order bound
        absum = local.abs()
        dist.all_reduce(absum)
        tol = 2 ** -21 * absum / n
        err = (got - ref).abs()
        assert bool((err[tol == 0] == 0).all())
        return (err / tol.clamp_min(1e-38)).max().item()

    # The hierarchical all-reduce of one odd-sized tensor against the flat.
    x = torch.randn(1_000_003, generator=gen, device="cuda")
    before = dict(stages)
    with ops.hierarchical_override(True):
        hier = hvd.allreduce(x, hvd.Average)
    out["tensor_launches"] = [stages[s] - before[s] for s in ops.HIER_STAGES]
    with ops.hierarchical_override(False):
        flat = hvd.allreduce(x, hvd.Average)
    out["tensor_err_over_tol"] = bound_ratio(hier, flat, x)

    # The hook path: the buckets' stages chained on the side stream.
    cfg = LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, hidden_dim=512, max_seq_len=128,
                      dtype=torch.float32, use_flash=True, remat=False)
    model = Llama(cfg, seed=0)
    params = list(model.parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=0.0),
        named_parameters=model.named_parameters())
    tokens = torch.randint(0, 512, (2, 128), generator=gen, device="cuda")
    local = torch.cat([g.reshape(-1) for g in torch.autograd.grad(
        next_token_loss(model(tokens), tokens), params)])
    reduced = {}
    for mode in (True, False):
        with ops.hierarchical_override(mode):
            before = dict(stages)
            opt.zero_grad()
            next_token_loss(model(tokens), tokens).backward()
            opt.synchronize()
            reduced[mode] = torch.cat([p.grad.reshape(-1) for p in params])
            out[f"hook_launches_{mode}"] = [stages[s] - before[s]
                                            for s in ops.HIER_STAGES]
    out["buckets"] = len(opt.buckets)
    out["hook_err_over_tol"] = bound_ratio(reduced[True], reduced[False],
                                           local)

    # hierarchical_adasum against the sum within each node, then the plain
    # butterfly across the nodes.
    v = torch.randn((1 << 20) + 3, generator=gen, device="cuda")
    fused.reset_launch_counts()
    got = hvd.hierarchical_adasum(v)
    torch.cuda.synchronize()
    out["adasum_launches"] = [f.launches for f in fused.KERNELS.values()]
    every = [torch.empty_like(v) for _ in range(n)]
    dist.all_gather(every, v)
    cross, intra = out["layout"]
    pad = (-v.numel()) % intra
    sums = [torch.cat([sum(every[c * intra:(c + 1) * intra]),
                       v.new_zeros(pad)]) for c in range(cross)]
    m = sums[0].numel() // intra
    shards = []
    for i in range(intra):  # coefficients per shard, as in the JAX package
        vecs = [x[i * m:(i + 1) * m] for x in sums]
        d = 1
        while d < cross:
            vecs = [fused._plain_combine(vecs[j], vecs[j ^ d])
                    for j in range(cross)]
            d *= 2
        shards.append(vecs[0])
    ref = torch.cat(shards)[:v.numel()]
    tol = 1e-5 * (ref.abs() + ref.square().mean().sqrt())
    out["adasum_err_over_tol"] = ((got - ref).abs() / tol).max().item()

    # alltoall and allgather against point-to-point and broadcast.
    a = torch.randn((8, 1280, 64), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    got = hvd.alltoall(a)
    c = a.shape[0] // n
    want = torch.empty_like(a)
    ops_ = []
    for p in range(n):
        if p == rank:
            want[p * c:(p + 1) * c] = a[p * c:(p + 1) * c]
        else:
            ops_ += [dist.P2POp(dist.isend, a[p * c:(p + 1) * c].clone(), p),
                     dist.P2POp(dist.irecv, want[p * c:(p + 1) * c], p)]
    for work in dist.batch_isend_irecv(ops_):
        work.wait()
    out["alltoall_equal"] = bool(torch.equal(got, want))
    g = torch.randn((1000, 33), generator=gen, device="cuda")
    want = torch.empty((n * 1000, 33), device="cuda")
    for p in range(n):
        buf = g.clone() if p == rank else torch.empty_like(g)
        dist.broadcast(buf, p)
        want[p * 1000:(p + 1) * 1000] = buf
    ctx = context_api.context()
    flat_gather = hvd.allgather(g)
    ctx.config.hierarchical_allgather = True
    staged = hvd.allgather(g)
    out["allgather_equal"] = [bool(torch.equal(flat_gather, want)),
                              bool(torch.equal(staged, want))]
    np.savez(f"{out_dir}/{name}_w{n}_r{rank}.npz",
             result=np.asarray(json.dumps(out)))
    hvd.shutdown()
""")


_HIER_RUNS: dict = {}


def hierarchical_world(tmp_path, n):
    """Each rank's results of ``_COLLECTIVES_WORKER`` in a world of n cards
    declared n/2 x 2 (4 cards) or 2 x 1 (2 cards); one run per n."""
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} GPUs")
    if n not in _HIER_RUNS:
        ranks = run_world(str(tmp_path), n, "cuda", "hierarchical",
                          _COLLECTIVES_WORKER,
                          env={"HOROVOD_LOCAL_SIZE": str(n // 2)})
        _HIER_RUNS[n] = [json.loads(str(r["result"])) for r in ranks]
    return _HIER_RUNS[n]


@pytest.mark.parametrize("n", [2, 4])
def test_hierarchical_matches_flat_across_gpus(cuda, tmp_path, n):
    """Per element, the hierarchical Average within 2^-21 sum_i |x_i| / n of
    the flat one: each side sums the n terms with n - 1 roundings of at
    most 2^-24 of the summed magnitudes, and dividing by n = 2 or 4 is
    exact. On a tensor (3 stages, one launch each) and on the optimizer's
    hook path (3 stages per bucket, none when flat)."""
    ranks = hierarchical_world(tmp_path, n)
    for r in ranks:
        assert r["layout"] == [2, n // 2]
        assert r["tensor_launches"] == [1, 1, 1]
        assert r["hook_launches_True"] == [r["buckets"]] * 3
        assert r["hook_launches_False"] == [0, 0, 0]
        assert r["tensor_err_over_tol"] <= 1.0, r
        assert r["hook_err_over_tol"] <= 1.0, r


@pytest.mark.parametrize("n", [2, 4])
def test_hierarchical_adasum_launches_b4_b5_across_gpus(cuda, tmp_path, n):
    """B4 and B5 launch once per butterfly level across the 2 nodes, and
    the result is within 1e-5 (|ref| + RMS(ref)) of the node sums combined
    by the plain butterfly shard by shard, as the JAX package combines them
    (the f64 sums differ only in order)."""
    ranks = hierarchical_world(tmp_path, n)
    for r in ranks:
        assert r["adasum_launches"] == [1, 1]
        assert r["adasum_err_over_tol"] <= 1.0, r


@pytest.mark.parametrize("n", [2, 4])
def test_alltoall_and_allgather_bit_exact_across_gpus(cuda, tmp_path, n):
    ranks = hierarchical_world(tmp_path, n)
    for r in ranks:
        assert r["alltoall_equal"]
        assert r["allgather_equal"] == [True, True]


def run_world(out_dir, n, device, opt_name, worker=_WORKER, env=None):
    """Run ``worker`` in a world of ``n`` processes with the optimizer
    ``opt_name`` and the extra environment ``env``; return each rank's
    saved arrays."""
    script = os.path.join(out_dir, "worker.py")
    with open(script, "w") as f:
        f.write(worker)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    if n > 1:
        env.update(HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   HOROVOD_NUM_PROCESSES=str(n))
    procs = [subprocess.Popen(
        [sys.executable, script, out_dir, device, opt_name],
        env=dict(env, HOROVOD_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
    return [dict(np.load(os.path.join(out_dir, f"{opt_name}_w{n}_r{r}.npz")))
            for r in range(n)]


#: AdamW's eps (torch and optax default), and the multiple of it within
#: which an element's gradient makes its AdamW update too steep a function of
#: the gradient to hold to 1e-5 (module doc).
ADAMW_EPS = 1e-8
NEAR_EPS = 100
LR = 1e-4  # the worker's AdamW learning rate


def _rms(x):
    return float(np.sqrt(np.mean(x.astype(np.float64) ** 2)))


def near_eps_elements(single, dist, name):
    """Mask of the elements of parameter ``name`` whose reduced gradient, at
    some step, differs between the two runs while lying within ``NEAR_EPS``
    eps of zero on either side."""
    mask = np.zeros(single[name].shape, bool)
    for s in range(2):
        a, b = single[f"grad{s}/{name}"], dist[f"grad{s}/{name}"]
        small = np.minimum(np.abs(a), np.abs(b)) < NEAR_EPS * ADAMW_EPS
        mask |= small & (a != b)
    return mask


@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
def test_dp_across_gpus_matches_one_process(cuda, tmp_path, opt_name):
    n = torch.cuda.device_count()
    if n < 2 or 8 % n:
        pytest.skip("needs 2, 4 or 8 GPUs")
    ranks = run_world(str(tmp_path), n, "cuda", opt_name)
    (single,) = run_world(str(tmp_path), 1, "cuda", opt_name)
    check_against_one_process(ranks, single, opt_name)


def _params(saved):
    return [k for k in saved if k not in ("losses", "launches", "counts")
            and not k.startswith(("grad", "local"))]


def check_against_one_process(ranks, single, opt_name):
    """Hold the ranks of a data-parallel run to each other and to one
    process that trained on the whole batch (module doc)."""
    for other in ranks[1:]:
        for name, w in ranks[0].items():
            if not name.startswith("local"):
                np.testing.assert_array_equal(other[name], w, err_msg=name)
    dist, n = ranks[0], len(ranks)
    np.testing.assert_allclose(dist["losses"], single["losses"], rtol=1e-5)
    params = _params(single)
    if opt_name == "sgd":
        for name in params:
            np.testing.assert_allclose(dist[name], single[name], rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        return
    # Read everything first, so that a failure shows the whole reading.
    report = {"grad_err": None, "elements": 0, "near_eps": 0,
              "worst_held": None, "worst_near_eps": None}

    def element(name, i):
        return {"param": name, "index": [int(x) for x in i],
                "dtheta": float(abs(dist[name][i] - single[name][i])),
                "grad_one_process": [float(single[f"grad{s}/{name}"][i])
                                     for s in range(2)],
                f"grad_{n}_ranks": [float(dist[f"grad{s}/{name}"][i])
                                    for s in range(2)]}

    def keep_worst(key, candidate, by):
        if report[key] is None or candidate[by] > report[key][by]:
            report[key] = candidate

    excess, bound = {}, {}
    for name in params:
        # The first step's reduced gradient is taken at the same parameters
        # on both sides: the same terms summed in another order.
        g, h = single[f"grad0/{name}"], dist[f"grad0/{name}"]
        rel = np.abs(h - g) / (np.abs(g) + _rms(g))
        i = np.unravel_index(rel.argmax(), rel.shape)
        keep_worst("grad_err", {"param": name, "rel": float(rel[i]),
                                "abs": float(abs(h - g)[i])}, "rel")
        a, b = single[name], dist[name]
        skip = near_eps_elements(single, dist, name)
        diff = np.abs(b - a)
        excess[name] = np.where(skip, 0.0,
                                diff - 1e-5 * (1 + np.abs(a))).max()
        bound[name] = diff[skip].max(initial=0.0)
        report["elements"] += a.size
        report["near_eps"] += int(skip.sum())
        i = np.unravel_index(np.where(skip, -1.0, diff).argmax(), a.shape)
        keep_worst("worst_held", element(name, i), "dtheta")
        if skip.any():
            i = np.unravel_index(np.where(skip, diff, -1.0).argmax(), a.shape)
            keep_worst("worst_near_eps", element(name, i), "dtheta")
    print(f"adamw across {n} GPUs:", json.dumps(report))
    assert report["grad_err"]["rel"] <= 1e-4, report
    for name in params:
        assert excess[name] <= 0.0, (name, report)
        # Near eps each side still takes an AdamW step, at most lr in size.
        assert bound[name] <= 2 * 2 * LR, (name, report)
    assert report["near_eps"] <= 1e-2 * report["elements"], report


@pytest.mark.parametrize("n", [2, 4])
def test_adasum_across_gpus_matches_plain_butterfly(cuda, tmp_path, n):
    """``DistributedOptimizer(AdamW, op=Adasum)`` over NCCL on n cards, a
    different shard per rank: each step launches B4 and B5 log2(n) times
    per rank, the ranks end bit-identical, and rank 0's first reduced
    gradient is held to the plain butterfly (``_plain_combine``, on the
    CPU) of the gathered local gradients, per element within 1e-5 (|ref| +
    RMS(ref)): the two sides differ only in the order of the f64 sums."""
    from horovod_tpu_torch.ops import fused
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} GPUs")
    ranks = run_world(str(tmp_path), n, "cuda", "adasum")
    levels = n.bit_length() - 1
    for r in ranks:
        assert r["launches"].tolist() == [[levels, levels]] * 2
        assert np.isfinite(r["losses"]).all()
    for other in ranks[1:]:
        for name in _params(ranks[0]) + [k for k in ranks[0]
                                         if k.startswith("grad")]:
            np.testing.assert_array_equal(other[name], ranks[0][name],
                                          err_msg=name)
    names = [k[len("grad0/"):] for k in ranks[0] if k.startswith("grad0/")]
    vecs = [torch.from_numpy(np.concatenate(
        [r[f"local0/{k}"].ravel() for k in names])) for r in ranks]
    d = 1
    while d < n:
        vecs = [fused._plain_combine(vecs[i], vecs[i ^ d]) for i in range(n)]
        d *= 2
    ref = vecs[0].double()
    got = torch.from_numpy(np.concatenate(
        [ranks[0][f"grad0/{k}"].ravel() for k in names])).double()
    tol = 1e-5 * (ref.abs() + ref.square().mean().sqrt())
    assert ((got - ref).abs() <= tol).all(), \
        ((got - ref).abs() / tol).max().item()


@pytest.mark.parametrize("n", [2, 4])
def test_sync_batch_norm_resnet_across_gpus_matches_one_process(cuda,
                                                                tmp_path, n):
    """``ResNetTiny`` with SyncBatchNorm, two SGD-momentum steps over NCCL
    on n cards, each a shard of 8 images, against one process on all 8: the
    batch statistics are global on both sides, so parameters and running
    statistics agree within 1e-5 (summation order; SGD is linear in the
    gradient) and the ranks end bit-identical. Each step launches one
    all-reduce per gradient bucket, one for the loss, one for the running
    statistics (one bucket) and two per BatchNorm layer (its statistics
    forward, their cotangent backward); one process launches only the
    gradient buckets."""
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} GPUs")
    ranks = run_world(str(tmp_path), n, "cuda", "resnet", _RESNET_WORKER)
    (single,) = run_world(str(tmp_path), 1, "cuda", "resnet", _RESNET_WORKER)
    buckets, norms, stats = ranks[0]["counts"].tolist()
    assert stats == 2 * norms
    assert ranks[0]["launches"].tolist() == [buckets + 2 + 2 * norms] * 2
    assert single["launches"].tolist() == [buckets] * 2
    for other in ranks[1:]:
        for name in _params(ranks[0]):
            np.testing.assert_array_equal(other[name], ranks[0][name],
                                          err_msg=name)
    np.testing.assert_allclose(ranks[0]["losses"], single["losses"],
                               rtol=1e-5)
    for name in _params(single):
        np.testing.assert_allclose(ranks[0][name], single[name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)


_SHARDING_WORKER = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import create_mesh, sharding
    from horovod_tpu_torch.train import vocab_parallel_nll

    out_dir, device, name = sys.argv[1], sys.argv[2], sys.argv[3]
    hvd.init(device=device)
    rank, n = hvd.rank(), hvd.size()
    dev = hvd.device()
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}

    # The vocab-parallel loss against the whole-tensor one, on a tp axis.
    tp = create_mesh({"tp": n}).axis("tp")
    N, V = 4096, 32064
    logits = torch.randn((N, V), generator=gen, device=dev) * 4
    targets = torch.randint(0, V, (N,), generator=gen, device=dev)
    w = torch.rand((N,), generator=gen, device=dev)
    whole = logits.clone().requires_grad_()
    ref = vocab_parallel_nll(whole, targets)
    (ref * w).sum().backward()
    part = logits.chunk(n, dim=1)[rank].clone().requires_grad_()
    sharding.reset_counts()
    got = vocab_parallel_nll(part, targets, tp)
    (got * w).sum().backward()
    out["loss_all_reduces"] = sharding.counts["tp_all_reduce"]
    out["nll_err"] = ((got - ref).abs() / (1e-5 * ref.abs())).max().item()
    want = whole.grad.chunk(n, dim=1)[rank]
    out["grad_err"] = ((part.grad - want).abs().max()
                       / (4e-6 * want.abs().max())).item()

    # The fsdp gather (bf16 forward) and reduce-scatter (f32 backward), on
    # both dims of a [out, in] weight, against the whole weight.
    fsdp = create_mesh({"fsdp": n})
    W = torch.randn((1024, 4096), generator=gen, device=dev)
    gens = [torch.Generator(device=dev).manual_seed(1 + r) for r in range(n)]
    G = [torch.randn(W.shape, generator=g, device=dev) for g in gens]
    res = []
    for names in (("mlp", "embed"), ("embed", "mlp")):
        place = sharding.placement(fsdp, names, W.shape)
        shard = torch.nn.Parameter(place.block(W).clone())
        sharding.set_placement(shard, place)
        sharding.reset_counts()
        full = sharding.gather_param(shard, torch.bfloat16)
        (full.float() * G[rank]).sum().backward()
        want = place.block(sum(g.to(torch.bfloat16).float() for g in G))
        res.append([bool(torch.equal(full, W.to(torch.bfloat16))),
                    bool(torch.equal(shard.grad, want)),
                    sharding.counts["all_gather"],
                    sharding.counts["reduce_scatter"]])
    out["fsdp"] = res
    np.savez(f"{out_dir}/{name}_w{n}_r{rank}.npz",
             result=np.asarray(json.dumps(out)))
    hvd.shutdown()
""")


_SHARDING_RUNS: dict = {}


def sharding_world(tmp_path, device="cuda"):
    """Each rank's results of ``_SHARDING_WORKER`` in a world of 2."""
    if device == "cuda" and torch.cuda.device_count() < 2:
        pytest.skip("needs 2 GPUs")
    if device not in _SHARDING_RUNS:
        ranks = run_world(str(tmp_path), 2, device, "sharding",
                          _SHARDING_WORKER)
        _SHARDING_RUNS[device] = [json.loads(str(r["result"]))
                                  for r in ranks]
    return _SHARDING_RUNS[device]


def test_vocab_parallel_loss_across_gpus(cuda, tmp_path):
    """``lse - target logit`` over two vocab halves (max, then the sum of
    exponentials and the target logit in one all-reduce) within 1e-5
    relative of the whole-tensor loss per position, its gradient (``softmax
    - onehot`` on the local half) within 4e-6 of the largest element of the
    whole gradient: both sum the same f32 terms in different orders, and
    an lse near 14 that differs in its last bit (2^-23 x 14 = 1.7e-6)
    moves every softmax term by that share; 4e-6 allows two such bits."""
    for r in sharding_world(tmp_path):
        assert r["loss_all_reduces"] == 2
        assert r["nll_err"] <= 1.0, r
        assert r["grad_err"] <= 1.0, r


def test_fsdp_gather_and_reduce_scatter_across_gpus(cuda, tmp_path):
    """The gathered bf16 weight equals the whole weight cast to bf16, on
    either sharded dim; the shard's gradient equals its block of the sum of
    both ranks' f32 cotangents (a sum of two terms rounds the same either
    way): one all-gather and one reduce-scatter each."""
    for r in sharding_world(tmp_path):
        assert r["fsdp"] == [[True, True, 1, 1]] * 2


_SLICE10_WORKER = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.bert import Bert, BertConfig
    from horovod_tpu_torch.models.mixtral import (Mixtral, MixtralConfig,
                                                  router_load)
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import create_mesh, sharding

    out_dir, device, name = sys.argv[1], sys.argv[2], sys.argv[3]
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device=device)
    rank, n = hvd.rank(), hvd.size()
    dev = hvd.device()
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    gap = lambda a, b: ((a.float() - b.float()).norm()
                        / b.float().norm()).item()

    # Mixtral on tp: the tp ranks route the same tokens alike, and the
    # vocab-split logits are the whole model's.
    cfg = MixtralConfig(vocab_size=1024, dim=256, n_layers=2, n_heads=4,
                        n_kv_heads=2, hidden_dim=512, max_seq_len=512,
                        remat=False, use_flash=True)
    toks = torch.randint(0, 1024, (2, 512), generator=gen, device=dev)
    with torch.no_grad():
        logits = Mixtral(cfg, seed=0, mesh=create_mesh({"tp": n}))(toks)
        whole = Mixtral(cfg, seed=0, mesh=None)
        out["mixtral_gap"] = gap(logits, whole(toks).chunk(n, -1)[rank])
    tp_model = Mixtral(cfg, seed=0, mesh=create_mesh({"tp": n}))
    with torch.no_grad():
        tp_model(toks)
    out["tp_loads"] = router_load(tp_model)

    # The bank's gather over fsdp on w2's embed dim (2), bf16 forward, f32
    # reduce-scatter backward, against the whole bank.
    fsdp = create_mesh({"fsdp": n})
    W = torch.randn((8, 512, 256), generator=gen, device=dev)
    G = [torch.randn(W.shape, generator=torch.Generator(device=dev)
                     .manual_seed(1 + r), device=dev) for r in range(n)]
    place = sharding.placement(fsdp, ("experts", "mlp", "embed"), W.shape)
    shard = torch.nn.Parameter(place.block(W).clone())
    sharding.set_placement(shard, place)
    full = sharding.gather_param(shard, torch.bfloat16)
    (full.float() * G[rank]).sum().backward()
    want = place.block(sum(g.to(torch.bfloat16).float() for g in G))
    out["bank"] = [place.dim_of("fsdp"),
                   bool(torch.equal(full, W.to(torch.bfloat16))),
                   bool(torch.equal(shard.grad, want))]

    # BERT on tp: B1-B3 on the local heads with the key bias, the
    # vocab-split logits against the whole model's.
    bcfg = BertConfig(vocab_size=1024, dim=512, n_layers=2, n_heads=8,
                      hidden_dim=1024, max_seq_len=512, remat=False,
                      use_flash=True)
    mask = torch.ones((2, 512), dtype=torch.bool, device=dev)
    mask[1, 300:] = False
    bert = Bert(bcfg, seed=0, mesh=create_mesh({"tp": n}))
    fa.reset_launch_counts()
    logits = bert(toks, mask)
    logits.float().square().mean().backward()
    out["bert_launches"] = {k: f.launches for k, f in fa.KERNELS.items()}
    with torch.no_grad():
        ref = Bert(bcfg, seed=0, mesh=None)(toks, mask).chunk(n, -1)[rank]
    out["bert_gap"] = gap(logits.detach(), ref)
    np.savez(f"{out_dir}/{name}_w{n}_r{rank}.npz",
             result=np.asarray(json.dumps(out)))
    hvd.shutdown()
""")

_SLICE10_RUNS: dict = {}


def slice10_world(tmp_path):
    """Each rank's results of ``_SLICE10_WORKER`` in a world of 2."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 GPUs")
    if not _SLICE10_RUNS:
        ranks = run_world(str(tmp_path), 2, "cuda", "slice10",
                          _SLICE10_WORKER)
        _SLICE10_RUNS["cuda"] = [json.loads(str(r["result"]))
                                 for r in ranks]
    return _SLICE10_RUNS["cuda"]


def test_mixtral_tp_ranks_route_alike_across_gpus(cuda, tmp_path):
    """``chip_smoke.py``'s ``mixtral-mp`` gate at a small width: the tp
    ranks' routing counts are equal (a bf16 model split over tp need not
    route as the whole model does: its residual stream differs in the last
    bits, which moves near-tied choices); the vocab-split bf16 logits
    within 2^-5 normwise of the whole model's (the tp all-reduces sum bf16
    partial products in another order)."""
    ranks = slice10_world(tmp_path)
    for r in ranks:
        assert r["tp_loads"] == ranks[0]["tp_loads"]
        assert r["mixtral_gap"] <= 2 ** -5, r["mixtral_gap"]


def test_bank_gather_on_its_embed_dim_across_gpus(cuda, tmp_path):
    """``w2``'s ``[E, M, D]`` bank split over fsdp on dim 2: the gathered
    bf16 bank equals the whole bank cast, and the block's gradient its
    block of the sum of both ranks' f32 cotangents."""
    for r in slice10_world(tmp_path):
        assert r["bank"] == [2, True, True]


def test_bert_tp_runs_b1_b3_on_local_heads_across_gpus(cuda, tmp_path):
    """``bert-mp``'s gate at a small width: B1 once and B2, B3 once a
    layer on the 4 local heads with the key bias, and the vocab-split
    logits within 2^-5 normwise of the whole model's."""
    for r in slice10_world(tmp_path):
        assert r["bert_launches"] == {"fa_fwd": 2, "fa_bwd_dq": 2,
                                      "fa_bwd_dkv": 2}
        assert r["bert_gap"] <= 2 ** -5, r["bert_gap"]


# --- slice 12: the sentinel, the frontend and the watchdog on the card -------

def test_param_digest_on_the_card_equals_the_cpu(cuda):
    """The XOR fold on the card gives the CPU's word, over f32, bf16 and f16
    leaves, odd lengths and several chunks (the CPU side is held to JAX's
    in ``test_torch_port_sentinel.py``)."""
    from horovod_tpu_torch.core.sentinel import param_digest
    gen = torch.Generator().manual_seed(0)
    leaves = [torch.randn(3_000_017, generator=gen),
              torch.randn(1023, 77, generator=gen).bfloat16(),
              torch.randn(5, generator=gen).half(),
              torch.zeros(0)]
    want = int(param_digest(leaves))
    assert int(param_digest([t.cuda() for t in leaves])) == want


def test_health_probe_on_the_card(cuda):
    """``DistributedOptimizer``'s bucket probe on the card, in a world of
    one: the finite bit and the squared norm of the gradients it saw before
    the all-reduce (the squared norm within 1e-5 of the f64 sum), and a
    NaN gradient's step withheld by ``make_train_step``'s guard with the
    parameters bitwise unchanged."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import sentinel as S
    from horovod_tpu_torch.train import create_train_state, make_train_step
    hvd.init()
    try:
        model = torch.nn.Sequential(torch.nn.Linear(256, 512),
                                    torch.nn.Linear(512, 3)).cuda()
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=0.1))
        s = S.Sentinel()
        step = make_train_step(model, opt,
                               lambda y, t: (y - t).square().mean() * t[0, 0],
                               sentinel=s)
        rows = []
        real = opt.health
        opt.health = lambda *a, **k: rows.append(real(*a, **k)) or rows[-1]
        state = create_train_state(model, opt)
        x = torch.randn(8, 256, device="cuda")
        t = torch.ones(8, 3, device="cuda")
        state, _ = step(state, x, t)
        grads = [p.grad.double() for p in model.parameters()]
        sq = float(sum(g.square().sum() for g in grads))
        assert rows[0][0, 0].item() == 1.0
        assert abs(rows[0][0, 1].item() - sq) <= 1e-5 * sq
        before = [p.detach().clone() for p in model.parameters()]
        t[0, 0] = float("nan")
        state, _ = step(state, x, t)
        assert rows[1][0, 0].item() == 0.0 and s.steps_skipped == 1
        assert all(torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))
    finally:
        hvd.shutdown()


_FRONTEND_WORKER = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch
    from horovod_tpu_torch import frontend as hvd

    out_dir, _, name = sys.argv[1:4]
    hvd.init()
    rank, n = hvd.rank(), hvd.size()
    out = {}
    x = torch.arange(1 << 20, device="cuda", dtype=torch.float32) % 5
    names = ["a", "b"] if rank == 0 else ["b", "a"]
    hs = {nm: hvd.allreduce_async(x * (rank + 1) * (1 + (nm == "b")),
                                  op=hvd.Sum, name=nm) for nm in names}
    total = x * sum(range(1, n + 1))
    out["opposite"] = (torch.equal(hvd.synchronize(hs["a"]), total)
                       and torch.equal(hvd.synchronize(hs["b"]), 2 * total))
    g = hvd.allgather(torch.full((rank + 1, 3), float(rank), device="cuda"))
    out["allgather"] = g.shape[0] == n * (n + 1) // 2
    h = hvd.allreduce_async(torch.ones(3 + rank, device="cuda"), name="mm")
    try:
        hvd.synchronize(h)
        out["mismatch"] = ""
    except ValueError as e:
        out["mismatch"] = str(e)
    y = torch.full((4,), float(rank), device="cuda")
    hvd.synchronize(hvd.broadcast_async_(y, 1, name="bc"))
    out["broadcast"] = torch.equal(y, torch.ones(4, device="cuda"))
    out["stats"] = hvd.negotiation_stats()
    hvd.shutdown()
    np.savez(f"{out_dir}/{name}_w{n}_r{rank}.npz",
             result=np.asarray(json.dumps(out)))
""")


def test_frontend_handles_across_gpus(cuda, tmp_path):
    """The frontend over NCCL on 2 GPUs: named all-reduces submitted in
    opposite orders pair by name, an uneven allgather, an in-place
    broadcast, and a name whose shape differs between the ranks raises on
    both without a hang."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 GPUs")
    ranks = [json.loads(str(r["result"])) for r in run_world(
        str(tmp_path), 2, "cuda", "frontend", _FRONTEND_WORKER)]
    for r in ranks:
        assert r["opposite"] and r["allgather"] and r["broadcast"], r
        assert "mismatched allreduce for name 'mm'" in r["mismatch"]
        assert r["stats"]["ops"] >= 4


_WATCHDOG_WORKER = textwrap.dedent("""
    import json
    import os
    import sys
    import time
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import watchdog
    from horovod_tpu_torch.core.exceptions import HorovodInternalError
    from horovod_tpu_torch.train import create_train_state, make_train_step

    out_dir, _, name = sys.argv[1:4]
    hvd.init()
    rank, n = hvd.rank(), hvd.size()
    model = torch.nn.Linear(64, 64, device="cuda")
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.01))
    step = make_train_step(model, opt, lambda y, t: (y - t).square().mean())
    state = create_train_state(model, opt)
    x = torch.randn(8, 64, device="cuda")
    state, _ = step(state, x, x)
    torch.cuda.synchronize()
    out = {}
    if rank == 1:
        time.sleep(7.0)
    else:
        t0 = time.monotonic()
        try:
            step(state, x, x)
            out["raised"] = False
        except HorovodInternalError:
            out["raised"] = True
        out["seconds"] = time.monotonic() - t0
        out["aborted"] = bool(watchdog.monitor().aborted)
    np.savez(f"{out_dir}/{name}_w{n}_r{rank}.npz",
             result=np.asarray(json.dumps(out)))
    os._exit(0)
""")


def test_watchdog_rescues_a_hung_nccl_step_across_gpus(cuda, tmp_path):
    """With ``HOROVOD_STEP_TIMEOUT_SECONDS=3`` and rank 1 holding back its
    second step, rank 0's monitored step raises ``HorovodInternalError``
    within the deadline plus 2 s and aborts the NCCL communicators."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 GPUs")
    ranks = [json.loads(str(r["result"])) for r in run_world(
        str(tmp_path), 2, "cuda", "watchdog", _WATCHDOG_WORKER,
        env={"HOROVOD_STEP_TIMEOUT_SECONDS": "3"})]
    r0 = ranks[0]
    assert r0["raised"] and r0["aborted"] and r0["seconds"] <= 5.0, r0


# --- the paged-KV decode on the card -----------------------------------------

#: The decode path's bf16 logits against the reference's, normwise, and the
#: near-tie bound on a flip (the reference's top-2 margin over the RMS of
#: its row): ``chip_smoke.py``'s ``serve`` rule (the tie bound four times
#: the normwise gate) at two layers, where the two paths' roundings add up
#: over 2 layers, not 32: ``SERVE_NORMWISE``'s reasoning gives sqrt(20) x
#: 2^-9 = 0.009, and 2^-5 leaves a factor of three over it.
DECODE_NORMWISE = 2 ** -5
DECODE_TIE = 4 * DECODE_NORMWISE


def _decode_cfg():
    from horovod_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(vocab_size=1024, dim=256, n_layers=2, n_heads=4,
                       n_kv_heads=2, hidden_dim=512, max_seq_len=512,
                       remat=False, use_flash=True)


def _margin(row):
    top = row.float().topk(2).values
    return ((top[0] - top[1]) / row.float().square().mean().sqrt()).item()


def test_decode_on_the_card_matches_the_full_forward(cuda):
    """A small bf16 Llama on the card: prefill logits and teacher-forced
    decode logits (positions 27-34, across a block boundary, 1 of 4 slots
    active) within 2^-5 normwise of ``Llama.forward`` (B1) at the same
    weights; the engine's greedy streams equal the forward's argmax on
    their own prefix but at near ties (top-2 margin at most 2^-3 RMS);
    the null block zero; no kernel of B1-B5 on the decode path."""
    from horovod_tpu_torch.models import decode as MD
    from horovod_tpu_torch.models.llama import Llama
    from horovod_tpu_torch.serving import DecodeEngine
    from horovod_tpu_torch.train.step_builder import export_decode_params
    cfg = _decode_cfg()
    model = Llama(cfg, seed=0)
    params = export_decode_params(model)
    gen = torch.Generator().manual_seed(0)
    seq = torch.randint(0, cfg.vocab_size, (35,), generator=gen).tolist()
    with torch.no_grad():
        ref = model(torch.tensor([seq], device="cuda"))[0]
    kp, vp = MD.init_kv_pools(cfg, 16, 16)
    padded = torch.zeros((1, 32), dtype=torch.long, device="cuda")
    padded[0, :27] = torch.tensor(seq[:27])
    logits, kp, vp = MD.make_prefill(cfg, 16)(
        params, kp, vp, padded, torch.tensor([1, 2], device="cuda"))
    gap = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    assert gap(logits[0, :27], ref[:27]) <= DECODE_NORMWISE
    decode = MD.make_decode_step(cfg, 16)
    tables = torch.zeros((4, 8), dtype=torch.long, device="cuda")
    tables[0, :3] = torch.tensor([1, 2, 3])
    active = torch.tensor([True, False, False, False], device="cuda")
    for pos in range(27, 35):
        toks = torch.tensor([seq[pos], 0, 0, 0], device="cuda")
        poss = torch.tensor([pos, 0, 0, 0], device="cuda")
        lg, _, kp, vp = decode(params, kp, vp, toks, poss, tables, active)
        assert gap(lg[0], ref[pos]) <= DECODE_NORMWISE, pos
    assert not kp[:, 0].any() and not vp[:, 0].any()
    eng = DecodeEngine(cfg, params=params, slots=4, block_size=16,
                       pool_blocks=33, max_blocks_per_slot=8,
                       prefill_buckets=(32, 64))
    from horovod_tpu_torch.ops import flash_attention as fa
    fa.reset_launch_counts()
    prompts = [seq[:n] for n in (5, 27, 40, 60)]
    reqs = [eng.submit(p, 24) for p in prompts]
    eng.run_until_idle()
    assert all(f.launches == 0 for f in fa.KERNELS.values())
    for p, r in zip(prompts, reqs):
        with torch.no_grad():
            rows = model(torch.tensor([r.tokens[:-1]], device="cuda"))[0]
        want = rows[len(p) - 1:].argmax(-1).tolist()
        for j, (w, g) in enumerate(zip(want, r.tokens[len(p):])):
            if w != g:
                assert _margin(rows[len(p) - 1 + j]) <= DECODE_TIE
    assert not eng._kp[:, 0].any() and not eng._vp[:, 0].any()


_DECODE_TP_WORKER = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import decode as MD
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig
    from horovod_tpu_torch.parallel import create_mesh
    from horovod_tpu_torch.serving import DecodeEngine
    from horovod_tpu_torch.train.step_builder import export_decode_params

    out_dir, _, name = sys.argv[1:4]
    hvd.init()
    rank, n = hvd.rank(), hvd.size()
    cfg = LlamaConfig(vocab_size=1024, dim=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, hidden_dim=512, max_seq_len=512,
                      remat=False)
    whole = export_decode_params(Llama(cfg, seed=0))
    mesh = create_mesh({"tp": n})
    kw = dict(slots=4, block_size=16, pool_blocks=33, max_blocks_per_slot=8,
              prefill_buckets=(32, 64))
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(0, 1024, (k,), generator=gen).tolist()
               for k in (5, 27, 40, 60)]

    def run(eng):
        reqs = [eng.submit(p, 24) for p in prompts] if rank == 0 else []
        eng.run_until_idle()
        return eng, [r.tokens for r in reqs]

    eng = DecodeEngine(cfg, params=MD.decode_shard(cfg, whole, n, rank),
                       mesh=mesh, **kw)
    retired = []
    real = eng._retire
    def retire(idx, truncated=False):
        req = eng.slots[idx].req
        real(idx, truncated)
        retired.append(req.tokens)
    eng._retire = retire
    eng, tp = run(eng)
    eng.close()
    out = {"retired": retired}
    if rank == 0:
        _, one = run(DecodeEngine(cfg, params=whole, **kw))
        prefill = MD.make_prefill(cfg, 16)
        margins = []
        for a, b in zip(tp, one):
            if a == b:
                continue
            i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            T = -(-i // 16) * 16
            kp, vp = MD.init_kv_pools(cfg, T // 16 + 1, 16)
            padded = torch.zeros((1, T), dtype=torch.long, device="cuda")
            padded[0, :i] = torch.tensor(a[:i])
            lg, *_ = prefill(whole, kp, vp, padded,
                             torch.arange(1, T // 16 + 1, device="cuda"))
            row = lg[0, i - 1].float()
            top = row.topk(2).values
            margins.append(((top[0] - top[1])
                            / row.square().mean().sqrt()).item())
        out.update(tp=tp, margins=margins)
    np.savez(f"{out_dir}/{name}_w{n}_r{rank}.npz",
             result=np.asarray(json.dumps(out)))
    hvd.shutdown()
""")


def test_decode_tp_streams_across_gpus(cuda, tmp_path):
    """The engine over tp 2 on NCCL: both ranks retire the same streams,
    and where they part from the one-card engine's at the same weights
    the one-card prefill's top-2 margin is at most 2^-3 RMS (the tp ranks
    sum bf16 partials in another order)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 GPUs")
    ranks = [json.loads(str(r["result"])) for r in run_world(
        str(tmp_path), 2, "cuda", "decode_tp", _DECODE_TP_WORKER)]
    assert ranks[0]["retired"] == ranks[1]["retired"]
    assert len(ranks[0]["tp"]) == 4
    assert all(m <= DECODE_TIE for m in ranks[0]["margins"]), ranks[0]
