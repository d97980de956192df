"""Flash attention with ring-mergeable softmax residuals, on Hopper.

Counterpart of ``horovod_tpu/ops/flash_attention.py``. The three Pallas TPU
kernels of that module are CUDA C++ kernels here (``csrc/flash_attention.cu``;
the bf16 kernels, which run on the tensor cores, in
``csrc/flash_attention_sm90.cuh``), each behind a wrapper that checks its
inputs, allocates its outputs, launches on the current stream and counts its
launches:

- :func:`fa_fwd` (B1) replaces ``_fa_kernel``: blockwise online-softmax
  attention returning ``o`` and the residuals ``m`` (running max) and ``l``
  (denominator).
- :func:`fa_bwd_dq` (B2) replaces ``_fa_bwd_dq_kernel``: the FlashAttention-2
  dQ pass.
- :func:`fa_bwd_dkv` (B3) replaces ``_fa_bwd_dkv_kernel``: the dK/dV pass.

Beside each kernel is its plain PyTorch version (:func:`_reference_partial`,
:func:`_plain_bwd_dq`, :func:`_plain_bwd_dkv`). A wrapper takes the plain
version only for tensors on the CPU, which is how the CPU tests run this
module; for a CUDA tensor it launches the kernel or raises. B1 runs as the
torch custom op ``hvd::fa_fwd`` (CUDA implementation: the kernel; CPU
implementation: the plain version), so a remat policy can name it.

The kernels keep the model's ``[B, T, H, D]`` layout (no fold to ``[B*H, T,
D]``) and mask the ragged sequence edge themselves, so nothing is padded or
copied around them. The masking algebra is the TPU kernel's: the finite
``NEG_INF``, probabilities at ``s <= NEG_INF / 2`` set to 0, and rows that see
no key get ``l = 0`` and output 0 — ring attention and :func:`merge_partials`
depend on it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # finite mask value: exp() underflows cleanly, no NaN algebra

#: Head dims the CUDA kernels are instantiated for (BERT-Large and the Llama
#: bench use 64, Llama-3-8B uses 128).
KERNEL_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------------ plain versions

def _causal_mask(Tq: int, Tk: int, device) -> torch.Tensor:
    return (torch.arange(Tq, device=device)[:, None]
            >= torch.arange(Tk, device=device)[None, :])


def _scores(q, k, bias, *, causal, scale):
    """Masked, scaled f32 scores ``[B, H, Tq, Tk]``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    if causal:
        s = torch.where(_causal_mask(q.shape[1], k.shape[1], q.device), s,
                        NEG_INF)
    return s


def _reference_partial(q, k, v, bias=None, *, causal, scale):
    """Plain version of B1: blockless attention with the same ``(o, m, l)``
    partial semantics. q ``[B, Tq, H, D]``; k, v ``[B, Tk, H, D]``; optional
    additive score bias ``[B, Tk]``; returns o ``[B, Tq, H, D]``, m and l
    ``[B, H, Tq]`` in f32. Also the recompute of the residual path's
    backward."""
    s = _scores(q, k, bias, causal=causal, scale=scale)
    m = s.amax(dim=-1)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m[..., None]))
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o / torch.where(l == 0.0, 1.0, l).transpose(1, 2)[..., None]
    return o.to(q.dtype), m, l


def _recompute_p_ds(q, k, v, do, m, l, dsum, bias, *, causal, scale):
    """Probabilities ``p`` and score cotangent ``ds`` from the saved softmax
    statistics, as the TPU backward kernels recompute them per tile."""
    s = _scores(q, k, bias, causal=causal, scale=scale)
    l = torch.where(l == 0.0, 1.0, l)
    p = torch.where(s <= NEG_INF / 2, 0.0,
                    torch.exp(s - m[..., None])) / l[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - dsum[..., None])  # dsum: rowsum(dO*O), the FA2 term
    return p, ds


def _plain_bwd_dq(q, k, v, do, m, l, dsum, bias=None, *, causal, scale):
    """Plain version of B2: ``dQ = dS K * scale``."""
    _, ds = _recompute_p_ds(q, k, v, do, m, l, dsum, bias, causal=causal,
                            scale=scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype)


def _plain_bwd_dkv(q, k, v, do, m, l, dsum, bias=None, *, causal, scale):
    """Plain version of B3: ``dV = P^T dO`` and ``dK = dS^T Q * scale``."""
    p, ds = _recompute_p_ds(q, k, v, do, m, l, dsum, bias, causal=causal,
                            scale=scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ kernel wrappers

def _check_aligned(*tensors):
    """The bf16 kernels read their operands by TMA, which needs each
    operand's address 16-byte aligned (its row strides, D * 2 and H * D * 2
    bytes, always are)."""
    for t in tensors:
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError("bf16 flash kernel operands must be 16-byte "
                             f"aligned, not at address {t.data_ptr():#x}")


def _check(q, k, v, bias, *others):
    """Validate what the CUDA kernels accept; raise on anything else."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernels take float32 or bfloat16, not "
                        f"{q.dtype}")
    D = q.shape[-1]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernels take head dims {KERNEL_HEAD_DIMS}, "
                         f"not {D}")
    B, _, H, _ = q.shape
    if k.shape[0] != B or k.shape[2:] != (H, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[1] == 0:
        raise ValueError("flash kernels need at least one key")
    for t in (q, k, v, *others):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash kernel operands must share one CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError("flash kernel operands must be contiguous")
    _check_aligned(q, k, v, *others)
    for t in (k, v):
        if t.dtype != q.dtype:
            raise TypeError("q, k and v must share one dtype")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.shape != (B, k.shape[1])
                             or bias.device != q.device
                             or not bias.is_contiguous()):
        raise ValueError("bias must be a contiguous float32 [B, Tk] tensor "
                         "on the operands' device")


def _check_bwd(q, do, m, l, dsum):
    """The backward kernels' extra operands: dO like q, and the f32
    statistics ``[B, H, Tq]``."""
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("dO must match q in shape and dtype")
    want = (q.shape[0], q.shape[2], q.shape[1])
    for t in (m, l, dsum):
        if t.dtype != torch.float32 or t.shape != want:
            raise ValueError(f"m, l and dsum must be float32 {want}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        from . import _build
        msg = _build.library().hvd_error_string(rc).decode()
        raise RuntimeError(f"{what} CUDA kernel failed to launch: {msg} "
                           f"(cudaError {rc})")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def fa_fwd(q, k, v, bias=None, *, causal: bool, scale: float):
    """B1, the forward kernel: ``(o, m, l)`` of attention over ``[B, T, H,
    D]`` tensors, m and l ``[B, H, Tq]`` f32.

    Replaces ``horovod_tpu/ops/flash_attention.py::_fa_kernel``. On the H100
    at the Llama-3-8B training shape it is bound by its two products (69.5
    us of dense bf16 tensor-core time). In bf16 it runs on the tensor cores
    (``fa_fwd_kernel_sm90``): TMA brings K and V tiles through a ring in
    shared memory, wgmma forms S and P V, and the online softmax runs on the
    score fragment in registers; P enters P V as a bf16 hi + lo pair, which
    keeps it to about 16 bits. f32 keeps the CUDA-core kernel
    (``fa_fwd_kernel``). See the sources' notes.

    The work goes through the torch custom op ``hvd::fa_fwd``, so the
    dispatcher sees it: a selective-checkpoint policy can save its three
    outputs by name, as the JAX package's policies save ``attn_out``,
    ``attn_lse_m`` and ``attn_lse_l`` (``models/llama.py::_REMAT_POLICIES``).
    Its CUDA implementation launches the kernel; its CPU implementation is
    the plain version. ``fa_fwd.calls`` counts the op's runs on either
    device (a saved output replayed in a recompute does not run it);
    ``fa_fwd.launches`` counts the kernel's launches.
    """
    if q.device.type != "cpu":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        _check(q, k, v, bias)
    return torch.ops.hvd.fa_fwd(q, k, v, bias, causal, float(scale))


fa_fwd.launches = 0
fa_fwd.calls = 0


@torch.library.custom_op("hvd::fa_fwd", mutates_args=())
def _fa_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: Optional[torch.Tensor], causal: bool,
               scale: float) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """B1 on the CPU: its plain version."""
    fa_fwd.calls += 1
    return _reference_partial(q, k, v, bias, causal=causal, scale=scale)


@_fa_fwd_op.register_kernel("cuda")
def _fa_fwd_cuda(q, k, v, bias, causal, scale):
    """B1 on the card: the kernel, on the current stream. The operands were
    checked by :func:`fa_fwd`."""
    from . import _build
    fa_fwd.calls += 1
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    o = torch.empty_like(q)
    m = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    rc = _build.library().hvd_fa_fwd(
        _DTYPE_CODE[q.dtype], D, _ptr(q), _ptr(k), _ptr(v), _ptr(bias),
        _ptr(o), _ptr(m), _ptr(l), B, H, Tq, Tk, float(scale), int(causal),
        _stream())
    _raise_on(rc, "fa_fwd")
    fa_fwd.launches += 1
    return o, m, l


def fa_bwd_dq(q, k, v, do, m, l, dsum, bias=None, *, causal: bool,
              scale: float):
    """B2, the dQ kernel: ``dQ`` from the saved ``(m, l)`` and ``dsum =
    rowsum(dO * O)`` (all ``[B, H, Tq]`` f32).

    Replaces ``horovod_tpu/ops/flash_attention.py::_fa_bwd_dq_kernel``.
    Bound on the H100 by its three products (104 us of dense bf16
    tensor-core time at the Llama-3-8B shape); each thread block owns a
    q-tile and loops over the k-tiles, so dQ needs no atomics. In bf16 it
    runs on the tensor cores (``fa_bwd_dq_kernel_sm90``): Q and dO stay in
    shared memory while TMA streams K and V; wgmma forms S, dP and dS K,
    with P recomputed from the saved statistics and dS entering as a bf16
    hi + lo pair from registers. f32 keeps the CUDA-core kernel
    (``fa_bwd_dq_kernel``)."""
    if q.device.type == "cpu":
        return _plain_bwd_dq(q, k, v, do, m, l, dsum, bias, causal=causal,
                             scale=scale)
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    m, l, dsum = (t.contiguous() for t in (m, l, dsum))
    _check(q, k, v, bias, do, m, l, dsum)
    _check_bwd(q, do, m, l, dsum)
    from . import _build
    B, Tq, H, D = q.shape
    dq = torch.empty_like(q)
    rc = _build.library().hvd_fa_bwd_dq(
        _DTYPE_CODE[q.dtype], D, _ptr(q), _ptr(k), _ptr(v), _ptr(do),
        _ptr(m), _ptr(l), _ptr(dsum), _ptr(bias), _ptr(dq), B, H, Tq,
        k.shape[1], float(scale), int(causal), _stream())
    _raise_on(rc, "fa_bwd_dq")
    fa_bwd_dq.launches += 1
    return dq


fa_bwd_dq.launches = 0


def fa_bwd_dkv(q, k, v, do, m, l, dsum, bias=None, *, causal: bool,
               scale: float):
    """B3, the dK/dV kernel: ``(dK, dV)`` from the saved statistics.

    Replaces ``horovod_tpu/ops/flash_attention.py::_fa_bwd_dkv_kernel``.
    Bound on the H100 by its four products (139 us of dense bf16 tensor-core
    time at the Llama-3-8B shape); each thread block owns a k-tile and loops
    over the q-tiles, so dK and dV need no atomics. In bf16 it runs on the
    tensor cores (``fa_bwd_dkv_kernel_sm90``): K and V stay in shared memory
    while TMA streams Q, dO and their statistics; wgmma forms S^T, dP^T,
    P^T dO and dS^T Q, with P^T and dS^T as bf16 hi + lo pairs from
    registers. f32 keeps the CUDA-core kernel (``fa_bwd_dkv_kernel``)."""
    if q.device.type == "cpu":
        return _plain_bwd_dkv(q, k, v, do, m, l, dsum, bias, causal=causal,
                              scale=scale)
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    m, l, dsum = (t.contiguous() for t in (m, l, dsum))
    _check(q, k, v, bias, do, m, l, dsum)
    _check_bwd(q, do, m, l, dsum)
    from . import _build
    B, Tq, H, D = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = _build.library().hvd_fa_bwd_dkv(
        _DTYPE_CODE[q.dtype], D, _ptr(q), _ptr(k), _ptr(v), _ptr(do),
        _ptr(m), _ptr(l), _ptr(dsum), _ptr(bias), _ptr(dk), _ptr(dv), B, H,
        Tq, k.shape[1], float(scale), int(causal), _stream())
    _raise_on(rc, "fa_bwd_dkv")
    fa_bwd_dkv.launches += 1
    return dk, dv


fa_bwd_dkv.launches = 0

#: The three kernel wrappers by name, for launch accounting.
KERNELS = {"fa_fwd": fa_fwd, "fa_bwd_dq": fa_bwd_dq,
           "fa_bwd_dkv": fa_bwd_dkv}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    fa_fwd.calls = 0


# ------------------------------------------------------------ autograd

def _row_dsum(do, o):
    """``rowsum(dO * O)`` in f32 as ``[B, H, Tq]`` — the FA2 correction term.
    It stays a torch op here rather than being folded into the dQ kernel."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):
    """Output-only core (``_fa_core_nores``): B1 forward, B2 and B3 backward.
    ``bias`` gets no cotangent: it only ever derives from a constant kv
    padding mask on this path."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale):
        o, m, l = fa_fwd(q, k, v, bias, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, bias, o, m, l)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, m, l = ctx.saved_tensors
        do = do.contiguous()
        dsum = _row_dsum(do, o)
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        dq = fa_bwd_dq(q, k, v, do, m, l, dsum, bias, **kw)
        dk, dv = fa_bwd_dkv(q, k, v, do, m, l, dsum, bias, **kw)
        return dq, dk, dv, None, None, None


class _FlashAttentionResiduals(torch.autograd.Function):
    """Residual-returning core (``_fa_core``): B1 forward; the backward is
    autograd over the plain recompute, because ``m`` and ``l`` carry real
    cotangents when partials are merged (ring attention), which the backward
    kernels do not model."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale):
        o, m, l = fa_fwd(q, k, v, bias, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, bias)
        ctx.causal, ctx.scale = causal, scale
        return o, m, l

    @staticmethod
    def backward(ctx, do, dm, dl):
        q, k, v, bias = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            outs = _reference_partial(*inputs, bias, causal=ctx.causal,
                                      scale=ctx.scale)
            grads = torch.autograd.grad(outs, inputs, (do, dm, dl))
        return (*grads, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, kv_mask=None,
                    scale: Optional[float] = None, block_q: int = 512,
                    block_k: int = 512, return_residuals: bool = False):
    """Blockwise (flash) attention on ``[B, T, H, D]`` tensors.

    ``kv_mask`` is an optional ``[B, Tk]`` bool tensor marking real
    (attendable) keys; masked keys never win the softmax.

    Returns the attention output, plus ``(m, l)`` softmax residuals of shape
    ``[B, H, Tq]`` when ``return_residuals`` — feed those to
    :func:`merge_partials` to combine attention over disjoint key shards.

    ``block_q`` and ``block_k`` keep the JAX signature. They sized the TPU's
    VMEM tiles; the CUDA kernels' tiles are fixed at compile time to fit
    shared memory, so the values are checked and otherwise unused.

    Runs the CUDA kernels for CUDA tensors and their plain versions for CPU
    tensors."""
    if block_q <= 0 or block_k <= 0:
        raise ValueError("block sizes must be positive")
    D = q.shape[-1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    bias = None
    if kv_mask is not None:
        bias = torch.where(kv_mask.to(q.device), 0.0, NEG_INF).to(
            torch.float32).contiguous()
    if return_residuals:
        o, m, l = _FlashAttentionResiduals.apply(q, k, v, bias, causal,
                                                 float(scale))
        return o, (m, l)
    return _FlashAttention.apply(q, k, v, bias, causal, float(scale))


def merge_partials(p1: Tuple, p2: Tuple) -> Tuple:
    """Exactly combine two attention partials over disjoint key sets.

    Each partial is ``(o [B,T,H,D], m [B,H,T], l [B,H,T])`` with ``o``
    normalised by its own ``l`` (a partial that saw zero keys has l == 0 and
    contributes nothing). Returns the combined partial in the same form —
    associative and commutative, so ring steps can fold in any order."""
    o1, m1, l1 = p1
    o2, m2, l2 = p2
    m = torch.maximum(m1, m2)
    a1 = torch.exp(torch.clamp_min(m1 - m, NEG_INF)) * l1
    a2 = torch.exp(torch.clamp_min(m2 - m, NEG_INF)) * l2
    l = a1 + a2
    den = torch.where(l == 0.0, 1.0, l)
    w1 = (a1 / den).transpose(1, 2)[..., None]
    w2 = (a2 / den).transpose(1, 2)[..., None]
    o = o1.float() * w1 + o2.float() * w2
    return o.to(o1.dtype), m, l
