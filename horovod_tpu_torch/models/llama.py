"""Llama-family decoder transformer (the flagship model).

Counterpart of ``horovod_tpu/models/llama.py``: bf16 compute with f32
parameters, GQA attention with RoPE and a causal mask, a SwiGLU MLP, RMSNorm,
and an untied LM head. Data parallelism lives outside the model
(``DistributedOptimizer``), so there are no sharding annotations here.

Layers are ``nn.Module`` s kept in a ``ModuleList`` (``blocks.{i}``); both
flax checkpoint layouts (unrolled ``block_i`` and scanned ``layers/block``)
load through :mod:`horovod_tpu_torch.convert`. Dense weights use
``nn.Linear``'s ``[out, in]`` layout.

Places where a port of the JAX model goes wrong, kept as it computes:

- GQA: ``jnp.repeat(k, rep, axis=2)`` repeats each KV head ``rep`` times in a
  row — ``torch.repeat_interleave``, not ``Tensor.repeat`` (which tiles).
- RoPE rotates the two HALVES of the head dim, ``[x1 cos - x2 sin, x2 cos +
  x1 sin]``, not interleaved pairs, with f32 angles ``pos * theta^(-i/half)``.
- RMSNorm computes in f32 and multiplies by the f32 scale before the cast.
- A flax ``nn.Dense(dtype=bf16)`` casts both input and kernel to bf16 and
  returns bf16.
- The embedding table is f32; rows are gathered, then cast.
- The LM head multiplies bf16 operands into f32 logits with no bf16
  rounding of the product (``preferred_element_type=f32``): a bf16
  ``F.linear`` cast to f32 would round each logit to 2^-9.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core import context_api as _ctx
from ._flash import resolve_flash


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # None = auto: the flash kernels on CUDA for long sequences, the
    # materialised softmax elsewhere (models/_flash.py).
    use_flash: Optional[bool] = None


def llama3_8b() -> LlamaConfig:
    return LlamaConfig()


def llama_tiny(vocab: int = 256) -> LlamaConfig:
    """CPU test configuration (the JAX package's, in f32)."""
    return LlamaConfig(vocab_size=vocab, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, hidden_dim=128, max_seq_len=128,
                       dtype=torch.float32)


def _default_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if _ctx.is_initialized():
        return _ctx.device()
    return torch.device("cuda")


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, rescaled so the variance is ``1 / fan_in``, the product of
    the weight's dims after the first (a Linear's ``in``, a conv's ``in *
    kh * kw``)."""
    std = (1.0 / w[0].numel()) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


class Dense(nn.Linear):
    """Bias-free ``nn.Dense(dtype=...)``: input and weight cast to the
    compute dtype, output in it."""

    def __init__(self, fan_in: int, fan_out: int, dtype: torch.dtype,
                 device):
        super().__init__(fan_in, fan_out, bias=False, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.compute_dtype),
                        self.weight.to(self.compute_dtype))


class _HeadProduct(torch.autograd.Function):
    """``x [N, D] @ w[V, D]^T`` with bf16 (compute-dtype) operands and f32
    accumulation into f32 logits, with no rounding of the product: the JAX
    head's ``einsum(..., preferred_element_type=f32)``. ``w`` is the f32
    parameter; the cast to the compute dtype happens inside.

    Backward follows JAX's VJP of that einsum: each product accumulates in
    f32 (``out_dtype``, so cuBLAS cannot round partial sums to bf16) and is
    rounded once, dx to the compute dtype and dW to the compute dtype and
    back to f32. JAX multiplies the f32 cotangent by the bf16 operand; on
    the card the cotangent is rounded to bf16 first, so both backward
    products stay on bf16 tensor cores (ROADMAP, section C). On the CPU the
    products are f32 products of the same operands, the same function up to
    summation order."""

    @staticmethod
    def forward(ctx, x, w, dtype):
        wc = w.to(dtype)
        ctx.save_for_backward(x, wc)
        if x.is_cuda:
            return torch.mm(x, wc.t(), out_dtype=torch.float32)
        return x.float() @ wc.float().t()

    @staticmethod
    def backward(ctx, g):
        x, wc = ctx.saved_tensors
        if g.is_cuda:
            g = g.to(wc.dtype)
            dx = torch.mm(g, wc, out_dtype=torch.float32)
            dw = torch.mm(g.t(), x, out_dtype=torch.float32)
        else:
            dx = g @ wc.float()
            dw = g.t() @ x.float()
        return dx.to(x.dtype), dw.to(wc.dtype).float(), None


class LMHead(Dense):
    """The untied LM head: f32 logits from the compute-dtype product
    accumulated in f32 (:class:`_HeadProduct`); in an f32 configuration a
    plain f32 product."""

    def forward(self, x):
        if self.compute_dtype == torch.float32:
            return super().forward(x).float()
        lead = x.shape[:-1]
        x2d = x.to(self.compute_dtype).reshape(-1, x.shape[-1])
        return _HeadProduct.apply(x2d, self.weight, self.compute_dtype) \
            .view(*lead, -1)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        x32 = x.float()
        norm = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True)
                                 + self.eps)
        return (norm * self.scale).to(self.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding on ``[..., T, H, D]``: rotates the two halves."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., :, None].float() * freqs  # [.., T, half]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, c: LlamaConfig, device):
        super().__init__()
        self.c = c
        hd = c.dim // c.n_heads
        self.wq = Dense(c.dim, c.n_heads * hd, c.dtype, device)
        self.wk = Dense(c.dim, c.n_kv_heads * hd, c.dtype, device)
        self.wv = Dense(c.dim, c.n_kv_heads * hd, c.dtype, device)
        self.wo = Dense(c.n_heads * hd, c.dim, c.dtype, device)

    def forward(self, x, positions):
        c = self.c
        hd = c.dim // c.n_heads
        B, T = x.shape[0], x.shape[1]
        q = self.wq(x).view(B, T, c.n_heads, hd)
        k = self.wk(x).view(B, T, c.n_kv_heads, hd)
        v = self.wv(x).view(B, T, c.n_kv_heads, hd)
        q = rope(q, positions, c.rope_theta)
        k = rope(k, positions, c.rope_theta)
        rep = c.n_heads // c.n_kv_heads
        # jnp.repeat semantics: each KV head repeated rep times in a row.
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
        scale = 1.0 / hd ** 0.5
        if resolve_flash(c.use_flash, T, x.device):
            from ..ops.flash_attention import flash_attention
            o = flash_attention(q, k, v, causal=True, scale=scale)
        else:
            s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
            mask = torch.ones((T, T), dtype=torch.bool,
                              device=x.device).tril()
            s = torch.where(mask, s, -1e30)
            p = torch.softmax(s, dim=-1).to(c.dtype)
            o = torch.einsum("bhqk,bkhd->bqhd", p, v)
        return self.wo(o.reshape(B, T, c.n_heads * hd))


class MLP(nn.Module):
    def __init__(self, c: LlamaConfig, device):
        super().__init__()
        self.w1 = Dense(c.dim, c.hidden_dim, c.dtype, device)
        self.w3 = Dense(c.dim, c.hidden_dim, c.dtype, device)
        self.w2 = Dense(c.hidden_dim, c.dim, c.dtype, device)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class Block(nn.Module):
    def __init__(self, c: LlamaConfig, device):
        super().__init__()
        self.attn_norm = RMSNorm(c.dim, c.norm_eps, c.dtype, device)
        self.attn = Attention(c, device)
        self.mlp_norm = RMSNorm(c.dim, c.norm_eps, c.dtype, device)
        self.mlp = MLP(c, device)

    def forward(self, x, positions):
        x = x + self.attn(self.attn_norm(x), positions)
        return x + self.mlp(self.mlp_norm(x))


class Llama(nn.Module):
    """The decoder: embedding → blocks → final norm → LM head. Parameters
    are made on ``device`` (the context's device, else ``"cuda"``) from a
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, cfg: LlamaConfig, *, device=None, seed: int = 0):
        super().__init__()
        device = _default_device(device)
        c = self.cfg = cfg
        self.embedding = nn.Parameter(
            torch.empty(c.vocab_size, c.dim, device=device))
        self.blocks = nn.ModuleList(Block(c, device)
                                    for _ in range(c.n_layers))
        self.final_norm = RMSNorm(c.dim, c.norm_eps, c.dtype, device)
        self.lm_head = LMHead(c.dim, c.vocab_size, c.dtype, device)
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            self.embedding.normal_(0.0, 0.02, generator=gen)
            for mod in self.modules():
                if isinstance(mod, Dense):
                    _lecun_normal_(mod.weight, gen)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """``tokens`` ``[B, T]`` → f32 logits ``[B, T, V]``."""
        c = self.cfg
        x = self.embedding[tokens].to(c.dtype)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        for block in self.blocks:
            x = block(x, positions)
        return self.lm_head(self.final_norm(x))
