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
    deviations, rescaled so the variance is ``1 / fan_in``."""
    std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
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
        self.lm_head = Dense(c.dim, c.vocab_size, c.dtype, device)
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
        x = self.final_norm(x)
        # The JAX head multiplies bf16 inputs with f32 accumulation into f32
        # logits. torch's f32-output bf16 product (mm's out_dtype) has no
        # autograd formula, so the head's bf16 product is cast to f32: the
        # logits carry one bf16 rounding (relative 2^-9) that the JAX logits
        # do not. In f32 configurations both are exact f32 products.
        return self.lm_head(x).float()
