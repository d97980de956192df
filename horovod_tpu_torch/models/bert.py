"""BERT-style bidirectional encoder with the MLM pretraining head.

Counterpart of ``horovod_tpu/models/bert.py`` (the JAX package's BASELINE
config 2, BERT-Large pretraining): f32 parameters with compute in ``dtype``
(bf16 by default), post-LayerNorm encoder blocks, and an MLM head tied to
the token embedding. Attention runs the flash kernels (B1-B3: not causal,
with the key-padding bias of ``attn_mask``) where
:func:`~horovod_tpu_torch.models._flash.resolve_flash` says so, and the
materialised softmax, masked with -1e30, elsewhere.

Places where a port of the JAX model goes wrong, kept as it computes:

- flax's ``nn.gelu`` is the tanh approximation: ``F.gelu(approximate=
  "tanh")``, not torch's exact default.
- LayerNorm: eps 1e-12, statistics in f32 with the fast variance
  ``max(0, E[x^2] - E[x]^2)``, output in the compute dtype.
- A flax ``nn.Dense(dtype=bf16)`` casts input, kernel and bias to bf16.
- The MLM head multiplies f32 by f32 against the f32 embedding, on purpose
  (the JAX model's note): it stays f32, and runs in full f32 as long as
  ``torch.backends.cuda.matmul.allow_tf32`` keeps its default, False.
- The JAX config's ``type_vocab`` is declared but its model never uses it,
  so there is neither a token-type embedding nor the field here.
- ``remat`` and ``remat_policy`` run each encoder block under
  ``torch.utils.checkpoint`` with the Llama's policies
  (``models/llama.py::_REMAT_POLICIES``), on by default as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# The JAX module exports its loss beside the model.
from ..train.losses import mlm_loss  # noqa: F401
from ._flash import resolve_flash
from .llama import _default_device, _lecun_normal_, _remat


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    hidden_dim: int = 4096
    max_seq_len: int = 512
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "dots"  # see models/llama.py LlamaConfig
    # None = auto: the flash kernels on CUDA for long sequences, the
    # materialised softmax elsewhere (models/_flash.py).
    use_flash: Optional[bool] = None


def bert_large() -> BertConfig:
    return BertConfig()


def bert_base() -> BertConfig:
    return BertConfig(dim=768, n_layers=12, n_heads=12, hidden_dim=3072)


def bert_tiny(vocab: int = 256) -> BertConfig:
    """CPU test configuration (the JAX package's, in f32)."""
    return BertConfig(vocab_size=vocab, dim=64, n_layers=2, n_heads=4,
                      hidden_dim=128, max_seq_len=128, dtype=torch.float32,
                      remat=False)


class Dense(nn.Linear):
    """``nn.Dense(dtype=...)`` with a bias: input, weight and bias cast to
    the compute dtype, output in it."""

    def __init__(self, fan_in: int, fan_out: int, dtype: torch.dtype,
                 device):
        super().__init__(fan_in, fan_out, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm(dtype=...)`` over the last dim."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp_min(x32.square().mean(-1, keepdim=True)
                              - mean.square(), 0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        return (y + self.bias).to(self.dtype)


def attention(q, k, v, attn_mask, *, use_flash, dtype):
    """Bidirectional attention over ``[B, T, H, D]`` with the key-padding
    mask ``attn_mask [B, T]`` (True marks a real token): the flash kernels
    when ``resolve_flash`` says so, else the materialised softmax of the
    JAX model (``models/bert.py:80-84``)."""
    T, hd = q.shape[1], q.shape[-1]
    if resolve_flash(use_flash, T, q.device):
        from ..ops.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=False, kv_mask=attn_mask,
                               scale=float(1.0 / hd ** 0.5))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
    s = torch.where(attn_mask[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class EncoderBlock(nn.Module):
    def __init__(self, c: BertConfig, device):
        super().__init__()
        self.c = c
        dense = lambda i, o: Dense(i, o, c.dtype, device)
        self.wq, self.wk = dense(c.dim, c.dim), dense(c.dim, c.dim)
        self.wv, self.wo = dense(c.dim, c.dim), dense(c.dim, c.dim)
        self.attn_norm = LayerNorm(c.dim, c.norm_eps, c.dtype, device)
        self.ffn_in = dense(c.dim, c.hidden_dim)
        self.ffn_out = dense(c.hidden_dim, c.dim)
        self.ffn_norm = LayerNorm(c.dim, c.norm_eps, c.dtype, device)

    def forward(self, x, attn_mask):
        c = self.c
        B, T, _ = x.shape
        heads = lambda t: t.view(B, T, c.n_heads, c.dim // c.n_heads)
        o = attention(heads(self.wq(x)), heads(self.wk(x)),
                      heads(self.wv(x)), attn_mask, use_flash=c.use_flash,
                      dtype=c.dtype)
        x = self.attn_norm(x + self.wo(o.reshape(B, T, c.dim)))
        f = self.ffn_out(F.gelu(self.ffn_in(x), approximate="tanh"))
        return self.ffn_norm(x + f)


class Bert(nn.Module):
    """``tokens [B, T]`` and ``attn_mask [B, T]`` (True marks a real token;
    None: all real) -> f32 MLM logits ``[B, T, vocab]``. Parameters are made
    on ``device`` (the context's device, else "cuda") from a
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, cfg: BertConfig, *, device=None, seed: int = 0):
        super().__init__()
        device = _default_device(device)
        c = self.cfg = cfg
        self.tok_embedding = nn.Parameter(
            torch.empty(c.vocab_size, c.dim, device=device))
        self.pos_embedding = nn.Parameter(
            torch.empty(c.max_seq_len, c.dim, device=device))
        self.embed_norm = LayerNorm(c.dim, c.norm_eps, c.dtype, device)
        self.layers = nn.ModuleList(EncoderBlock(c, device)
                                    for _ in range(c.n_layers))
        self.mlm_transform = Dense(c.dim, c.dim, c.dtype, device)
        self.mlm_norm = LayerNorm(c.dim, c.norm_eps, c.dtype, device)
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            self.tok_embedding.normal_(0.0, 0.02, generator=gen)
            self.pos_embedding.normal_(0.0, 0.02, generator=gen)
            for mod in self.modules():
                if isinstance(mod, Dense):
                    _lecun_normal_(mod.weight, gen)
                    mod.bias.zero_()

    def forward(self, tokens: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        if attn_mask is None:
            attn_mask = torch.ones_like(tokens, dtype=torch.bool)
        T = tokens.shape[1]
        x = self.tok_embedding[tokens] + self.pos_embedding[None, :T]
        x = self.embed_norm(x.to(c.dtype))
        for layer in self.layers:
            if c.remat and torch.is_grad_enabled():
                x = _remat(layer, c.remat_policy)(x, attn_mask)
            else:
                x = layer(x, attn_mask)
        x = F.gelu(self.mlm_transform(x), approximate="tanh")
        x = self.mlm_norm(x)
        return torch.einsum("btd,vd->btv", x.float(), self.tok_embedding)
