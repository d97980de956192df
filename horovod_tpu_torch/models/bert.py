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

Model parallelism: a model built under a mesh with ``fsdp`` or ``tp`` > 1
holds this rank's block of each parameter, named as JAX names them
(:class:`Bert`); it trains with ``train.make_gspmd_train_step`` and the
masked-LM ``loss_fn`` (``train.losses.mlm_loss_sums``). A vocabulary that
tp does not divide raises, where XLA pads (BERT-Large's 30522 splits over
tp 2, not over tp 4; ROADMAP.md, section C).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import axis_size, get_mesh
from ..parallel.sharding import (bias_placement, copy_to_tp, gather_param,
                                 kernel_placement, placement, reduce_from_tp,
                                 set_placement, vocab_parallel_embedding)
# The JAX module exports its loss beside the model.
from ..train.losses import mlm_loss  # noqa: F401
from ._flash import resolve_flash
from .llama import (_default_device, _init_block, _lecun_normal_, _remat,
                    _tp_axis)


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


#: Each dense layer's kernel names, in flax's ``[in, out]`` order
#: (``horovod_tpu/models/bert.py:63-68, :82-93, :130-132``), and the
#: tables' (``:111-118``). Biases and LayerNorms have none in JAX.
DENSE_NAMES = {"wq": ("embed", "heads"), "wk": ("embed", "heads"),
               "wv": ("embed", "heads"), "wo": ("heads", "embed"),
               "ffn_in": ("embed", "mlp"), "ffn_out": ("mlp", "embed"),
               "mlm_transform": ("embed", "embed_fsdp")}
TABLE_NAMES = {"tok_embedding": ("vocab", "embed_table"),
               "pos_embedding": ("seq", "embed_table")}


class Dense(nn.Module):
    """``nn.Dense(dtype=...)`` with a bias: input, weight and bias cast to
    the compute dtype, output in it. The weight is ``[out, in]``; with the
    flax kernel's logical ``names`` on a ``mesh`` it is this rank's block
    (``sharding.kernel_placement``), gathered over fsdp in the compute
    dtype where it is used. A column-parallel layer (``out`` over tp)
    holds its bias's tp slice; a row-parallel one (``in`` over tp) sums
    its partial products over tp and then adds its whole bias, once
    (``sharding.bias_placement``)."""

    def __init__(self, fan_in: int, fan_out: int, dtype: torch.dtype,
                 device, names=None, mesh=None):
        super().__init__()
        place = kernel_placement(mesh, names or (None, None), fan_in,
                                 fan_out)
        self.weight = nn.Parameter(torch.empty(place.local_shape(),
                                               device=device))
        set_placement(self.weight, place)
        bias = bias_placement(place)
        self.bias = nn.Parameter(torch.empty(bias.local_shape(),
                                             device=device))
        set_placement(self.bias, bias)
        a = place.axes[1]
        self.row_tp = a if a is not None and a.name == "tp" else None
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        w = gather_param(self.weight, dt)
        if self.row_tp is None:
            return F.linear(x.to(dt), w, self.bias.to(dt))
        return reduce_from_tp(F.linear(x.to(dt), w),
                              self.row_tp) + self.bias.to(dt)


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
    """A post-LayerNorm encoder block. Under tp its attention runs the
    ``n_heads / tp`` local heads (``wq``/``wk``/``wv`` column-parallel,
    ``wo`` row-parallel) and its FFN ``hidden / tp`` columns, the input of
    each half through ``copy_to_tp``; the LayerNorms are whole."""

    def __init__(self, c: BertConfig, device, mesh=None):
        super().__init__()
        self.c = c
        self.tp = _tp_axis(mesh)
        tp = self.tp.size if self.tp is not None else 1
        if c.n_heads % tp:
            raise ValueError(f"tp {tp} does not divide n_heads {c.n_heads}")
        self.heads = c.n_heads // tp
        dense = lambda i, o, name: Dense(i, o, c.dtype, device,
                                         DENSE_NAMES[name], mesh)
        self.wq, self.wk = dense(c.dim, c.dim, "wq"), dense(c.dim, c.dim, "wk")
        self.wv, self.wo = dense(c.dim, c.dim, "wv"), dense(c.dim, c.dim, "wo")
        self.attn_norm = LayerNorm(c.dim, c.norm_eps, c.dtype, device)
        self.ffn_in = dense(c.dim, c.hidden_dim, "ffn_in")
        self.ffn_out = dense(c.hidden_dim, c.dim, "ffn_out")
        self.ffn_norm = LayerNorm(c.dim, c.norm_eps, c.dtype, device)

    def forward(self, x, attn_mask):
        c = self.c
        B, T, _ = x.shape
        hd = c.dim // c.n_heads
        heads = lambda t: t.view(B, T, self.heads, hd)
        h = copy_to_tp(x, self.tp)
        o = attention(heads(self.wq(h)), heads(self.wk(h)),
                      heads(self.wv(h)), attn_mask, use_flash=c.use_flash,
                      dtype=c.dtype)
        x = self.attn_norm(x + self.wo(o.reshape(B, T, self.heads * hd)))
        f = self.ffn_out(F.gelu(self.ffn_in(copy_to_tp(x, self.tp)),
                                approximate="tanh"))
        return self.ffn_norm(x + f)


class Bert(nn.Module):
    """``tokens [B, T]`` and ``attn_mask [B, T]`` (True marks a real token;
    None: all real) -> f32 MLM logits ``[B, T, vocab]``. Parameters are made
    on ``device`` (the context's device, else "cuda") from a
    ``torch.Generator`` seeded with ``seed``.

    ``mesh`` (default: the ambient mesh) places the parameters by JAX's
    names (:data:`DENSE_NAMES`, :data:`TABLE_NAMES`): under tp the token
    table is vocab-parallel (``sharding.vocab_parallel_embedding``) and the
    tied f32 head gives logits split over the vocabulary, ``[B, T,
    vocab / tp]``; under fsdp each dense weight's ``embed`` dim is split
    (``mlm_transform``'s ``in`` dim alone: flax's first-use rule), and the
    tables, biases of whole outputs and LayerNorms are whole. The values
    are the whole model's: each whole tensor drawn in module order, its
    block kept (on the ``"meta"`` device, none: a model of shapes and
    placements alone, which ``convert.bert_params_from_flax`` reads). On
    an ``sp`` axis the model raises: JAX would gather K and
    V over sp for its dense attention, which the port does not
    (ROADMAP.md, section C)."""

    def __init__(self, cfg: BertConfig, *, device=None, seed: int = 0,
                 mesh=None):
        super().__init__()
        device = _default_device(device)
        c = self.cfg = cfg
        mesh = get_mesh() if mesh is None else mesh
        if axis_size(mesh, "sp") > 1:
            raise ValueError(
                "BERT on an sp axis: JAX's dense attention would gather K "
                "and V over sp, which the port does not (ROADMAP.md, "
                "section C); use the dp, fsdp and tp axes")
        self.mesh, self.tp = mesh, _tp_axis(mesh)
        tables = {}
        for name, shape in (("tok_embedding", (c.vocab_size, c.dim)),
                            ("pos_embedding", (c.max_seq_len, c.dim))):
            place = placement(mesh, TABLE_NAMES[name], shape)
            tables[name] = nn.Parameter(torch.empty(place.local_shape(),
                                                    device=device))
            set_placement(tables[name], place)
        self.tok_embedding = tables["tok_embedding"]
        self.pos_embedding = tables["pos_embedding"]
        self.embed_norm = LayerNorm(c.dim, c.norm_eps, c.dtype, device)
        self.layers = nn.ModuleList(EncoderBlock(c, device, mesh)
                                    for _ in range(c.n_layers))
        self.mlm_transform = Dense(c.dim, c.dim, c.dtype, device,
                                   DENSE_NAMES["mlm_transform"], mesh)
        self.mlm_norm = LayerNorm(c.dim, c.norm_eps, c.dtype, device)
        if device.type == "meta":  # shapes and placements alone
            return
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            normal = lambda w: w.normal_(0.0, 0.02, generator=gen)
            _init_block(self.tok_embedding, normal)
            _init_block(self.pos_embedding, normal)
            for mod in self.modules():
                if isinstance(mod, Dense):
                    _init_block(mod.weight,
                                lambda w: _lecun_normal_(w, gen))
                    mod.bias.zero_()

    def forward(self, tokens: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        if attn_mask is None:
            attn_mask = torch.ones_like(tokens, dtype=torch.bool)
        T = tokens.shape[1]
        x = (vocab_parallel_embedding(self.tok_embedding, tokens, self.tp)
             + self.pos_embedding[None, :T])
        x = self.embed_norm(x.to(c.dtype))
        for layer in self.layers:
            if c.remat and torch.is_grad_enabled():
                x = _remat(layer, c.remat_policy)(x, attn_mask)
            else:
                x = layer(x, attn_mask)
        x = F.gelu(self.mlm_transform(x), approximate="tanh")
        x = copy_to_tp(self.mlm_norm(x), self.tp)
        return torch.einsum("btd,vd->btv", x.float(), self.tok_embedding)
