"""Llama-family decoder transformer (the flagship model).

Counterpart of ``horovod_tpu/models/llama.py``: bf16 compute with f32
parameters, GQA attention with RoPE and a causal mask, a SwiGLU MLP, RMSNorm,
and an LM head, untied or tied to the embedding. Data parallelism lives
outside the model (``DistributedOptimizer``). Context parallelism
(``attention_impl`` "ring" or "ulysses") engages when the ambient mesh
(``parallel.set_mesh``) has an ``sp`` axis of size > 1: each rank then
holds one shard of the sequence.

Model parallelism: each parameter carries its logical names
(:data:`PARAM_NAMES`, JAX's ``_part`` names in the port's layout), and a
model built under a mesh with ``fsdp`` or ``tp`` > 1 holds only this
rank's block of each (``parallel/sharding.py``). Under tp the attention
runs ``n_heads / tp`` query and ``n_kv_heads / tp`` KV heads, split
contiguously, and the logits stay vocab-sharded ``[B, T, V / tp]``; under
fsdp each weight is gathered where it is used.

Remat (``remat``, ``remat_policy``) runs each block under
``torch.utils.checkpoint`` with a selective-checkpoint policy per JAX
policy (:data:`_REMAT_POLICIES`).

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
import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core import context_api as _ctx
from ..ops.flash_attention import flash_attention
from ..parallel import moe as _moe  # noqa: F401  (hvd::expert_alltoall)
from ..parallel.mesh import Mesh, axis_size, get_mesh
from ..parallel.sharding import LOGICAL_RULES  # noqa: F401  (JAX's home)
from ..parallel.sharding import (copy_to_tp, gather_param, placement,
                                 placement_of, reduce_from_tp, set_placement,
                                 vocab_parallel_embedding)
from ._flash import resolve_flash

#: Each parameter's logical names by its attribute name, in the port's
#: layout: a dense weight is ``[out, in]``, so JAX's ``("embed", "heads")``
#: kernel of ``wq`` is ``("heads", "embed")`` here.
PARAM_NAMES = {
    "embedding": ("vocab", "embed_table"),
    "lm_head": ("vocab", "embed"),
    "scale": ("embed",),
    "wq": ("heads", "embed"),
    "wk": ("kv_heads", "embed"),
    "wv": ("kv_heads", "embed"),
    "wo": ("embed", "heads"),
    "w1": ("mlp", "embed"),
    "w3": ("mlp", "embed"),
    "w2": ("embed", "mlp"),
}


def logical_names(key: str):
    """The logical names of the parameter at state-dict ``key``."""
    parts = key.split(".")
    return PARAM_NAMES[parts[-2] if parts[-1] == "weight" else parts[-1]]


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
    remat: bool = True
    # "dots": save matmul outputs, recompute elementwise. "full": save
    # nothing inside the block. "dots_attn" and "attn" also save B1's
    # outputs (_REMAT_POLICIES).
    remat_policy: str = "dots"
    # torch has no scan over layers: the blocks always run as a Python
    # loop. The field keeps JAX's meaning for the checkpoint layout only:
    # convert.py reads and writes the scanned flax layout (params stacked
    # [L, ...] under "layers") when resolve_scan_layers says so, else the
    # unrolled one (block_0 .. block_{L-1}).
    scan_layers: Any = "auto"
    tie_embeddings: bool = False
    # None = auto: the flash kernels on CUDA for long sequences, the
    # materialised softmax elsewhere (models/_flash.py).
    use_flash: Optional[bool] = None
    # Context parallelism for the attention itself. None: dense attention
    # (on an sp mesh the port raises, where XLA would gather K/V; ROADMAP.md
    # section C). "ring": K/V rotate round the sp axis (parallel/ring.py).
    # "ulysses": head-scatter all-to-all (parallel/ulysses.py; needs
    # n_heads % sp == 0). Both engage only when the ambient mesh has an
    # "sp" axis of size > 1.
    attention_impl: Optional[str] = None


#: ``scan_layers="auto"`` means the scanned layout above this layer count,
#: as in the JAX package.
SCAN_LAYERS_AUTO_THRESHOLD = 8


def resolve_scan_layers(c: "LlamaConfig") -> bool:
    """The effective scan-vs-unroll choice for ``c`` (handles "auto")."""
    if c.scan_layers == "auto":
        return c.n_layers > SCAN_LAYERS_AUTO_THRESHOLD
    return bool(c.scan_layers)


def llama3_8b() -> LlamaConfig:
    return LlamaConfig()


def llama_tiny(vocab: int = 256) -> LlamaConfig:
    """CPU test configuration (the JAX package's, in f32)."""
    return LlamaConfig(vocab_size=vocab, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, hidden_dim=128, max_seq_len=128,
                       dtype=torch.float32, remat=False, scan_layers=False)


@torch.library.custom_op("hvd::attn_context", mutates_args=())
def attn_context(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The materialised attention's context ``einsum("bhqk,bkhd->bqhd")``
    as an op of its own, so a remat policy can save it by name, as JAX tags
    it ``attn_out`` (``models/llama.py:279-286``)."""
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _attn_context_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _attn_context_backward(ctx, g):
    p, v = ctx.saved_tensors
    return (torch.einsum("bqhd,bkhd->bhqk", g, v),
            torch.einsum("bhqk,bqhd->bkhd", p, g))


attn_context.register_autograd(_attn_context_backward,
                               setup_context=_attn_context_setup)


_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]
#: The names JAX's policies save: B1's three outputs (``attn_out``,
#: ``attn_lse_m``, ``attn_lse_l``, ops/flash_attention.py::_fa_fwd_impl)
#: and the materialised branch's context output (``attn_out``).
_ATTN = [torch.ops.hvd.fa_fwd.default, torch.ops.hvd.attn_context.default]
#: The MoE's expert exchange over ep (``parallel/moe.py``). JAX's policies
#: do not save an ``all_to_all``, so its recompute exchanges again; the
#: port's saving policies keep the exchange's output, so a step posts one
#: all-to-all each way a layer forward and one each way backward. "full"
#: recomputes it, as JAX does.
_EXCHANGE = [torch.ops.hvd.expert_alltoall.default]

#: The ops each remat policy saves inside a block; the rest is recomputed.
#: "dots" is ``dots_with_no_batch_dims_saveable``: the outputs of products
#: without batch dims (``mm``, ``addmm``: every dense layer), not the
#: attention's or the experts' batched products or anything elementwise.
#: "full" (None) saves nothing inside the block.
_REMAT_POLICIES = {
    "full": None,
    "dots": _DOTS + _EXCHANGE,
    "dots_attn": _DOTS + _ATTN + _EXCHANGE,
    "attn": _ATTN + _EXCHANGE,
}


def _remat(fn, policy_name: str):
    """``fn`` run under ``torch.utils.checkpoint`` (non-reentrant) with the
    selective-checkpoint policy ``policy_name`` (``nn.remat`` with a
    ``jax.checkpoint_policies`` policy)."""
    if policy_name not in _REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy_name!r} not in "
                         f"{sorted(_REMAT_POLICIES)}")
    saved = _REMAT_POLICIES[policy_name]
    kw = {} if saved is None else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, saved)}
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def with_remat_policy(c: "LlamaConfig", policy: str) -> "LlamaConfig":
    """``c`` with its remat arm set by one name. ``"none"`` disables remat
    (every residual kept); any ``_REMAT_POLICIES`` key enables remat under
    that policy."""
    if policy == "none":
        return dataclasses.replace(c, remat=False)
    if policy not in _REMAT_POLICIES:
        raise ValueError(f"remat policy {policy!r} not in "
                         f"{['none'] + sorted(_REMAT_POLICIES)}")
    return dataclasses.replace(c, remat=True, remat_policy=policy)


def _default_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if _ctx.is_initialized():
        return _ctx.device()
    return torch.device("cuda")


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator,
                   fan_in: Optional[int] = None) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, rescaled so the variance is ``1 / fan_in``; by default the
    product of the weight's dims after the first (a Linear's ``in``, a
    conv's ``in * kh * kw``)."""
    fan_in = w[0].numel() if fan_in is None else fan_in
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


def _tp_axis(mesh: Optional[Mesh]):
    return mesh.axis("tp") if mesh is not None \
        and axis_size(mesh, "tp") > 1 else None


class Dense(nn.Module):
    """Bias-free ``nn.Dense(dtype=...)``: input and weight cast to the
    compute dtype, output in it. The weight is ``[out, in]``; with logical
    ``names`` on a ``mesh`` it is this rank's block, gathered over fsdp in
    the compute dtype where it is used."""

    def __init__(self, fan_in: int, fan_out: int, dtype: torch.dtype,
                 device, names=None, mesh: Optional[Mesh] = None):
        super().__init__()
        place = placement(mesh, names or (None, None), (fan_out, fan_in))
        self.weight = nn.Parameter(torch.empty(place.local_shape(),
                                               device=device))
        set_placement(self.weight, place)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.compute_dtype),
                        gather_param(self.weight, self.compute_dtype))


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


def head_logits(x, w, dtype):
    """f32 logits ``x @ w^T`` for the f32 head weight ``w [V, D]`` (the
    untied head's, or with ``tie_embeddings`` the embedding table): the
    compute-dtype product accumulated in f32 (:class:`_HeadProduct`); in
    an f32 configuration a plain f32 product."""
    if dtype == torch.float32:
        return F.linear(x.float(), w)
    lead = x.shape[:-1]
    x2d = x.to(dtype).reshape(-1, x.shape[-1])
    return _HeadProduct.apply(x2d, w, dtype).view(*lead, -1)


class LMHead(Dense):
    """The untied LM head (:func:`head_logits` over its own weight)."""

    def forward(self, x):
        return head_logits(x, gather_param(self.weight, self.compute_dtype),
                           self.compute_dtype)


class RMSNorm(nn.Module):
    """RMSNorm with an f32 scale, split over fsdp on a mesh and gathered
    in f32 where it is used."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device,
                 mesh: Optional[Mesh] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        place = placement(mesh, PARAM_NAMES["scale"], (dim,))
        self.scale = nn.Parameter(torch.ones(place.local_shape(),
                                             device=device))
        set_placement(self.scale, place)

    def forward(self, x):
        x32 = x.float()
        norm = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True)
                                 + self.eps)
        return (norm * gather_param(self.scale, torch.float32)).to(self.dtype)


def _seq_parallel_attention(q, k, v, impl: Optional[str], scale: float):
    """Context-parallel attention over the ambient mesh's ``sp`` axis, or
    None where the caller's dense path applies: no ``attention_impl``, or
    no ``sp`` axis of size > 1. ``impl`` is checked on every mesh, so a
    typo raises on a dev box too, as in JAX."""
    if impl is not None and impl not in ("ring", "ulysses"):
        raise ValueError(f"attention_impl {impl!r}: use None, 'ring' or "
                         "'ulysses'")
    mesh = get_mesh()
    if mesh is None or axis_size(mesh, "sp") == 1:
        return None
    if impl is None:
        # GSPMD would gather K/V over sp here; the port does not (ROADMAP.md
        # section C).
        raise ValueError("an sp mesh needs attention_impl 'ring' or "
                         "'ulysses': dense attention would see only this "
                         "rank's shard of the sequence")
    from ..parallel import ring_attention, ulysses_attention
    sp = mesh.axis("sp")
    if impl == "ring":
        return ring_attention(q, k, v, sp, causal=True, scale=scale)
    return ulysses_attention(q, k, v, sp, causal=True, scale=scale)


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
    """GQA attention. Under tp, ``n_heads / tp`` query heads and
    ``n_kv_heads / tp`` KV heads, split contiguously, so each local query
    head's KV head is local too and ``repeat_interleave`` keeps JAX's
    order; ``wo``'s partial sums are all-reduced over tp."""

    def __init__(self, c: LlamaConfig, device, mesh: Optional[Mesh] = None):
        super().__init__()
        self.c = c
        self.tp = _tp_axis(mesh)
        tp = self.tp.size if self.tp is not None else 1
        if c.n_kv_heads % tp or c.n_heads % tp:
            raise ValueError(f"tp {tp} does not divide n_kv_heads "
                             f"{c.n_kv_heads} and n_heads {c.n_heads}")
        self.heads, self.kv_heads = c.n_heads // tp, c.n_kv_heads // tp
        hd = c.dim // c.n_heads
        dense = lambda i, o, name: Dense(i, o, c.dtype, device,
                                         PARAM_NAMES[name], mesh)
        self.wq = dense(c.dim, c.n_heads * hd, "wq")
        self.wk = dense(c.dim, c.n_kv_heads * hd, "wk")
        self.wv = dense(c.dim, c.n_kv_heads * hd, "wv")
        self.wo = dense(c.n_heads * hd, c.dim, "wo")

    def forward(self, x, positions):
        c = self.c
        hd = c.dim // c.n_heads
        B, T = x.shape[0], x.shape[1]
        x = copy_to_tp(x, self.tp)
        q = self.wq(x).view(B, T, self.heads, hd)
        k = self.wk(x).view(B, T, self.kv_heads, hd)
        v = self.wv(x).view(B, T, self.kv_heads, hd)
        q = rope(q, positions, c.rope_theta)
        k = rope(k, positions, c.rope_theta)
        rep = c.n_heads // c.n_kv_heads
        # jnp.repeat semantics: each KV head repeated rep times in a row.
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
        scale = 1.0 / hd ** 0.5
        o = _seq_parallel_attention(q, k, v, c.attention_impl, scale)
        if o is None and resolve_flash(c.use_flash, T, x.device):
            o = flash_attention(q, k, v, causal=True, scale=scale)
        elif o is None:
            s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
            mask = torch.ones((T, T), dtype=torch.bool,
                              device=x.device).tril()
            s = torch.where(mask, s, -1e30)
            p = torch.softmax(s, dim=-1).to(c.dtype)
            o = attn_context(p, v)
        return reduce_from_tp(self.wo(o.reshape(B, T, self.heads * hd)),
                              self.tp)


class MLP(nn.Module):
    """SwiGLU; under tp ``w1``/``w3`` hold ``hidden / tp`` columns and
    ``w2``'s partial sums are all-reduced over tp."""

    def __init__(self, c: LlamaConfig, device, mesh: Optional[Mesh] = None):
        super().__init__()
        self.tp = _tp_axis(mesh)
        dense = lambda i, o, name: Dense(i, o, c.dtype, device,
                                         PARAM_NAMES[name], mesh)
        self.w1 = dense(c.dim, c.hidden_dim, "w1")
        self.w3 = dense(c.dim, c.hidden_dim, "w3")
        self.w2 = dense(c.hidden_dim, c.dim, "w2")

    def forward(self, x):
        x = copy_to_tp(x, self.tp)
        return reduce_from_tp(self.w2(F.silu(self.w1(x)) * self.w3(x)),
                              self.tp)


class Block(nn.Module):
    def __init__(self, c: LlamaConfig, device, mesh: Optional[Mesh] = None):
        super().__init__()
        self.attn_norm = RMSNorm(c.dim, c.norm_eps, c.dtype, device, mesh)
        self.attn = Attention(c, device, mesh)
        self.mlp_norm = RMSNorm(c.dim, c.norm_eps, c.dtype, device, mesh)
        self.mlp = MLP(c, device, mesh)

    def forward(self, x, positions):
        x = x + self.attn(self.attn_norm(x), positions)
        return x + self.mlp(self.mlp_norm(x))


def decoder_trunk(model: nn.Module, tokens: torch.Tensor):
    """Embedding → blocks → final norm → LM head of ``model`` (a
    :class:`Llama` or a model built like one), the counterpart of JAX's
    ``decoder_trunk``. Returns the f32 logits and the list of what the
    blocks returned beside their output (a Mixtral block's aux loss; empty
    for the Llama's blocks). Each block runs under remat when the config
    asks for it and gradients are on.

    ``tokens`` is ``[B, T]``. Under an ambient mesh with an ``sp`` axis it
    is this rank's shard of the sequence, and its positions start at the
    shard's offset (the GSPMD model sees the global positions)."""
    c = model.cfg
    x = vocab_parallel_embedding(model.embedding, tokens,
                                 model.tp).to(c.dtype)
    T = tokens.shape[1]
    mesh = get_mesh()
    start = mesh.axis("sp").index * T if mesh is not None \
        and "sp" in mesh.shape else 0
    positions = torch.arange(start, start + T, device=tokens.device)[None]
    sown = []
    for block in model.blocks:
        if c.remat and torch.is_grad_enabled():
            out = _remat(block, c.remat_policy)(x, positions)
        else:
            out = block(x, positions)
        if isinstance(out, tuple):
            x, extra = out
            sown.append(extra)
        else:
            x = out
    x = copy_to_tp(model.final_norm(x), model.tp)
    if c.tie_embeddings:
        return head_logits(x, model.embedding, c.dtype), sown
    return model.lm_head(x), sown


def _init_block(p: torch.Tensor, fill) -> None:
    """``fill`` the whole tensor ``p`` is a block of, and keep the block:
    the values a whole model made from the same generator holds there.
    The whole tensor lives only for this call."""
    place = placement_of(p)
    if place is None or place.local_shape() == place.shape:
        fill(p)
        return
    full = torch.empty(place.shape, device=p.device)
    fill(full)
    p.copy_(place.block(full))


class Llama(nn.Module):
    """The decoder: embedding → blocks → final norm → LM head. Parameters
    are made on ``device`` (the context's device, else ``"cuda"``) from a
    ``torch.Generator`` seeded with ``seed``, in module order. ``block``
    makes each layer from the config and the device (a subclass passes its
    own).

    ``mesh`` (default: the ambient mesh) places the parameters: with an
    ``fsdp`` or ``tp`` axis of size > 1 each holds this rank's block. The
    values are the whole model's: each whole tensor is drawn from the one
    generator in module order, its block kept and the rest freed, so a
    shard never holds more than one whole tensor at a time."""

    def __init__(self, cfg: LlamaConfig, *, device=None, seed: int = 0,
                 block=None, mesh: Optional[Mesh] = None):
        super().__init__()
        device = _default_device(device)
        c = self.cfg = cfg
        mesh = get_mesh() if mesh is None else mesh
        self.mesh = mesh
        self.tp = _tp_axis(mesh)
        block = (functools.partial(Block, mesh=mesh) if block is None
                 else block)
        place = placement(mesh, PARAM_NAMES["embedding"],
                          (c.vocab_size, c.dim))
        self.embedding = nn.Parameter(torch.empty(place.local_shape(),
                                                  device=device))
        set_placement(self.embedding, place)
        self.blocks = nn.ModuleList(block(c, device)
                                    for _ in range(c.n_layers))
        self.final_norm = RMSNorm(c.dim, c.norm_eps, c.dtype, device, mesh)
        self.lm_head = (None if c.tie_embeddings else
                        LMHead(c.dim, c.vocab_size, c.dtype, device,
                               PARAM_NAMES["lm_head"], mesh))
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            _init_block(self.embedding,
                        lambda w: w.normal_(0.0, 0.02, generator=gen))
            for mod in self.modules():
                if isinstance(mod, Dense):
                    _init_block(mod.weight,
                                lambda w: _lecun_normal_(w, gen))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """``tokens`` ``[B, T]`` → f32 logits ``[B, T, V]``
        (:func:`decoder_trunk`)."""
        return decoder_trunk(self, tokens)[0]
