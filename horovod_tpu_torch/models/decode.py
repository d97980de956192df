"""Paged KV-cache decode for the autoregressive models (Llama, Mixtral).

Counterpart of ``horovod_tpu/models/decode.py``: a preallocated pool of
fixed-size KV blocks, per-sequence block tables mapping logical positions
to physical blocks, and queries attending against the gathered pages.
Three functions per model configuration:

- **prefill** (:func:`make_prefill`): the full causal forward over one
  padded prompt, with the materialised f32 softmax of the training
  attention, writing every layer's post-RoPE K and raw V into the slot's
  blocks. Returns the logits at every position.
- **decode** (:func:`make_decode_step`): a fixed-width slot batch ``[S]``
  advances one token. Each layer projects the new token's q, k and v,
  writes k and v at ``(table[pos // bs], pos % bs)``, then reads the whole
  context back as a gather over the block tables. Masked slots (inactive
  or stalled) write zeros, through their zero-padded tables, into the
  null block 0, so block 0 stays all zero.
- **verify** (:func:`make_verify_step`): the decode step widened to a
  ``[S, K]`` window of candidate tokens for speculative decoding; one
  mask admits context position ``t`` for window row ``j`` iff ``t <= pos +
  j``, which is the past and the in-window causality at once.

The functions take the port's decode parameters: a flat dict under the
port's ``state_dict`` names (``blocks.{i}.attn.wq.weight`` ``[out, in]``,
``blocks.{i}.moe.w1`` ``[E, D, M]``, ...), as
``train.step_builder.export_decode_params`` gives them, with the matrix
weights already in the compute dtype. The arithmetic mirrors the JAX
functions: the same f32 islands (RMSNorm, the attention softmax, the
router, the LM head's accumulation), the same grouped-query pairing (head
``h`` reads KV group ``h // rep``), and the same routing of a flat ``[T,
D]`` token batch through ``parallel/moe.py``'s sort-based plan, the
masked slots' rows included.

The pools are changed in place: each function returns the pools it was
given, so a caller written for the JAX functions (``logits, k_pool, v_pool
= prefill(...)``) reads the same.

**Tensor parallelism** (:func:`make_prefill_tp`, :func:`make_decode_step_tp`,
:func:`make_verify_step_tp`): each rank of a tp process group holds its
shard of the decode parameters (:func:`decode_param_specs`: ``wq``,
``wk``, ``wv``, ``w1``, ``w3`` split on their output dim, ``wo`` and ``w2``
on their input dim, the expert banks on ``M``; the embedding, the norms,
the router and the LM head whole) and its heads' slice of the pools,
``[L, n_blocks, bs, n_kv / tp, hd]``. Each layer makes exactly two
all-reduces over the group, in the compute dtype: one after ``wo`` and one
after the MLP or expert down-projection, both before the residual add.
Nothing else goes on the wire: KV never moves between ranks, and the
replicated head gives every rank the same logits and greedy tokens. This
is not the training tp plan of ``parallel/sharding.py``, which splits the
vocabulary.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.moe import sorted_combine, sorted_dispatch, topk_router_sorted
from ..parallel.sharding import reduce_from_tp
from .llama import LlamaConfig, head_logits, rope

NULL_BLOCK = 0  #: block 0 is reserved: masked slots write and read here

#: Column-parallel weights (split on their output dim, the port's dim 0)
#: and row-parallel ones (split on their input dim, dim 1).
_COLUMN = ("wq", "wk", "wv", "w1", "w3")
_ROW = ("wo", "w2")


def is_moe(cfg: LlamaConfig) -> bool:
    """Mixtral-family configs carry an expert bank."""
    return getattr(cfg, "n_experts", 0) > 0


def init_kv_pools(cfg: LlamaConfig, n_blocks: int, block_size: int, *,
                  tp: int = 1, device=None) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Zeroed K and V pools ``[L, n_blocks, block_size, n_kv / tp, hd]`` in
    the compute dtype (block 0 is the null block). ``device`` defaults to
    the card."""
    head_dim = cfg.dim // cfg.n_heads
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads // tp,
             head_dim)
    device = torch.device("cuda" if device is None else device)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


# -- mirrors of the model's modules -------------------------------------------

def _rmsnorm(x, scale, eps, dtype):
    x32 = x.float()
    norm = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (norm * scale).to(dtype)


def _dense(x, weight, dtype):
    """``nn.Dense(dtype=...)`` on a ``[out, in]`` weight: both operands in
    the compute dtype (a no-op cast for exported weights)."""
    return F.linear(x.to(dtype), weight.to(dtype))


def _mlp(p, pre, c, x):
    gate = _dense(x, p[pre + "w1.weight"], c.dtype)
    up = _dense(x, p[pre + "w3.weight"], c.dtype)
    return _dense(F.silu(gate) * up, p[pre + "w2.weight"], c.dtype)


def _moe(p, pre, c, tokens):
    """The routed expert bank on a flat ``[T, D]`` token batch: the f32
    router, capacity ``max(1, int(cf k T / E))`` over all ``T`` rows
    (masked slots' rows are routed too and compete for it, as in JAX), the
    sort-based dispatch and combine of ``parallel/moe.py``. Under tp the
    bank holds this rank's ``M`` slice, and the result is a partial sum."""
    E = c.n_experts
    T = tokens.shape[0]
    logits = tokens.float() @ p[pre + "router.weight"].float().t()
    capacity = max(1, int(c.capacity_factor * c.top_k * T / E))
    r = topk_router_sorted(logits, E, capacity, c.top_k)
    dispatched = sorted_dispatch(tokens, r, E, capacity)
    dt = c.dtype
    h = F.silu(torch.bmm(dispatched, p[pre + "w1"].to(dt)))
    h = h * torch.bmm(dispatched, p[pre + "w3"].to(dt))
    out = torch.bmm(h, p[pre + "w2"].to(dt))
    return sorted_combine(out, r, T).to(dt)


def _ffn(p, i, c, x, moe: bool, axis):
    """The block's second half-residual on ``[..., D]`` activations; under
    tp the down-projection's partial sum is all-reduced over ``axis``
    before the residual add."""
    pre = f"blocks.{i}."
    y = _rmsnorm(x, p[pre + "mlp_norm.scale"], c.norm_eps, c.dtype)
    if moe:
        part = _moe(p, pre + "moe.", c,
                    y.reshape(-1, y.shape[-1])).reshape(y.shape)
    else:
        part = _mlp(p, pre + "mlp.", c, y)
    return x + reduce_from_tp(part, axis)


def _lm_head(p, c, x):
    """f32 logits: compute-dtype operands, f32 accumulation."""
    w = p["embedding"] if c.tie_embeddings else p["lm_head.weight"]
    return head_logits(x, w, c.dtype)


def _embed(p, c, tokens):
    return p["embedding"][tokens].to(c.dtype)


def _final(p, c, x):
    x = _rmsnorm(x, p["final_norm.scale"], c.norm_eps, c.dtype)
    return _lm_head(p, c, x)


def _attn_prefill(p, pre, c, x, positions, n_heads, n_kv):
    """Causal attention over the whole padded prompt, the training
    formulation (the materialised f32 softmax of ``llama.Attention``),
    also returning the pre-repeat post-RoPE K and raw V for the cache."""
    head_dim = c.dim // c.n_heads
    B, T = x.shape[0], x.shape[1]
    q = _dense(x, p[pre + "wq.weight"], c.dtype).view(B, T, n_heads, head_dim)
    k = _dense(x, p[pre + "wk.weight"], c.dtype).view(B, T, n_kv, head_dim)
    v = _dense(x, p[pre + "wv.weight"], c.dtype).view(B, T, n_kv, head_dim)
    q = rope(q, positions, c.rope_theta)
    k = rope(k, positions, c.rope_theta)
    rep = n_heads // n_kv
    kr = torch.repeat_interleave(k, rep, dim=2)
    vr = torch.repeat_interleave(v, rep, dim=2)
    scale = 1.0 / head_dim ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr).float() * scale
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    s = torch.where(mask, s, -1e30)
    pr = torch.softmax(s, dim=-1).to(c.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", pr, vr).reshape(
        B, T, n_heads * head_dim)
    return _dense(o, p[pre + "wo.weight"], c.dtype), k, v


def _local_heads(cfg: LlamaConfig, axis) -> Tuple[int, int]:
    shards = 1 if axis is None else axis.size
    validate_tp(cfg, shards)
    return cfg.n_heads // shards, cfg.n_kv_heads // shards


def _make_prefill(cfg: LlamaConfig, block_size: int, axis=None):
    """Prefill body; with a tp ``axis`` the parameters and pools are this
    rank's shards and the attention-out and MLP-down partials are summed
    over it."""
    moe = is_moe(cfg)
    n_heads_l, n_kv_l = _local_heads(cfg, axis)
    head_dim = cfg.dim // cfg.n_heads

    @torch.no_grad()
    def prefill(params, k_pool, v_pool, tokens, block_ids):
        T = tokens.shape[1]
        if T % block_size:
            raise ValueError(f"prefill bucket {T} must be a multiple of "
                             f"block_size {block_size}")
        x = _embed(params, cfg, tokens)
        positions = torch.arange(T, device=tokens.device)[None, :]
        n_ch = T // block_size
        for i in range(cfg.n_layers):
            pre = f"blocks.{i}."
            h, k, v = _attn_prefill(
                params, pre + "attn.", cfg,
                _rmsnorm(x, params[pre + "attn_norm.scale"], cfg.norm_eps,
                         cfg.dtype),
                positions, n_heads_l, n_kv_l)
            x = _ffn(params, i, cfg, x + reduce_from_tp(h, axis), moe, axis)
            shape = (n_ch, block_size, n_kv_l, head_dim)
            k_pool[i, block_ids] = k[0].reshape(shape).to(k_pool.dtype)
            v_pool[i, block_ids] = v[0].reshape(shape).to(v_pool.dtype)
        return _final(params, cfg, x), k_pool, v_pool

    return prefill


def make_prefill(cfg: LlamaConfig, block_size: int):
    """The prefill function for ``cfg``.

    ``prefill(params, k_pool, v_pool, tokens[1, T], block_ids[T // bs])
    -> (logits[1, T, V] f32, k_pool, v_pool)``: K/V of positions ``0..T-1``
    land in the slot's blocks; positions at or past the real prompt length
    hold padding K/V, harmless because the decode mask admits only ``t <=
    pos`` and the decode step rewrites position ``pos`` before its first
    read."""
    return _make_prefill(cfg, block_size)


def _paged_attention(params, pre, cfg, k_pool, v_pool, i, h, pos, blk, off,
                     active, block_tables, mask, n_heads_l, n_kv_l):
    """One layer's attention for a ``[S, K]`` window (K = 1 for decode):
    project, rotate, write the window's K/V (zeros for masked slots), read
    the whole context back by a gather over the block tables, attend with
    the f32 softmax under ``mask [S, K, t_max]``. Returns ``[S, K, H_l
    hd]`` before ``wo``."""
    c = cfg
    head_dim = c.dim // c.n_heads
    rep = c.n_heads // c.n_kv_heads
    S, K = h.shape[0], h.shape[1]
    q = _dense(h, params[pre + "wq.weight"], c.dtype).view(
        S, K, n_heads_l, head_dim)
    k = _dense(h, params[pre + "wk.weight"], c.dtype).view(
        S, K, n_kv_l, head_dim)
    v = _dense(h, params[pre + "wv.weight"], c.dtype).view(
        S, K, n_kv_l, head_dim)
    q = rope(q, pos, c.rope_theta)
    k = rope(k, pos, c.rope_theta)
    # Masked slots target the null block through their zero-padded tables
    # and write zeros there: the duplicates of (0, off) all carry 0, so the
    # order of the writes cannot matter, and block 0 stays all zero.
    act = active[:, None, None, None]
    k_pool[i, blk, off] = torch.where(act, k, 0).to(k_pool.dtype)
    v_pool[i, blk, off] = torch.where(act, v, 0).to(v_pool.dtype)
    bmax = block_tables.shape[1]
    t_max = bmax * k_pool.shape[2]
    kb = k_pool[i][block_tables].reshape(S, t_max, n_kv_l, head_dim)
    vb = v_pool[i][block_tables].reshape(S, t_max, n_kv_l, head_dim)
    qg = q.reshape(S, K, n_kv_l, rep, head_dim)
    scale = 1.0 / head_dim ** 0.5
    s = torch.einsum("skgrd,stgd->skgrt", qg, kb).float() * scale
    s = torch.where(mask[:, :, None, None, :], s, -1e30)
    pr = torch.softmax(s, dim=-1).to(c.dtype)
    return torch.einsum("skgrt,stgd->skgrd", pr, vb).reshape(
        S, K, n_heads_l * head_dim)


def _make_window_step(cfg: LlamaConfig, block_size: int, axis, window: bool):
    """The decode step (``window=False``: ``tokens [S]``) or the verify
    step (``window=True``: ``tokens [S, K]``), one body: the decode step
    is the verify step at K = 1 with the window axis squeezed, as in JAX,
    where the decode mask ``t <= pos`` is the verify mask's row 0."""
    moe = is_moe(cfg)
    n_heads_l, n_kv_l = _local_heads(cfg, axis)

    @torch.no_grad()
    def step(params, k_pool, v_pool, tokens, positions, block_tables,
             active):
        toks = tokens if window else tokens[:, None]
        S, K = toks.shape
        t_max = block_tables.shape[1] * block_size
        x = _embed(params, cfg, toks)
        # window position j of slot s sits at logical position pos[s] + j
        pos = positions[:, None] + torch.arange(
            K, device=positions.device, dtype=positions.dtype)[None, :]
        blk = torch.gather(block_tables, 1, pos // block_size)
        off = pos % block_size
        mask = (torch.arange(t_max, device=positions.device)[None, None, :]
                <= pos[:, :, None])
        for i in range(cfg.n_layers):
            pre = f"blocks.{i}."
            h = _rmsnorm(x, params[pre + "attn_norm.scale"], cfg.norm_eps,
                         cfg.dtype)
            o = _paged_attention(params, pre + "attn.", cfg, k_pool, v_pool,
                                 i, h, pos, blk, off, active, block_tables,
                                 mask, n_heads_l, n_kv_l)
            attn_out = _dense(o, params[pre + "attn.wo.weight"], cfg.dtype)
            x = _ffn(params, i, cfg, x + reduce_from_tp(attn_out, axis), moe,
                     axis)
        logits = _final(params, cfg, x)
        next_tokens = logits.argmax(-1)
        if not window:
            logits, next_tokens = logits[:, 0], next_tokens[:, 0]
        # masked slots' rows are garbage the engine discards; only their
        # K/V writes needed masking, to keep the null block zero
        return logits, next_tokens, k_pool, v_pool

    return step


def make_decode_step(cfg: LlamaConfig, block_size: int):
    """The single-token decode step for ``cfg``.

    ``decode(params, k_pool, v_pool, tokens[S], positions[S],
    block_tables[S, Bmax], active[S]) -> (logits[S, V] f32,
    next_tokens[S] int64, k_pool, v_pool)``. Greedy next tokens are
    computed on the card, so the engine feeds them back without a host
    round trip. ``tokens``, ``positions`` and ``block_tables`` are int64
    (``torch.gather`` takes no other index type)."""
    return _make_window_step(cfg, block_size, None, window=False)


def make_verify_step(cfg: LlamaConfig, block_size: int):
    """The speculative K-token verify step for ``cfg``.

    ``verify(params, k_pool, v_pool, tokens[S, K], positions[S],
    block_tables[S, Bmax], active[S]) -> (logits[S, K, V] f32,
    next_tokens[S, K], k_pool, v_pool)``. ``tokens[s, 0]`` is slot ``s``'s
    pending token at ``positions[s]``, ``tokens[s, 1:]`` the drafts after
    it. Row ``j`` of ``next_tokens[s]`` is the greedy continuation after
    window tokens ``0..j``: ``next_tokens[s, 0]`` is always the true next
    token, and draft ``j + 1`` is accepted iff it equals ``next_tokens[s,
    j]`` with every earlier draft accepted. Rejected candidates' K/V land
    in the pool harmlessly: the engine rewinds ``positions`` to the
    accepted prefix, the mask never admits a position past it, and the
    next window, which starts there, overwrites them first."""
    return _make_window_step(cfg, block_size, None, window=True)


# -- the tp plan -------------------------------------------------------------

def validate_tp(cfg: LlamaConfig, tp: int) -> None:
    """The divisibility contract of the decode plan: query and KV heads
    split the head dim, the MLP or expert hidden dim splits its matrices.
    ``tp`` of 1 (or 0) is always valid."""
    if tp <= 1:
        return
    for name, value in (("n_heads", cfg.n_heads),
                        ("n_kv_heads", cfg.n_kv_heads),
                        ("hidden_dim", cfg.hidden_dim)):
        if value % tp:
            raise ValueError(f"tp={tp} does not divide cfg.{name}={value}")


def decode_leaf_shard_axis(key: str, shape, tp: int) -> Optional[int]:
    """Which dim of the decode parameter at state-dict ``key`` (of
    ``shape``, the port's layout) the tp plan splits, or None if it is
    whole (or indivisible by ``tp``). Dense weights are ``[out, in]``:
    column-parallel ones split dim 0, row-parallel ones dim 1; the banks
    ``w1``, ``w3`` ``[E, D, M]`` and ``w2`` ``[E, M, D]`` split ``M``."""
    parts = key.split(".")
    leaf, parent = parts[-1], (parts[-2] if len(parts) >= 2 else None)
    if leaf == "weight" and parent in _COLUMN:
        ax = len(shape) - 2
    elif leaf == "weight" and parent in _ROW:
        ax = len(shape) - 1
    elif leaf in ("w1", "w3") and parent == "moe":
        ax = len(shape) - 1
    elif leaf == "w2" and parent == "moe":
        ax = len(shape) - 2
    else:
        return None
    return ax if (tp > 0 and shape[ax] % tp == 0) else None


def decode_param_specs(cfg: LlamaConfig, params: Dict[str, torch.Tensor],
                       tp: int) -> Dict[str, Optional[int]]:
    """Each decode parameter's tp split (the dim, or None for a whole
    one): ``wq``, ``wk``, ``wv``, ``w1`` and ``w3`` column-parallel,
    ``wo`` and ``w2`` row-parallel, the expert banks on ``M``; the
    embedding, the norms, the router and the LM head whole."""
    validate_tp(cfg, tp)
    return {k: decode_leaf_shard_axis(k, tuple(v.shape), tp)
            for k, v in params.items()}


def decode_shard(cfg: LlamaConfig, params: Dict[str, torch.Tensor], tp: int,
                 index: int) -> Dict[str, torch.Tensor]:
    """Rank ``index``'s shard of the whole decode parameters ``params``
    under tp ``tp`` (contiguous blocks, so each rank's query heads read
    its own KV heads)."""
    out = {}
    for k, ax in decode_param_specs(cfg, params, tp).items():
        v = params[k]
        if ax is not None:
            n = v.shape[ax] // tp
            v = v.narrow(ax, index * n, n).contiguous()
        out[k] = v
    return out


def _tp_axis(mesh, axis: str):
    ax = mesh.axis(axis)
    return ax if ax.size > 1 else None


def make_prefill_tp(cfg: LlamaConfig, block_size: int, mesh,
                    axis: str = "tp"):
    """:func:`make_prefill` over ``mesh``'s ``axis``: the parameters are
    this rank's shard (:func:`decode_shard`), the pools its heads' slice;
    tokens, block ids and the logits are the same on every rank."""
    return _make_prefill(cfg, block_size, _tp_axis(mesh, axis))


def make_decode_step_tp(cfg: LlamaConfig, block_size: int, mesh,
                        axis: str = "tp"):
    """:func:`make_decode_step` over ``mesh``'s ``axis``: exactly ``2 *
    n_layers`` all-reduces of ``[S, D]`` activations (attention-out and
    MLP or expert down, counted in ``sharding.counts["tp_all_reduce"]``)
    and no other collective; slot state, tables, logits and next tokens
    are the same on every rank."""
    return _make_window_step(cfg, block_size, _tp_axis(mesh, axis),
                             window=False)


def make_verify_step_tp(cfg: LlamaConfig, block_size: int, mesh,
                        axis: str = "tp"):
    """:func:`make_verify_step` over ``mesh``'s ``axis``: the decode
    step's contract at the window width, ``2 * n_layers`` all-reduces of
    ``[S, K, D]`` and nothing else."""
    return _make_window_step(cfg, block_size, _tp_axis(mesh, axis),
                             window=True)
