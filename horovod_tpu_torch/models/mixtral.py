"""Mixtral-style sparse-MoE decoder transformer, expert-parallel over ``ep``.

Counterpart of ``horovod_tpu/models/mixtral.py``: Llama blocks whose MLP is
a top-k routed bank of SwiGLU experts (:class:`MoEMLP`). The attention,
norms, LM head, remat policies, init and trunk are the port Llama's
(``models/llama.py``).

Expert parallelism follows the JAX package's explicit form
(``parallel.moe.routed_experts`` under ``shard_map``), not its GSPMD
``MoEMLP``: one process drives one GPU and holds only its shard of the
batch, so each rank routes its own tokens, with the capacity of its own
``T``, and exchanges the expert buffers over the mesh's ``ep`` axis in one
all-to-all each way. On a mesh with ``ep`` = n > 1 the model holds only its
experts ``[e E/n, (e + 1) E/n)``, e its ep index. In a world of one this is
the JAX model's function; on more ranks it equals JAX's GSPMD step when no
token is dropped and the aux loss is off (ROADMAP.md, section C).

fsdp and tp place the bank as JAX's ``LOGICAL_RULES`` do (``experts ->
ep``, ``embed -> fsdp``, ``mlp -> tp``): each rank holds ``[E/ep, D/fsdp,
M/tp]`` of ``w1``, ``w3`` and ``w2`` (:class:`MoEMLP`), and the attention,
norms, table and head are the Llama's mesh-aware modules. fsdp is a data
axis, so its ranks route their own tokens too; the tp ranks of a row share
theirs and route them alike.

Each expert's weights are drawn from a generator of their own, seeded from
``(seed, layer, expert)``, and the dense weights from the seed's generator
in module order, so rank e's slice equals those experts of the world-of-one
model from the same seed. flax's ``lecun_normal`` on a bank ``[E, D, M]``
counts E into the fan-in (``E D``), and so does the port.

Each block's router aux loss is kept in ``model.sown_losses["router_aux"]``
after a forward (one scalar a layer), where the train step reads it: the
counterpart of ``self.sow("losses", "router_aux", ...)``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import axis_size, get_mesh
from ..parallel.moe import _route
from ..parallel.sharding import (Placement, copy_to_tp, gather_param,
                                 placement, reduce_from_tp, set_placement)
from .llama import (Attention, Dense, Llama, LlamaConfig, RMSNorm,
                    _lecun_normal_, _tp_axis, decoder_trunk)
from .llama import logical_names as llama_logical_names


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.02


def mixtral_8x7b() -> MixtralConfig:
    return MixtralConfig(vocab_size=32000, dim=4096, n_layers=32,
                         n_heads=32, n_kv_heads=8, hidden_dim=14336,
                         rope_theta=1e6, n_experts=8, top_k=2)


def mixtral_tiny(vocab: int = 256) -> MixtralConfig:
    """CPU test configuration (the JAX package's, in f32)."""
    return MixtralConfig(vocab_size=vocab, dim=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, hidden_dim=128, max_seq_len=128,
                         dtype=torch.float32, remat=False, scan_layers=False,
                         n_experts=8, top_k=2, capacity_factor=2.0)


def expert_seed(seed: int, layer: int, expert: int, n_experts: int) -> int:
    """The seed of one expert's generator: one per (seed, layer, expert),
    whatever the ep layout."""
    return (seed * 1_000_003 + layer * n_experts + expert + 1) % (2 ** 63)


#: The expert bank's logical names (flax's layout, the port's too):
#: ``w1``/``w3`` ``[E, D, M]``, ``w2`` ``[E, M, D]``, the router kernel
#: ``[D, E]`` (``[E, D]`` here), ``horovod_tpu/models/mixtral.py:63-73``.
BANK_NAMES = {"w1": ("experts", "embed", "mlp"),
              "w3": ("experts", "embed", "mlp"),
              "w2": ("experts", "mlp", "embed")}
ROUTER_NAMES = (None, "embed")


def logical_names(key: str):
    """The logical names of the Mixtral parameter at state-dict ``key``:
    a bank's, the router's, or else the Llama's."""
    parts = key.split(".")
    if parts[-2:-1] == ["moe"] and parts[-1] in BANK_NAMES:
        return BANK_NAMES[parts[-1]]
    if parts[-2:] == ["router", "weight"]:
        return ROUTER_NAMES
    return llama_logical_names(key)


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU expert bank. ``w1``, ``w3`` ``[E, D, M]`` and
    ``w2`` ``[E, M, D]`` keep flax's layout, so the three expert products
    are ``torch.bmm`` on ``[E_local, n C, D]`` buffers; the router is an
    f32 ``[E, D]`` dense layer over the tokens promoted to f32.

    On a mesh each rank holds its block ``[E/ep, D/fsdp, M/tp]`` of each
    bank (:data:`BANK_NAMES`). The bank's ``D`` is gathered over fsdp where
    it is used, in the compute dtype, as the Llama's weights are, and so is
    the router's ``[E, D]`` f32 kernel, in f32. Under tp the expert input
    goes through ``copy_to_tp`` before the ``w1``/``w3`` products and
    ``w2``'s partial products are summed over tp after it
    (``reduce_from_tp``), in the compute dtype, as XLA sums JAX's bf16
    partial products. The tp ranks of a row see the same tokens (tp is not
    a data axis) and hold the same router, so they route them the same
    way: each dispatches the same buffers, exchanges them over its own ep
    row and multiplies its ``M/tp`` slice of every local expert.

    After a forward, ``load`` holds its routing counts (detached, on the
    device): the (token, choice) entries each expert kept, and the entries
    the capacity dropped."""

    def __init__(self, c: "MixtralConfig", device, mesh=None):
        super().__init__()
        ep = (mesh.axis("ep") if axis_size(mesh, "ep") > 1 else None)
        self.c, self.ep, self.tp = c, ep, _tp_axis(mesh)
        self.router = Dense(c.dim, c.n_experts, torch.float32, device,
                            ROUTER_NAMES, mesh)
        for name, dims in (("w1", (c.dim, c.hidden_dim)),
                           ("w3", (c.dim, c.hidden_dim)),
                           ("w2", (c.hidden_dim, c.dim))):
            place = placement(mesh, BANK_NAMES[name], (c.n_experts,) + dims)
            w = nn.Parameter(torch.empty(place.local_shape(), device=device))
            set_placement(w, place)
            setattr(self, name, w)
        local = self.w1.shape[0]
        self.first_expert = ep.index * local if ep is not None else 0
        self.load = None

    def experts(self, buf: torch.Tensor) -> torch.Tensor:
        """SwiGLU of each local expert over its rows: ``[E_local, N, D]``
        -> ``[E_local, N, D]`` in the compute dtype."""
        dt = self.c.dtype
        buf = copy_to_tp(buf, self.tp)
        h = F.silu(torch.bmm(buf, gather_param(self.w1, dt)))
        h = h * torch.bmm(buf, gather_param(self.w3, dt))
        return reduce_from_tp(torch.bmm(h, gather_param(self.w2, dt)),
                              self.tp)

    def forward(self, x: torch.Tensor):
        c = self.c
        B, T, D = x.shape
        E = c.n_experts
        tokens = x.reshape(B * T, D)
        # a profiler range, so a trace can tell the MoE's own ops apart
        with torch.profiler.record_function("hvd::moe"):
            y, r, capacity = _route(tokens, self.router(tokens),
                                    self.experts, self.ep, E,
                                    c.capacity_factor, c.top_k)
        # dest // C is the entry's expert, E for the dropped sentinel
        kept = torch.bincount(torch.div(r.dest, capacity,
                                        rounding_mode="floor"),
                              minlength=E + 1)
        self.load = (kept[:E].detach(), kept[E].detach())
        return y.to(c.dtype).reshape(B, T, D), r.aux_loss


class MixtralBlock(nn.Module):
    """Attention and the routed MLP, each after its RMSNorm; returns the
    output and the block's router aux loss."""

    def __init__(self, c: "MixtralConfig", device, mesh=None):
        super().__init__()
        self.attn_norm = RMSNorm(c.dim, c.norm_eps, c.dtype, device, mesh)
        self.attn = Attention(c, device, mesh)
        self.mlp_norm = RMSNorm(c.dim, c.norm_eps, c.dtype, device, mesh)
        self.moe = MoEMLP(c, device, mesh)

    def forward(self, x, positions):
        x = x + self.attn(self.attn_norm(x), positions)
        y, aux = self.moe(self.mlp_norm(x))
        return x + y, aux


class Mixtral(Llama):
    """The MoE decoder. ``mesh`` (default: the ambient mesh) places the
    parameters: the dense ones as the Llama's, and each expert bank as
    ``[E/ep, D/fsdp, M/tp]`` (:class:`MoEMLP`)."""

    def __init__(self, cfg: MixtralConfig, *, device=None, seed: int = 0,
                 mesh=None):
        mesh = get_mesh() if mesh is None else mesh
        super().__init__(cfg, device=device, seed=seed,
                         block=functools.partial(MixtralBlock, mesh=mesh),
                         mesh=mesh)
        self.sown_losses = None
        E = cfg.n_experts
        with torch.no_grad():
            for i, blk in enumerate(self.blocks):
                m = blk.moe
                for j in range(m.w1.shape[0]):
                    e = m.first_expert + j
                    gen = torch.Generator(device=m.w1.device).manual_seed(
                        expert_seed(seed, i, e, E))
                    for w in (m.w1, m.w3, m.w2):
                        # the whole expert, then its block; flax's fan-in
                        # of an [E, in, out] bank is E * in
                        place = w.placement
                        whole = torch.empty(place.shape[1:], device=w.device)
                        _lecun_normal_(whole, gen,
                                       fan_in=E * place.shape[1])
                        w[j].copy_(Placement(place.shape[1:], place.axes[1:])
                                   .block(whole))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """``tokens [B, T]`` -> f32 logits ``[B, T, V]`` (``V/tp`` on a tp
        axis); the blocks' aux losses go to ``sown_losses["router_aux"]``.
        """
        logits, aux = decoder_trunk(self, tokens)
        self.sown_losses = {"router_aux": aux}
        return logits


def router_load(model: nn.Module):
    """The last forward's routing counts of this rank's tokens, summed over
    the MoE layers, as host integers: the entries each expert kept (every
    expert, wherever it is held) and the entries dropped."""
    chosen, dropped = 0, 0
    for m in model.modules():
        if isinstance(m, MoEMLP) and m.load is not None:
            chosen = chosen + m.load[0]
            dropped = dropped + m.load[1]
    return [int(v) for v in chosen.tolist()], int(dropped)
