"""Carry Llama, Mixtral, ResNet, BERT and DLRM parameters between the JAX
package and the port.

:func:`llama_params_from_flax` turns a flax parameter tree (numpy or JAX
leaves) of ``horovod_tpu.models.llama.Llama`` into a ``state_dict`` of
:class:`horovod_tpu_torch.models.llama.Llama`; :func:`llama_params_to_flax`
is its inverse, so tests can compare parameters after a step.

Layout: flax stores dense kernels ``[in, out]`` (``x @ W``); the port keeps
``nn.Linear``'s ``[out, in]``, so every dense kernel, the LM head included,
is transposed on the way across. Both flax layer layouts are read: unrolled
``block_i`` subtrees, and scanned ``layers/block`` with ``[L, ...]`` leaves.
With ``tie_embeddings`` neither side has an LM head: the logits use the
embedding.

Under a mesh with ``fsdp`` or ``tp`` axes, :func:`llama_params_from_flax`
gives one rank's block of each parameter, as the model built under that
mesh holds it (``parallel/sharding.py``; a flax kernel ``[in, out]``
split over fsdp on its ``embed`` dim 0 is the port's ``[out, in]`` weight
split on dim 1); :func:`llama_params_to_flax` takes whole tensors, which
``sharding.full_state_dict`` gathers from the blocks.

:func:`mixtral_params_from_flax` reads a flax ``Mixtral`` the same way and
keeps only one ep rank's slice of each expert bank, or, under a mesh, one
rank's ``[E/ep, D/fsdp, M/tp]`` block of each; :func:`bert_params_from_flax`
takes a mesh too. The inverses take whole tensors
(``sharding.full_state_dict``).

The ResNet and BERT pairs (:func:`resnet_params_from_flax`,
:func:`bert_params_from_flax` and their inverses) do the same for those
models; ResNet's also carry the ``batch_stats`` collection (the running
statistics), and its conv kernels go from flax's HWIO to torch's OIHW.
:func:`dlrm_params_from_flax` flattens DLRM's ``[T, R, D]`` tables to
``[T R, D]``, under a mesh one ep rank's run of tables.

:func:`decode_params_from_flax` carries the serving side's decode
parameters (the JAX package's ``export_decode_params`` of a Llama or
Mixtral tree) to the port's (``train.step_builder.export_decode_params``).
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from .models.bert import Bert
from .models.llama import logical_names, resolve_scan_layers
from .models.mixtral import logical_names as mixtral_logical_names
from .parallel.embedding import TableExchange
from .parallel.sharding import placement, placement_of

_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("w1", "w2", "w3")


def _np(x) -> np.ndarray:
    """A leaf as an f32 numpy copy (never a view of a JAX buffer that a
    donating step may reuse); flax's partitioning boxes (anything with an
    ``unbox()``, as ``model.init`` returns them) are opened first."""
    if hasattr(x, "unbox"):
        x = x.unbox()
    return np.array(x, dtype=np.float32)


def _flax_blocks(p: Dict, cfg):
    """The block subtrees of a flax decoder tree, unrolled (``block_i``) or
    scanned (``layers/block`` with ``[L, ...]`` leaves)."""
    if "layers" in p:
        stacked = p["layers"]["block"]
        return [_index_tree(stacked, i) for i in range(cfg.n_layers)]
    return [p[f"block_{i}"] for i in range(cfg.n_layers)]


def _decoder_from_flax(p: Dict, cfg, mlp) -> Dict[str, np.ndarray]:
    """The decoder's embedding, final norm, LM head and blocks' norms and
    attention as the port's names; ``mlp(block, prefix, sd)`` adds each
    block's MLP."""
    sd = {"embedding": _np(p["embedding"]),
          "final_norm.scale": _np(p["final_norm"]["scale"])}
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = _np(p["lm_head"]).T
    for i, b in enumerate(_flax_blocks(p, cfg)):
        pre = f"blocks.{i}."
        sd[pre + "attn_norm.scale"] = _np(b["attn_norm"]["scale"])
        sd[pre + "mlp_norm.scale"] = _np(b["mlp_norm"]["scale"])
        for n in _ATTN:
            sd[pre + f"attn.{n}.weight"] = _np(b["attn"][n]["kernel"]).T
        mlp(b, pre, sd)
    return sd


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def llama_params_from_flax(params: Dict, cfg,
                           mesh=None) -> Dict[str, torch.Tensor]:
    """flax ``params`` (optionally under a ``"params"`` key; unrolled or
    scanned) → the port's ``state_dict`` (f32 CPU tensors); with ``mesh``,
    this rank's block of each parameter on it."""
    def mlp(b, pre, sd):
        for n in _MLP:
            sd[pre + f"mlp.{n}.weight"] = _np(b["mlp"][n]["kernel"]).T
    sd = _tensors(_decoder_from_flax(params.get("params", params), cfg, mlp))
    if mesh is None:
        return sd
    return {k: placement(mesh, logical_names(k), v.shape).block(v)
            .contiguous() for k, v in sd.items()}


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return _np(tree)[i]


def _decoder_to_flax(state_dict: Dict[str, torch.Tensor], cfg,
                     scanned: Optional[bool], mlp) -> Dict:
    """Inverse of :func:`_decoder_from_flax`: ``mlp(sd, prefix)`` gives each
    block's MLP subtree as ``{name: subtree}``."""
    if scanned is None:
        scanned = resolve_scan_layers(cfg)
    sd = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    blocks = []
    for i in range(cfg.n_layers):
        pre = f"blocks.{i}."
        blocks.append({
            "attn_norm": {"scale": sd[pre + "attn_norm.scale"]},
            "mlp_norm": {"scale": sd[pre + "mlp_norm.scale"]},
            "attn": {n: {"kernel": sd[pre + f"attn.{n}.weight"].T}
                     for n in _ATTN},
            **mlp(sd, pre),
        })
    out = {"embedding": sd["embedding"],
           "final_norm": {"scale": sd["final_norm.scale"]}}
    if not cfg.tie_embeddings:
        out["lm_head"] = sd["lm_head.weight"].T
    if scanned:
        out["layers"] = {"block": _stack_trees(blocks)}
    else:
        out.update({f"block_{i}": b for i, b in enumerate(blocks)})
    return out


def llama_params_to_flax(state_dict: Dict[str, torch.Tensor], cfg,
                         scanned: Optional[bool] = None) -> Dict:
    """The port's ``state_dict`` → a flax parameter tree of numpy arrays,
    unrolled (``block_i``) or, with ``scanned``, stacked under
    ``layers/block``. ``scanned=None`` takes the layout the JAX model of
    ``cfg`` has (``resolve_scan_layers``)."""
    return _decoder_to_flax(
        state_dict, cfg, scanned,
        lambda sd, pre: {"mlp": {n: {"kernel": sd[pre + f"mlp.{n}.weight"].T}
                                 for n in _MLP}})


# ----------------------------------------------------------------- Mixtral

def mixtral_params_from_flax(params: Dict, cfg, ep_rank: int = 0,
                             ep_size: int = 1,
                             mesh=None) -> Dict[str, torch.Tensor]:
    """A flax ``Mixtral``'s ``params`` → the port's ``state_dict`` for the
    rank at ep index ``ep_rank`` of ``ep_size``: the router kernel ``[D,
    E]`` transposed to ``[E, D]``, and of each expert bank (``w1``, ``w3``
    ``[E, D, M]``, ``w2`` ``[E, M, D]``, the port's layout too) only the
    experts ``[ep_rank E / ep_size, (ep_rank + 1) E / ep_size)``. With
    ``mesh`` (and ``ep_rank``, ``ep_size`` left alone), this rank's block
    of every parameter on it, as ``models.mixtral.Mixtral`` built under
    that mesh holds it: ``[E/ep, D/fsdp, M/tp]`` of each bank, the router
    split over fsdp on ``D``, the rest as the Llama's."""
    E = cfg.n_experts
    if E % ep_size:
        raise ValueError(f"experts {E} not divisible by ep size {ep_size}")
    lo, hi = ep_rank * E // ep_size, (ep_rank + 1) * E // ep_size

    def moe(b, pre, sd):
        sd[pre + "moe.router.weight"] = _np(b["moe"]["router"]["kernel"]).T
        for n in _MLP:
            sd[pre + f"moe.{n}"] = _np(b["moe"][n])[lo:hi]
    sd = _tensors(_decoder_from_flax(params.get("params", params), cfg, moe))
    if mesh is None:
        return sd
    if ep_size != 1:
        raise ValueError("pass ep_rank and ep_size, or mesh, not both")
    return {k: placement(mesh, mixtral_logical_names(k), v.shape).block(v)
            .contiguous() for k, v in sd.items()}


def mixtral_params_to_flax(state_dict: Dict[str, torch.Tensor], cfg,
                           scanned: Optional[bool] = None) -> Dict:
    """Inverse of :func:`mixtral_params_from_flax`, unrolled or scanned as
    :func:`llama_params_to_flax`; the expert banks hold the experts the
    ``state_dict`` holds."""
    return _decoder_to_flax(
        state_dict, cfg, scanned,
        lambda sd, pre: {"moe": {
            "router": {"kernel": sd[pre + "moe.router.weight"].T},
            **{n: sd[pre + f"moe.{n}"] for n in _MLP}}})


def decode_params_from_flax(params: Dict, cfg) -> Dict[str, torch.Tensor]:
    """A flax Llama's or Mixtral's ``params`` (unrolled or scanned; what
    the JAX package's ``export_decode_params`` returns) -> the port's decode
    parameters: the ``state_dict`` of :func:`llama_params_from_flax` or
    :func:`mixtral_params_from_flax` through
    ``train.step_builder.export_decode_params`` (matrices in the compute
    dtype)."""
    from .models.decode import is_moe
    from .train.step_builder import export_decode_params
    convert = mixtral_params_from_flax if is_moe(cfg) \
        else llama_params_from_flax
    return export_decode_params(convert(params, cfg), cfg)


def _stack_trees(trees):
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


# ------------------------------------------------------------------ ResNet

def _conv(k) -> np.ndarray:
    """A flax conv kernel HWIO -> the port's OIHW."""
    return _np(k).transpose(3, 2, 0, 1)


def _resnet_blocks(tree: Dict):
    """The block subtrees of a flax ResNet tree in order: ``ResNetBlock_i``,
    ``BottleneckResNetBlock_i``, or with ``remat_blocks`` the same names
    with a ``Checkpoint`` prefix."""
    found = {}
    for key in tree:
        m = re.fullmatch(r"\w*ResNetBlock_(\d+)", key)
        if m:
            found[int(m.group(1))] = tree[key]
    return [found[i] for i in range(len(found))]


# flax's auto-named layers of a block -> the port's, in block order.
_BLOCK_CONVS = ("Conv_0", "Conv_1", "Conv_2")
_BLOCK_NORMS = ("BatchNorm_0", "BatchNorm_1", "BatchNorm_2")


def resnet_params_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """A flax ResNet's variables, ``{"params": ..., "batch_stats": ...}``
    (``batch_stats`` may be absent) -> the port's ``state_dict`` (f32 CPU
    tensors): conv kernels HWIO -> OIHW, the Dense kernel transposed, BN
    ``scale``/``bias`` -> ``weight``/``bias`` and ``mean``/``var`` ->
    ``running_mean``/``running_var``."""
    p = variables["params"]
    s = variables.get("batch_stats", {})
    sd = {}

    def norm(pre, pt, st):
        sd[pre + "weight"] = _np(pt["scale"])
        sd[pre + "bias"] = _np(pt["bias"])
        if st:
            sd[pre + "running_mean"] = _np(st["mean"])
            sd[pre + "running_var"] = _np(st["var"])

    stem = "conv_init_s2d" if "conv_init_s2d" in p else "conv_init"
    sd["conv_init.weight"] = _conv(p[stem]["kernel"])
    norm("bn_init.", p["bn_init"], s.get("bn_init"))
    stat_blocks = _resnet_blocks(s) if s else None
    for i, b in enumerate(_resnet_blocks(p)):
        bs = stat_blocks[i] if stat_blocks else {}
        pre = f"blocks.{i}."
        for j, (c, n) in enumerate(zip(_BLOCK_CONVS, _BLOCK_NORMS)):
            if c in b:
                sd[pre + f"conv{j + 1}.weight"] = _conv(b[c]["kernel"])
                norm(pre + f"bn{j + 1}.", b[n], bs.get(n))
        if "conv_proj" in b:
            sd[pre + "conv_proj.weight"] = _conv(b["conv_proj"]["kernel"])
            norm(pre + "norm_proj.", b["norm_proj"], bs.get("norm_proj"))
    sd["head.weight"] = _np(p["Dense_0"]["kernel"]).T
    sd["head.bias"] = _np(p["Dense_0"]["bias"])
    return _tensors(sd)


def resnet_params_to_flax(state_dict: Dict[str, torch.Tensor],
                          model) -> Dict:
    """The port's ``state_dict`` of ``model`` (a port ``ResNet``) -> flax
    variables ``{"params": ..., "batch_stats": ...}`` of numpy arrays, named
    as the JAX ResNet of the same configuration names them."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    params, stats = {}, {}

    def norm(pre):
        return ({"scale": sd[pre + "weight"], "bias": sd[pre + "bias"]},
                {"mean": sd[pre + "running_mean"],
                 "var": sd[pre + "running_var"]})

    conv = lambda k: sd[k].transpose(2, 3, 1, 0)
    stem = ("conv_init_s2d" if model.stem == "space_to_depth"
            and not model.small_images else "conv_init")
    params[stem] = {"kernel": conv("conv_init.weight")}
    params["bn_init"], stats["bn_init"] = norm("bn_init.")
    name = type(model.blocks[0]).__name__
    if model.remat_blocks:
        name = "Checkpoint" + name
    for i, block in enumerate(model.blocks):
        pre, bp, bs = f"blocks.{i}.", {}, {}
        for j, (c, n) in enumerate(zip(_BLOCK_CONVS, _BLOCK_NORMS)):
            if hasattr(block, f"conv{j + 1}"):
                bp[c] = {"kernel": conv(pre + f"conv{j + 1}.weight")}
                bp[n], bs[n] = norm(pre + f"bn{j + 1}.")
        if block.conv_proj is not None:
            bp["conv_proj"] = {"kernel": conv(pre + "conv_proj.weight")}
            bp["norm_proj"], bs["norm_proj"] = norm(pre + "norm_proj.")
        params[f"{name}_{i}"], stats[f"{name}_{i}"] = bp, bs
    params["Dense_0"] = {"kernel": sd["head.weight"].T,
                         "bias": sd["head.bias"]}
    return {"params": params, "batch_stats": stats}


# -------------------------------------------------------------------- BERT

_BERT_DENSE = ("wq", "wk", "wv", "wo", "ffn_in", "ffn_out")
_BERT_NORMS = ("attn_norm", "ffn_norm")


def bert_params_from_flax(params: Dict, cfg,
                          mesh=None) -> Dict[str, torch.Tensor]:
    """flax BERT ``params`` (optionally under a ``"params"`` key) -> the
    port's ``state_dict`` (f32 CPU tensors); dense kernels transposed.
    With ``mesh``, this rank's block of each parameter on it, as
    ``models.bert.Bert`` built under that mesh holds it."""
    p = params.get("params", params)
    sd = {"tok_embedding": _np(p["tok_embedding"]),
          "pos_embedding": _np(p["pos_embedding"])}

    def dense(pre, t):
        sd[pre + "weight"] = _np(t["kernel"]).T
        sd[pre + "bias"] = _np(t["bias"])

    def norm(pre, t):
        sd[pre + "scale"] = _np(t["scale"])
        sd[pre + "bias"] = _np(t["bias"])

    norm("embed_norm.", p["embed_norm"])
    for i in range(cfg.n_layers):
        layer, pre = p[f"layer_{i}"], f"layers.{i}."
        for n in _BERT_DENSE:
            dense(pre + n + ".", layer[n])
        for n in _BERT_NORMS:
            norm(pre + n + ".", layer[n])
    dense("mlm_transform.", p["mlm_transform"])
    norm("mlm_norm.", p["mlm_norm"])
    sd = _tensors(sd)
    if mesh is None:
        return sd
    # each block as the model holds it: the placements of a model of
    # shapes alone (the LayerNorms have none: whole)
    shell = Bert(cfg, device="meta", mesh=mesh)
    return {k: (placement_of(p).block(sd[k]) if placement_of(p) is not None
                else sd[k]).contiguous()
            for k, p in shell.named_parameters()}


def bert_params_to_flax(state_dict: Dict[str, torch.Tensor], cfg) -> Dict:
    """The port's ``state_dict`` -> a flax BERT parameter tree of numpy
    arrays."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    dense = lambda pre: {"kernel": sd[pre + "weight"].T,
                         "bias": sd[pre + "bias"]}
    norm = lambda pre: {"scale": sd[pre + "scale"], "bias": sd[pre + "bias"]}
    out = {"tok_embedding": sd["tok_embedding"],
           "pos_embedding": sd["pos_embedding"],
           "embed_norm": norm("embed_norm."),
           "mlm_transform": dense("mlm_transform."),
           "mlm_norm": norm("mlm_norm.")}
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        out[f"layer_{i}"] = {**{n: dense(pre + n + ".") for n in _BERT_DENSE},
                             **{n: norm(pre + n + ".") for n in _BERT_NORMS}}
    return out


# -------------------------------------------------------------------- DLRM

def dlrm_params_from_flax(params: Dict, cfg,
                          mesh=None) -> Dict[str, torch.Tensor]:
    """flax DLRM ``params`` (optionally under a ``"params"`` key) -> the
    port's ``state_dict`` (f32 CPU tensors): dense kernels ``[in, out]``
    transposed to ``[out, in]``, and ``embedding_tables [T, R, D]`` as this
    rank's tables flat, ``[T_local R, D]``: all of them without a mesh or
    an ep split, else the run of tables its ep index owns
    (``parallel.embedding.table_split``)."""
    p = params.get("params", params)
    ex = TableExchange(cfg.num_tables,
                       mesh.axes.get("ep") if mesh is not None else None)
    tables = _np(p["embedding_tables"])[ex.first:ex.first + ex.local]
    sd = {"embedding_tables": tables.reshape(-1, cfg.embed_dim)}
    for stack, sizes in (("bottom", cfg.bottom_mlp), ("top", cfg.top_mlp)):
        for i in range(len(sizes)):
            layer = p[stack][f"fc{i}"]
            sd[f"{stack}.fc{i}.weight"] = _np(layer["kernel"]).T
            sd[f"{stack}.fc{i}.bias"] = _np(layer["bias"])
    return _tensors(sd)


def dlrm_params_to_flax(state_dict: Dict[str, torch.Tensor], cfg) -> Dict:
    """The port's whole ``state_dict`` (every table) -> a flax DLRM
    parameter tree of numpy arrays."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    out = {"embedding_tables": sd["embedding_tables"].reshape(
        cfg.num_tables, cfg.rows_per_table, cfg.embed_dim)}
    for stack, sizes in (("bottom", cfg.bottom_mlp), ("top", cfg.top_mlp)):
        out[stack] = {f"fc{i}": {"kernel": sd[f"{stack}.fc{i}.weight"].T,
                                 "bias": sd[f"{stack}.fc{i}.bias"]}
                      for i in range(len(sizes))}
    return out
