"""Carry Llama parameters between the JAX package and the port.

:func:`llama_params_from_flax` turns a flax parameter tree (numpy or JAX
leaves) of ``horovod_tpu.models.llama.Llama`` into a ``state_dict`` of
:class:`horovod_tpu_torch.models.llama.Llama`; :func:`llama_params_to_flax`
is its inverse, so tests can compare parameters after a step.

Layout: flax stores dense kernels ``[in, out]`` (``x @ W``); the port keeps
``nn.Linear``'s ``[out, in]``, so every dense kernel, the LM head included,
is transposed on the way across. Both flax layer layouts are read: unrolled
``block_i`` subtrees, and scanned ``layers/block`` with ``[L, ...]`` leaves.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("w1", "w2", "w3")


def _np(x) -> np.ndarray:
    """A leaf as an f32 numpy copy (never a view of a JAX buffer that a
    donating step may reuse); flax's partitioning boxes (anything with an
    ``unbox()``, as ``model.init`` returns them) are opened first."""
    if hasattr(x, "unbox"):
        x = x.unbox()
    return np.array(x, dtype=np.float32)


def llama_params_from_flax(params: Dict, cfg) -> Dict[str, torch.Tensor]:
    """flax ``params`` (optionally under a ``"params"`` key) → the port's
    ``state_dict`` (f32 CPU tensors)."""
    p = params.get("params", params)
    if "layers" in p:
        stacked = p["layers"]["block"]
        blocks = [_index_tree(stacked, i) for i in range(cfg.n_layers)]
    else:
        blocks = [p[f"block_{i}"] for i in range(cfg.n_layers)]
    sd = {"embedding": _np(p["embedding"]),
          "final_norm.scale": _np(p["final_norm"]["scale"]),
          "lm_head.weight": _np(p["lm_head"]).T}
    for i, b in enumerate(blocks):
        pre = f"blocks.{i}."
        sd[pre + "attn_norm.scale"] = _np(b["attn_norm"]["scale"])
        sd[pre + "mlp_norm.scale"] = _np(b["mlp_norm"]["scale"])
        for n in _ATTN:
            sd[pre + f"attn.{n}.weight"] = _np(b["attn"][n]["kernel"]).T
        for n in _MLP:
            sd[pre + f"mlp.{n}.weight"] = _np(b["mlp"][n]["kernel"]).T
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return _np(tree)[i]


def llama_params_to_flax(state_dict: Dict[str, torch.Tensor], cfg,
                         scanned: bool = False) -> Dict:
    """The port's ``state_dict`` → a flax parameter tree of numpy arrays,
    unrolled (``block_i``) or, with ``scanned``, stacked under
    ``layers/block``."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    blocks = []
    for i in range(cfg.n_layers):
        pre = f"blocks.{i}."
        blocks.append({
            "attn_norm": {"scale": sd[pre + "attn_norm.scale"]},
            "mlp_norm": {"scale": sd[pre + "mlp_norm.scale"]},
            "attn": {n: {"kernel": sd[pre + f"attn.{n}.weight"].T}
                     for n in _ATTN},
            "mlp": {n: {"kernel": sd[pre + f"mlp.{n}.weight"].T}
                    for n in _MLP},
        })
    out = {"embedding": sd["embedding"],
           "final_norm": {"scale": sd["final_norm.scale"]},
           "lm_head": sd["lm_head.weight"].T}
    if scanned:
        out["layers"] = {"block": _stack_trees(blocks)}
    else:
        out.update({f"block_{i}": b for i, b in enumerate(blocks)})
    return out


def _stack_trees(trees):
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
