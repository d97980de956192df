"""Training losses.

Counterparts of ``horovod_tpu/train/gspmd.py::next_token_loss``,
``horovod_tpu/models/bert.py::mlm_loss`` and the masked cross entropy of
``benchmarks/bert.py``.
"""

from __future__ import annotations

import torch


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    mask: torch.Tensor = None) -> torch.Tensor:
    """Shifted next-token cross entropy, written as ``logsumexp - target
    logit`` so the full ``[B, T, V]`` log-probabilities are never kept.
    ``mask`` ``[B, T]`` weights the target positions."""
    targets = tokens[:, 1:]
    logits = logits[:, :-1].float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None]).squeeze(-1)
    nll = lse - tgt
    if mask is not None:
        m = mask[:, 1:].to(nll.dtype)
        return (nll * m).sum() / m.sum().clamp_min(1.0)
    return nll.mean()


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logsumexp - target logit`` in f32 at every position."""
    logits = logits.float()
    tgt = torch.gather(logits, -1, labels[..., None]).squeeze(-1)
    return torch.logsumexp(logits, dim=-1) - tgt


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Masked-LM cross entropy over the positions where ``mask`` is set
    (``horovod_tpu/models/bert.py::mlm_loss``)."""
    nll = _nll(logits, labels)
    m = mask.to(nll.dtype)
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def masked_label_loss(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy over the positions whose label is not -1, the labels
    carrying their own mask (``benchmarks/bert.py``'s ``loss_fn``)."""
    valid = labels >= 0
    return mlm_loss(logits, labels.clamp_min(0), valid)
