"""Training losses.

Counterpart of ``horovod_tpu/train/gspmd.py::next_token_loss``.
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
