"""Flash-attention auto-resolution for the model families.

Counterpart of ``horovod_tpu/models/_flash.py``: an explicit flag wins, then
``HOROVOD_FLASH_ATTENTION=0/1``, then the automatic choice — the CUDA kernels
for CUDA tensors at sequences of at least :data:`AUTO_MIN_SEQ`, the plain
materialised softmax on the CPU.
"""

import os

import torch

# Placeholder: 512 is the crossover measured for the Pallas kernel on a TPU
# v5e (BERT-Large, seq 512). It has not yet been measured for the CUDA
# kernels on the H100; the port's own bench will set it.
AUTO_MIN_SEQ = 512


def resolve_flash(use_flash, seq_len=None, device=None) -> bool:
    """Whether attention over ``seq_len`` tokens on ``device`` runs the flash
    kernels. ``use_flash`` True/False forces the choice; None is automatic."""
    if use_flash is not None:
        return bool(use_flash)
    env = os.environ.get("HOROVOD_FLASH_ATTENTION")
    if env is not None:
        return env not in ("0", "false", "False", "")
    if device is None or torch.device(device).type != "cuda":
        return False
    return seq_len is None or seq_len >= AUTO_MIN_SEQ
