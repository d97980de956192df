"""Flash-attention auto-resolution for the model families.

Counterpart of ``horovod_tpu/models/_flash.py``: an explicit flag wins, then
``HOROVOD_FLASH_ATTENTION=0/1``, then the automatic choice — the CUDA kernels
for CUDA tensors at sequences of at least :data:`AUTO_MIN_SEQ`, the plain
materialised softmax on the CPU.
"""

import os

import torch

# The shortest sequence measured at which the flash kernels beat the
# materialised softmax: one BERT-Large layer's attention (B=8, H=16, D=64,
# bf16, a ragged key-padding mask), forward and backward, on an NVIDIA H100
# 80GB HBM3 at 700 W, ``chip_smoke.py`` phase ``crossover``: flash 0.964 ms
# against 1.337 ms at T=128, and faster at 256, 512 and 1024 too (1.40x,
# 1.80x, 3.69x). Shorter sequences were not measured.
AUTO_MIN_SEQ = 128


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
