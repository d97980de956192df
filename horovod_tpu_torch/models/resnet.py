"""ResNet family — the headline data-parallel workload.

Counterpart of ``horovod_tpu/models/resnet.py`` (upstream Horovod's
``examples/pytorch/pytorch_imagenet_resnet50.py``): f32 parameters with
compute in ``dtype`` (bf16 by default), cast at use as ``models/llama.py``
does; BatchNorm with flax's statistics, momentum 0.9 and eps 1e-5, synced
across ranks when ``sync_batch_norm`` (:class:`~horovod_tpu_torch.optimizer.
sync_batch_norm.SyncBatchNorm`); each block's last BN scale starting at
zero; an f32 Dense head over the mean pool.

The model takes NHWC images, as the JAX model does, and computes in NCHW
views. On the card they are views of channels_last memory (``permute(0, 3,
1, 2)`` of an NHWC tensor already is), so cuDNN runs its NHWC kernels. On
the CPU they are made contiguous: torch's CPU backward of a strided 1x1 conv
over a channels_last input corrupts the heap.

Places where a port of the JAX model goes wrong, kept as it computes:

- "SAME" padding is ``lax.padtype_to_pads``'s, ``lo = total // 2``, which
  is asymmetric, ``(0, 1)``, for every stride-2 3x3 conv and for the 3x3
  stride-2 max-pool (padded with -inf). torch's ``padding=1`` would shift
  those windows by a pixel, so :class:`Conv` and :func:`max_pool_same` pad
  explicitly, from the input's size.
- The space-to-depth stem orders its channels ``(dy * 2 + dx) * c + ch``
  (``F.pixel_unshuffle`` would give ``ch * 4 + dy * 2 + dx``): the input is
  reordered exactly as the JAX model reorders it, so the converted kernel
  needs no permutation. Its padding is ``(1, 2)`` on both axes.
- ``jnp.mean`` of a bf16 tensor sums in f32 and returns bf16; the f32 head
  takes that rounded pool.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..optimizer.sync_batch_norm import SyncBatchNorm
from .llama import _default_device, _lecun_normal_


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """``lax.padtype_to_pads`` for "SAME": the output is ``ceil(size /
    s)``, the total padding split with the smaller half first."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _layout(x: torch.Tensor) -> torch.memory_format:
    """channels_last on the card, the plain layout on the CPU (module
    doc)."""
    return torch.channels_last if x.is_cuda else torch.contiguous_format


class Conv(nn.Module):
    """Bias-free ``nn.Conv(dtype=...)``: input and OIHW weight cast to the
    compute dtype, in the device's layout (:func:`_layout`). ``padding`` is
    "SAME" (flax's, computed from the input's size) or ``((top, bottom),
    (left, right))``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding="SAME", *, dtype: torch.dtype, device):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel,
                                               device=device))

    def forward(self, x):
        k, s = self.weight.shape[-1], self.stride
        if self.padding == "SAME":
            (t, b), (l, r) = (_same_pads(x.shape[2], k, s),
                              _same_pads(x.shape[3], k, s))
        else:
            (t, b), (l, r) = self.padding
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype, memory_format=_layout(x))
        if t == b and l == r:
            return F.conv2d(x, w, stride=s, padding=(t, l))
        x = F.pad(x, (l, r, t, b)).contiguous(memory_format=_layout(x))
        return F.conv2d(x, w, stride=s)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), (s, s), padding="SAME")``: -inf padding,
    split as :func:`_same_pads` splits it."""
    (t, b), (l, r) = _same_pads(x.shape[2], k, s), _same_pads(x.shape[3], k,
                                                              s)
    x = F.pad(x, (l, r, t, b), value=-math.inf).contiguous(
        memory_format=_layout(x))
    return F.max_pool2d(x, k, s)


class ResNetBlock(nn.Module):
    """Basic 3x3 + 3x3 block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int, norm,
                 dtype: torch.dtype, device):
        super().__init__()
        conv = functools.partial(Conv, dtype=dtype, device=device)
        self.conv1, self.bn1 = conv(in_ch, filters, 3, stride), norm(filters)
        self.conv2 = conv(filters, filters, 3)
        self.bn2 = norm(filters, scale_init=0.0)
        self.conv_proj = self.norm_proj = None
        if in_ch != filters or stride != 1:
            self.conv_proj = conv(in_ch, filters, 1, stride)
            self.norm_proj = norm(filters)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.conv_proj is not None:
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class BottleneckResNetBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int, norm,
                 dtype: torch.dtype, device):
        super().__init__()
        conv = functools.partial(Conv, dtype=dtype, device=device)
        self.conv1, self.bn1 = conv(in_ch, filters, 1), norm(filters)
        self.conv2, self.bn2 = conv(filters, filters, 3, stride), norm(filters)
        self.conv3 = conv(filters, filters * 4, 1)
        self.bn3 = norm(filters * 4, scale_init=0.0)
        self.conv_proj = self.norm_proj = None
        if in_ch != filters * 4 or stride != 1:
            self.conv_proj = conv(in_ch, filters * 4, 1, stride)
            self.norm_proj = norm(filters * 4)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.conv_proj is not None:
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


def _recompute_context(block: nn.Module):
    """``checkpoint``'s ``context_fn``: nothing around the first forward;
    the running statistics frozen while backward recomputes it."""

    @contextlib.contextmanager
    def frozen():
        norms = [m for m in block.modules() if isinstance(m, SyncBatchNorm)]
        for m in norms:
            m.update_stats = False
        try:
            yield
        finally:
            for m in norms:
                m.update_stats = True

    return contextlib.nullcontext(), frozen()


class ResNet(nn.Module):
    """NHWC ResNet: ``images [N, H, W, 3]`` -> f32 logits ``[N,
    num_classes]``. ``sync_batch_norm`` syncs the BatchNorm statistics across
    the ranks (the JAX model's ``axis_name``); False keeps them local.
    ``stem`` is "conv7" (7x7, stride 2) or "space_to_depth" (a 2x2 fold
    into channels, then 4x4, stride 1); ``small_images`` replaces
    either with one 3x3 conv and drops the max-pool. ``remat_blocks``
    recomputes each block in backward (``torch.utils.checkpoint``).
    Parameters are made on ``device`` (the context's device, else "cuda")
    from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, width: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 sync_batch_norm: bool = False, small_images: bool = False,
                 stem: str = "conv7", remat_blocks: bool = False, *,
                 device=None, seed: int = 0):
        super().__init__()
        if stem not in ("conv7", "space_to_depth"):
            raise ValueError(f"unknown stem {stem!r}")
        device = _default_device(device)
        self.dtype = dtype
        self.small_images, self.stem = small_images, stem
        self.remat_blocks = remat_blocks
        conv = functools.partial(Conv, dtype=dtype, device=device)
        norm = functools.partial(SyncBatchNorm, momentum=0.9, eps=1e-5,
                                 dtype=dtype, sync=sync_batch_norm,
                                 device=device)
        if small_images:
            self.conv_init = conv(3, width, 3)
        elif stem == "space_to_depth":
            self.conv_init = conv(12, width, 4, 1, ((1, 2), (1, 2)))
        else:
            self.conv_init = conv(3, width, 7, 2, ((3, 3), (3, 3)))
        self.bn_init = norm(width)
        blocks, ch = [], width
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(ch, width * 2 ** i, stride, norm,
                                        dtype, device))
                ch = width * 2 ** i * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(ch, num_classes, device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, Conv):
                    _lecun_normal_(mod.weight, gen)
            _lecun_normal_(self.head.weight, gen)
            self.head.bias.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.dtype)
        if self.stem == "space_to_depth" and not self.small_images:
            n, h, w, c = x.shape
            x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)
        x = x.permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=_layout(x))
        x = F.relu(self.bn_init(self.conv_init(x)))
        if not self.small_images:
            x = max_pool_same(x)
        for block in self.blocks:
            if self.remat_blocks and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False,
                               context_fn=functools.partial(
                                   _recompute_context, block))
            else:
                x = block(x)
        pooled = x.float().mean(dim=(2, 3)).to(self.dtype)
        return F.linear(pooled.float(), self.head.weight, self.head.bias)


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=ResNetBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=ResNetBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckResNetBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckResNetBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3],
                              block_cls=BottleneckResNetBlock)
# The JAX package's tiny configuration for CPU tests, not a reference model.
ResNetTiny = functools.partial(ResNet, stage_sizes=[1, 1],
                               block_cls=ResNetBlock, width=8,
                               small_images=True)
