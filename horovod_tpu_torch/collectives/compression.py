"""Gradient compression: wire casts around the all-reduce.

Counterpart of ``horovod_tpu/collectives/compression.py`` (reference
``horovod/torch/compression.py``): ``compress`` casts a floating tensor to the
wire dtype before the collective, ``decompress`` casts it back. A tensor
already in the wire dtype is passed through untouched (``ctx=None``), so a
no-op cast costs nothing.
"""

from __future__ import annotations

import torch


class Compressor:
    """Interface: ``compress(tensor) -> (compressed, ctx)``;
    ``decompress(compressed, ctx) -> tensor``; ``wire_dtype_for(dtype)``,
    the dtype ``compress`` gives a tensor of ``dtype``."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError

    @staticmethod
    def wire_dtype_for(dtype: torch.dtype) -> torch.dtype:
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor

    @staticmethod
    def wire_dtype_for(dtype):
        return dtype


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype = torch.float16

    @classmethod
    def wire_dtype_for(cls, dtype):
        return cls.wire_dtype if dtype.is_floating_point else dtype

    @classmethod
    def compress(cls, tensor):
        if tensor.dtype.is_floating_point and tensor.dtype != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None  # not floating, or already at the wire dtype

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    wire_dtype = torch.bfloat16


class Compression:
    """Namespace matching ``hvd.Compression``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
