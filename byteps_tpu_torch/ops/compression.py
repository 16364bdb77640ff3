"""Gradient wire compression — the port of ``byteps_tpu/ops/compression.py``
(counterpart of reference ``byteps/torch/compression.py``): a pluggable
``Compressor`` with ``compress``/``decompress`` and a ``Compression``
namespace exposing ``none``, ``fp16`` and ``bf16``, as torch casts.

The casts ride the collectives' ``wire_dtype``: the payload is cast for
the wire and the sum, and cast back after.  The JAX package's registry
schemes (onebit, topk, randomk, int8 with error feedback) are the port's
compression slice; a registry name other than ``none``/``fp16``/``bf16``
is refused (queue A item 9).
"""

from __future__ import annotations

import torch

__all__ = ["Compressor", "NoneCompressor", "FP16Compressor",
           "BF16Compressor", "Compression"]


class Compressor:
    """Interface for compressing and decompressing a given tensor
    (reference compression.py:21-34)."""

    wire_dtype = None  # dtype the collective path casts to

    @staticmethod
    def compress(tensor):
        """Returns (compressed_tensor, context) needed to decompress it."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Default no-op (reference compression.py:37-47)."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    @classmethod
    def compress(cls, tensor):
        dtype = tensor.dtype
        if tensor.is_floating_point():
            return tensor.to(cls.wire_dtype), dtype
        return tensor, dtype

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class FP16Compressor(_CastCompressor):
    """Cast to fp16 on the wire, restore dtype after (reference
    compression.py:50-66)."""

    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """bfloat16 wire format (float32's exponent range, no overflow
    scaling)."""

    wire_dtype = torch.bfloat16


class Compression:
    """Optional gradient compression used during push_pull (reference
    compression.py:69-75)."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor

    @classmethod
    def resolve(cls, spec):
        """A Compressor class (reference spelling), ``"none"``,
        ``"fp16"``, ``"bf16"`` or None.  A registry scheme name is
        refused."""
        if spec is None:
            return cls.none
        if isinstance(spec, str):
            if spec in ("none", "fp16", "bf16"):
                return getattr(cls, spec)
            raise NotImplementedError(
                f"compression={spec!r}: the compression registry (onebit, "
                f"topk, randomk, int8, error feedback) belongs to the port's "
                f"compression slice (queue A item 9); 'none', 'fp16' and "
                f"'bf16' are ported")
        if isinstance(spec, type) and issubclass(spec, Compressor):
            return spec
        raise TypeError(f"compression={spec!r}: a Compressor class or one "
                        f"of 'none', 'fp16', 'bf16'")
