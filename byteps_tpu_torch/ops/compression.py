"""Gradient wire compression — the port of ``byteps_tpu/ops/compression.py``
(counterpart of reference ``byteps/torch/compression.py``): a pluggable
``Compressor`` with ``compress``/``decompress`` and a ``Compression``
namespace exposing ``none``, ``fp16`` and ``bf16``, as torch casts.

The casts ride the collectives' ``wire_dtype``: the payload is cast for
the wire and the sum, and cast back after.  The full registry (onebit /
topk / randomk / int8, ``byteps_tpu_torch/compression``) is bridged in
by ``Compression.resolve``, so every ``compression=`` entry point takes
either spelling.
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


_registry_adapters: dict = {}


def _registry_adapter(scheme):
    """Wrap a registry Scheme as a stateless Compressor: ``compress`` is
    the scheme's compress-then-decompress roundtrip (the value that would
    reach the far side of the wire), ``decompress`` the identity.  No
    error feedback — this is the api.push_pull one-shot path; training
    loops get EF through DistributedOptimizer / error_feedback_compress.
    Seeded schemes draw from ``BYTEPS_COMPRESSION_SEED`` (fixed per call
    site — deterministic)."""
    cached = _registry_adapters.get(scheme.name)
    if cached is not None:
        return cached

    class RegistryCompressor(Compressor):
        wire_dtype = None

        @staticmethod
        def compress(tensor):
            from ..common.config import get_config

            cfg = get_config()
            seed = cfg.compression_seed if scheme.seeded else None
            return scheme.roundtrip(tensor, seed=seed,
                                    ratio=cfg.compression_ratio), None

        @staticmethod
        def decompress(tensor, ctx):
            return tensor

    RegistryCompressor.__name__ = f"{scheme.name.capitalize()}Compressor"
    RegistryCompressor.scheme = scheme
    _registry_adapters[scheme.name] = RegistryCompressor
    return RegistryCompressor


class Compression:
    """Optional gradient compression used during push_pull (reference
    compression.py:69-75)."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor

    @classmethod
    def resolve(cls, spec):
        """A Compressor class (reference spelling), a registry scheme
        name (``"bf16"``, ``"onebit"``, ``"topk"``, ...), or None.  An
        unknown name raises ``KeyError`` listing the schemes."""
        if spec is None:
            return cls.none
        if isinstance(spec, str):
            if spec in ("none", "fp16", "bf16"):
                return getattr(cls, spec)
            from ..compression import get_scheme

            return _registry_adapter(get_scheme(spec))
        if isinstance(spec, type) and issubclass(spec, Compressor):
            return spec
        raise TypeError(f"compression={spec!r}: a Compressor class or a "
                        f"registry scheme name")
