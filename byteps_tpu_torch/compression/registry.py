"""Compressor registry — the port of ``byteps_tpu/compression/registry.py``:
the scheme table of the wire-compression subsystem.

Two domains, as in the JAX package:

  * **roundtrip domain** — ``Scheme.roundtrip(x, seed=..., ratio=...)``
    is compress-then-decompress on a torch tensor, on whatever device it
    lies: the value the error-feedback transform
    (compression/error_feedback.py) hands on to the collective, so every
    worker contributes low-precision payloads.
  * **wire domain** — ``Scheme.wire_encode / wire_decode`` are the numpy
    codecs the PS tier speaks, copied line for line from the JAX
    package, so their bytes are the JAX package's bytes.

Schemes (fp32 baseline = 32 bits/element on the wire):

  ========  ============================  ~bits/elt  biased  seeded
  none      identity                      32         no      no
  bf16      bfloat16 cast                 16         no      no
  fp16      float16 cast                  16         no      no
  int8      absmax int8 + seeded dither    8         yes*    yes
  topk      top-|x| k=ratio*n (idx+val)   64*ratio   yes     no
  randomk   seeded random-k (val only)    32*ratio   yes     yes
  onebit    sign + mean-|x| scale          1         yes     no
  ========  ============================  ~bits/elt  biased  seeded

Where the port differs, and why:

  * A seeded roundtrip takes an integer ``seed`` where JAX takes a
    ``jax.random`` key: the draw is a ``torch.Generator`` on the tensor's
    device seeded with it, so the mask and the dither are not JAX's, but
    every rank drawing with the same seed draws the same ones.  The wire
    codecs seed numpy's Philox as JAX's do, so their bytes match.
  * Top-k keeps the k largest |x| with ties broken toward the lower
    index, as ``jax.lax.top_k`` does; ``torch.topk`` breaks ties
    otherwise, so the mask comes from a stable descending sort.
  * onebit's scale is the mean |x| summed in float64 and rounded once
    to float32, so it is within one ulp of the JAX package's float32 mean
    (within about one ulp of the exact mean, whatever order it sums in).
  * bfloat16 bytes come from torch's fp32 -> bf16 cast (round to nearest
    even, as ``ml_dtypes``'), so the port needs no ``ml_dtypes``.  A
    ``bfloat16`` dtype name is still recognized in policies and blobs.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["Scheme", "SCHEMES", "REPLY_SAFE", "derive_seed", "get_scheme",
           "register_scheme", "CompressionPolicy"]


def derive_seed(base: int, name: str, count: int) -> int:
    """Stable 63-bit seed from (base seed, tensor name, push counter).

    Uses blake2b, not ``hash()`` — must be identical across processes and
    runs (PYTHONHASHSEED-independent): the server regenerates random-k
    indices from this value, and chaos tests replay it bit-for-bit.
    """
    h = hashlib.blake2b(
        f"{base}:{name}:{count}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "little") & 0x7FFFFFFFFFFFFFFF


def _np_rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=seed))


def _torch_rng(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _resolve_k(n: int, ratio: float) -> int:
    return max(1, min(n, int(n * ratio)))


def _bf16_bytes(x: np.ndarray) -> bytes:
    """fp32 -> bfloat16 bytes, rounding to nearest even."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().tobytes()


def _bf16_values(data: bytes, n: int) -> np.ndarray:
    """bfloat16 bytes -> fp32 values (exact)."""
    raw = np.frombuffer(data, np.int16, count=n).copy()
    return torch.from_numpy(raw).view(torch.bfloat16).float().numpy()


def _is_float_dtype(dtype) -> bool:
    """Whether ``dtype`` (numpy, torch or a name) is a floating type —
    ``bfloat16`` by name too, with or without ``ml_dtypes`` loaded."""
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    try:
        dt = np.dtype(dtype)
    except TypeError:
        return str(dtype) == "bfloat16"
    return np.issubdtype(dt, np.floating) or dt.name == "bfloat16"


class Scheme:
    """One compression scheme; subclasses fill in both domains.

    Wire contract: ``wire_encode(x_f32, seed, ratio) -> (ctx, data)``
    byte strings; ``wire_decode(ctx, data, n) -> flat fp32 [n]``.  The
    decode side needs nothing but the two byte strings and the element
    count — every scheme is self-describing so the server (and a client
    reading a compressed reply) can decode without shared state.
    """

    name: str = ""
    biased: bool = False   # needs error feedback on the push path
    seeded: bool = False   # consumes a deterministic per-push seed

    # ------------------------------------------------------ roundtrip domain

    def roundtrip(self, x: torch.Tensor, *, seed: Optional[int] = None,
                  ratio: float = 0.01) -> torch.Tensor:
        """compress(decompress(x)) on a torch tensor, in ``x``'s dtype."""
        raise NotImplementedError

    # ----------------------------------------------------------- wire domain

    def wire_encode(self, x: np.ndarray, seed: int = 0,
                    ratio: float = 0.01) -> Tuple[bytes, bytes]:
        raise NotImplementedError

    def wire_decode(self, ctx: bytes, data: bytes, n: int) -> np.ndarray:
        raise NotImplementedError


class NoneScheme(Scheme):
    name = "none"

    def roundtrip(self, x, *, seed=None, ratio=0.01):
        return x

    def wire_encode(self, x, seed=0, ratio=0.01):
        return b"", np.ascontiguousarray(x, np.float32).tobytes()

    def wire_decode(self, ctx, data, n):
        return np.frombuffer(data, np.float32, count=n).copy()


class _CastScheme(Scheme):
    """fp16/bf16 — the reference's only implemented compressors."""

    torch_dtype: torch.dtype

    def roundtrip(self, x, *, seed=None, ratio=0.01):
        return x.to(self.torch_dtype).to(x.dtype)


class BF16Scheme(_CastScheme):
    name = "bf16"
    torch_dtype = torch.bfloat16

    def wire_encode(self, x, seed=0, ratio=0.01):
        return b"", _bf16_bytes(x)

    def wire_decode(self, ctx, data, n):
        return _bf16_values(data, n)


class FP16Scheme(_CastScheme):
    name = "fp16"
    torch_dtype = torch.float16

    def wire_encode(self, x, seed=0, ratio=0.01):
        return b"", np.ascontiguousarray(x).astype(np.float16).tobytes()

    def wire_decode(self, ctx, data, n):
        return np.frombuffer(data, np.float16, count=n).astype(np.float32)


class Int8Scheme(Scheme):
    """Symmetric absmax int8 with seeded uniform dither before rounding
    (unbiased in expectation) — ``ops/quantization.py``'s quantize /
    dequantize layout: int8 payload + one fp32 scale.
    ctx = scale fp32.  8 bits/element => 4x vs fp32.
    """

    name = "int8"
    biased = True
    seeded = True

    def roundtrip(self, x, *, seed=None, ratio=0.01):
        from ..ops.quantization import dequantize, quantize

        if seed is None:
            q, scale = quantize(x)
            return dequantize(q, scale, x.dtype)
        xf = x.float()
        absmax = xf.abs().max()
        scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
        u = torch.rand(x.shape, generator=_torch_rng(seed, x.device),
                       device=x.device) - 0.5
        q = torch.clamp(torch.round(xf / scale + u), -127, 127)
        return (q * scale).to(x.dtype)

    def wire_encode(self, x, seed=0, ratio=0.01):
        xf = np.ascontiguousarray(x, np.float32)
        absmax = float(np.max(np.abs(xf))) if xf.size else 0.0
        scale = absmax / 127.0 if absmax > 0 else 1.0
        u = _np_rng(seed).random(xf.shape, np.float32) - 0.5
        q = np.clip(np.round(xf / scale + u), -127, 127).astype(np.int8)
        return struct.pack("<f", scale), q.tobytes()

    def wire_decode(self, ctx, data, n):
        (scale,) = struct.unpack("<f", ctx)
        return np.frombuffer(data, np.int8, count=n).astype(
            np.float32) * scale


def _keep(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``flat`` where ``idx`` selects, 0 elsewhere (x * mask, as JAX)."""
    mask = torch.zeros_like(flat).index_fill_(0, idx, 1.0)
    return flat * mask


class TopKScheme(Scheme):
    """Deep-Gradient-Compression-style magnitude top-k: only the k
    largest-|x| coordinates travel (uint32 index + fp32 value).
    ctx = k u32.  ~64*ratio bits/element.
    """

    name = "topk"
    biased = True

    def roundtrip(self, x, *, seed=None, ratio=0.01):
        flat = x.float().reshape(-1)
        k = _resolve_k(flat.numel(), ratio)
        idx = torch.sort(flat.abs(), descending=True,
                         stable=True).indices[:k]
        return _keep(flat, idx).reshape(x.shape).to(x.dtype)

    def wire_encode(self, x, seed=0, ratio=0.01):
        xf = np.ascontiguousarray(x, np.float32).reshape(-1)
        k = _resolve_k(xf.size, ratio)
        idx = np.argpartition(np.abs(xf), xf.size - k)[-k:].astype(np.uint32)
        idx.sort()  # canonical order: replayed pushes must be bit-identical
        return (struct.pack("<I", k),
                idx.tobytes() + xf[idx].astype(np.float32).tobytes())

    def wire_decode(self, ctx, data, n):
        (k,) = struct.unpack("<I", ctx)
        idx = np.frombuffer(data, np.uint32, count=k)
        vals = np.frombuffer(data, np.float32, count=k, offset=4 * k)
        out = np.zeros(n, np.float32)
        out[idx] = vals
        return out


class RandomKScheme(Scheme):
    """Seeded random-k: k coordinates chosen by a stream keyed on the
    seed.  On the wire only the k *values* plus the 8-byte seed travel —
    the decoder regenerates the identical index set from numpy's Philox,
    so the wire cost is ~32*ratio bits/element (half of top-k) and a
    retried PUSH replays the exact same coordinates.
    ctx = seed u64 + k u32.
    """

    name = "randomk"
    biased = True
    seeded = True

    @staticmethod
    def _np_indices(seed: int, n: int, k: int) -> np.ndarray:
        # explicit permutation-prefix (not Generator.choice) so client and
        # server derive identical indices from the seed alone
        return _np_rng(seed).permutation(n)[:k].astype(np.int64)

    def roundtrip(self, x, *, seed=None, ratio=0.01):
        flat = x.float().reshape(-1)
        n = flat.numel()
        k = _resolve_k(n, ratio)
        idx = torch.randperm(n, generator=_torch_rng(seed or 0, x.device),
                             device=x.device)[:k]
        return _keep(flat, idx).reshape(x.shape).to(x.dtype)

    def wire_encode(self, x, seed=0, ratio=0.01):
        xf = np.ascontiguousarray(x, np.float32).reshape(-1)
        k = _resolve_k(xf.size, ratio)
        idx = self._np_indices(seed, xf.size, k)
        return (struct.pack("<QI", seed, k),
                xf[idx].astype(np.float32).tobytes())

    def wire_decode(self, ctx, data, n):
        seed, k = struct.unpack("<QI", ctx)
        idx = self._np_indices(seed, n, k)
        out = np.zeros(n, np.float32)
        out[idx] = np.frombuffer(data, np.float32, count=k)
        return out


class OneBitScheme(Scheme):
    """signSGD with a per-tensor mean-|x| scale: 1 bit/element plus one
    fp32 scalar (~32x vs fp32).  Convention: ``x >= 0`` maps to bit 1 /
    ``+scale`` in both domains.  ctx = scale fp32.
    """

    name = "onebit"
    biased = True

    def roundtrip(self, x, *, seed=None, ratio=0.01):
        xf = x.float()
        # summed in float64: the scale is the mean rounded once, within
        # half an ulp of the exact one (float32 means, JAX's among them,
        # land within about one ulp of it)
        scale = xf.abs().mean(dtype=torch.float64).float()
        return torch.where(xf >= 0, scale, -scale).to(x.dtype)

    def wire_encode(self, x, seed=0, ratio=0.01):
        xf = np.ascontiguousarray(x, np.float32).reshape(-1)
        scale = float(np.mean(np.abs(xf))) if xf.size else 0.0
        bits = np.packbits(xf >= 0)
        return struct.pack("<f", scale), bits.tobytes()

    def wire_decode(self, ctx, data, n):
        (scale,) = struct.unpack("<f", ctx)
        bits = np.unpackbits(np.frombuffer(data, np.uint8), count=n)
        return np.where(bits > 0, np.float32(scale), np.float32(-scale))


SCHEMES: Dict[str, Scheme] = {
    s.name: s
    for s in (NoneScheme(), BF16Scheme(), FP16Scheme(), Int8Scheme(),
              TopKScheme(), RandomKScheme(), OneBitScheme())
}

# cast-only schemes: safe for server replies (no error feedback on the
# server side, so biased schemes must never touch the pull/reply leg)
REPLY_SAFE = ("none", "bf16", "fp16")


def get_scheme(name: str) -> Scheme:
    try:
        return SCHEMES[name]
    except KeyError:
        raise KeyError(
            f"unknown compression scheme {name!r}; available: "
            f"{sorted(SCHEMES)}"
        ) from None


def register_scheme(scheme: Scheme) -> None:
    """Plug in a custom scheme (tests, experiments)."""
    if not scheme.name:
        raise ValueError("scheme needs a name")
    SCHEMES[scheme.name] = scheme


class CompressionPolicy:
    """Per-tensor scheme selection: default scheme + size threshold +
    per-name overrides (``BYTEPS_COMPRESSION_OVERRIDES`` —
    ``"substring=scheme,substring=scheme"``; first match wins, matched
    against the wire tensor name, so partition suffixes inherit their
    parent's override)."""

    def __init__(self, default: str = "", min_bytes: int = 1024,
                 overrides: str = "", ratio: float = 0.01, seed: int = 0):
        self.default = default or "none"
        self.min_bytes = min_bytes
        self.ratio = ratio
        self.seed = seed
        self.overrides = []
        for entry in (overrides or "").split(","):
            entry = entry.strip()
            if not entry:
                continue
            if "=" not in entry:
                raise ValueError(
                    f"bad BYTEPS_COMPRESSION_OVERRIDES entry {entry!r} "
                    "(want substring=scheme)")
            pat, scheme = entry.split("=", 1)
            get_scheme(scheme.strip())  # fail fast on unknown schemes
            self.overrides.append((pat.strip(), scheme.strip()))
        get_scheme(self.default)

    @classmethod
    def from_config(cls, cfg) -> "CompressionPolicy":
        return cls(default=cfg.compression,
                   min_bytes=cfg.compression_min_bytes,
                   overrides=cfg.compression_overrides,
                   ratio=cfg.compression_ratio,
                   seed=cfg.compression_seed)

    def scheme_name_for(self, name: str) -> str:
        for pat, scheme in self.overrides:
            if pat in name:
                return scheme
        return self.default

    def scheme_for(self, name: str, nbytes: int,
                   dtype) -> Optional[Scheme]:
        """The scheme to put ``name`` on the wire with, or None for the
        raw pass-through (scheme "none", sub-threshold tensors, or
        non-float payloads — int tensors don't quantize meaningfully)."""
        sname = self.scheme_name_for(name)
        if sname == "none":
            return None
        if nbytes < self.min_bytes:
            return None
        if not _is_float_dtype(dtype):
            return None
        return get_scheme(sname)
