"""Wire framing for compressed payloads + the client-side compressor —
the port of ``byteps_tpu/compression/wire.py``, numpy as there, so a blob
is the JAX package's blob byte for byte.

The PS wire protocol frames every tensor as ``dtype-str | shape |
payload``.  A compressed payload rides the same outer frame with the
**versioned dtype tag** ``"bpsc1"`` — a decoder that predates this
subsystem fails loudly instead of misreading bytes, and a future format
bump ("bpsc2") is equally loud on an old peer.  The outer shape field
keeps the *original* tensor shape.

Blob layout (everything little-endian, inside the outer frame payload):

    u8 len(scheme)   | scheme name
    u8 len(dtype)    | original dtype name (numpy spelling)
    u32 len(ctx)     | scheme context  (scale / seed / k ...)
    u64 len(data)    | scheme data     (bits / int8 / idx+val ...)

One difference: numpy has no bfloat16 without ``ml_dtypes``, which the
port does not use, so a blob whose original dtype is ``bfloat16``
decodes to float32 holding the same values (bf16 widens exactly), and a
bf16 tensor to compress is a CPU ``torch.Tensor`` (its blob names
``bfloat16``, as JAX's does).

``WireCompressor`` is the client-side manager: it owns the per-tensor
error-feedback residuals and push counters.  The critical ordering:

  1. ``encode_mutation`` folds the residual in (``corrected = delta +
     e``), compresses ONCE, and returns the blob plus a *commit*
     closure holding the new residual.
  2. The caller sends the blob through the retry machinery — every
     retry resends the **same bytes** (seeded schemes replay the same
     coordinates; nothing is re-folded).
  3. Only after the version-guarded ack does the caller invoke
     ``commit()``, publishing ``e' = corrected - deq``.  A push that
     ultimately fails leaves the residual untouched, and a replayed
     PUSH that the server deduplicates still commits exactly once —
     the residual can never be double-folded.

The parameter-server client (engine/ps_server.py ``RemoteStore``)
compresses its PUSH / PUSH_PULL payloads through ``WireCompressor`` and
the shard cast-compresses its replies through ``maybe_compress_reply``.
"""

from __future__ import annotations

import struct
import threading
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from .registry import (REPLY_SAFE, CompressionPolicy, Scheme, derive_seed,
                       get_scheme)

WIRE_MAGIC = "bpsc"
WIRE_TAG = "bpsc1"  # current version; bump on any layout change


class WireBlob:
    """A compressed tensor ready for the wire: a frame codec sends it as
    the frame payload under the ``bpsc1`` dtype tag with the original
    ``shape`` in the frame header.

    The payload is held as a *list of buffers* (blob header / scheme
    data) so the scatter-gather send path never concatenates the scheme
    bytes into a second copy; ``data`` joins them lazily for one-shot
    consumers (tests, the serial client's ping path)."""

    __slots__ = ("shape", "_bufs", "raw_nbytes")

    def __init__(self, shape: Tuple[int, ...], data,
                 raw_nbytes: int = 0):
        self.shape = tuple(shape)
        if isinstance(data, (bytes, bytearray, memoryview)):
            self._bufs = [data]
        else:
            self._bufs = list(data)
        self.raw_nbytes = raw_nbytes

    def buffers(self) -> list:
        """The payload as buffers for ``sendmsg`` scatter-gather."""
        return list(self._bufs)

    @property
    def data(self) -> bytes:
        """The payload as one contiguous bytes (joined + cached)."""
        if len(self._bufs) != 1 or not isinstance(self._bufs[0], bytes):
            self._bufs = [b"".join(bytes(b) for b in self._bufs)]
        return self._bufs[0]

    @property
    def nbytes(self) -> int:
        return sum(memoryview(b).nbytes for b in self._bufs)


def _f32(arr) -> np.ndarray:
    """``arr`` as a float32 numpy array (a bf16 tensor widens exactly)."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().float().contiguous().numpy()
    return np.asarray(arr, np.float32)


def encode_blob(scheme: Scheme, arr, seed: int = 0,
                ratio: float = 0.01, with_deq: bool = True
                ) -> Tuple[WireBlob, Optional[np.ndarray]]:
    """Compress ``arr`` (a numpy array, or a bf16 CPU tensor) under
    ``scheme``; returns the wire blob and the dequantized value (fp32,
    arr's shape) the server will reconstruct — the EF residual is
    ``corrected - deq``.  Callers that don't need the residual (reply
    leg, unbiased push) pass ``with_deq=False`` and get ``None`` back,
    skipping a full decode of their own payload."""
    xf = np.ascontiguousarray(_f32(arr))
    ctx, data = scheme.wire_encode(xf, seed=seed, ratio=ratio)
    sname = scheme.name.encode()
    dtname = (b"bfloat16" if isinstance(arr, torch.Tensor)
              else np.dtype(arr.dtype).name.encode())
    # blob header and scheme data stay separate buffers: the wire layer
    # scatter-gathers them, so the (potentially large) data bytes are
    # never copied into a concatenation
    head = (struct.pack("<B", len(sname)) + sname
            + struct.pack("<B", len(dtname)) + dtname
            + struct.pack("<I", len(ctx)) + ctx
            + struct.pack("<Q", len(data)))
    deq = (scheme.wire_decode(ctx, data, xf.size).reshape(xf.shape)
           if with_deq else None)
    return WireBlob(tuple(arr.shape), [head, data], arr.nbytes), deq


def decode_blob(tag: str, payload: bytes, shape) -> np.ndarray:
    """Decode a ``bpsc*``-tagged frame payload back to a dense array in
    the original dtype (float32 for bfloat16).  Loud on version or
    framing mismatch."""
    if tag != WIRE_TAG:
        raise ValueError(
            f"unsupported compression wire tag {tag!r} (this peer speaks "
            f"{WIRE_TAG!r}) — upgrade the older end")
    off = 0

    def take(n: int) -> bytes:
        nonlocal off
        if off + n > len(payload):
            raise ValueError("truncated compressed payload")
        out = payload[off:off + n]
        off += n
        return out

    (slen,) = struct.unpack("<B", take(1))
    sname = take(slen).decode()
    (dlen,) = struct.unpack("<B", take(1))
    dtname = take(dlen).decode()
    (clen,) = struct.unpack("<I", take(4))
    ctx = take(clen)
    (plen,) = struct.unpack("<Q", take(8))
    data = take(plen)
    if off != len(payload):
        raise ValueError("trailing bytes in compressed payload")
    scheme = get_scheme(sname)
    n = int(np.prod(shape)) if shape else 1
    out = scheme.wire_decode(ctx, data, n).reshape(shape)
    if dtname == "bfloat16":
        return out.astype(np.float32)
    return out.astype(np.dtype(dtname))


def maybe_compress_reply(arr: Optional[np.ndarray], scheme_name: str,
                         min_bytes: int) -> Union[np.ndarray, WireBlob, None]:
    """Server-side reply leg: cast-compress a pull/push_pull reply when
    configured.  Only ``REPLY_SAFE`` (unbiased cast) schemes apply — a
    biased scheme on the global state would accumulate error with no
    error feedback to absorb it — anything else passes through raw."""
    if arr is None or not scheme_name or scheme_name == "none":
        return arr
    if isinstance(arr, torch.Tensor):
        # a bf16 store value: JAX's ``np.issubdtype(bfloat16, floating)``
        # is False, so its replies go raw, and so do these
        return arr
    if scheme_name not in REPLY_SAFE:
        return arr
    if arr.nbytes < min_bytes:
        return arr
    if not np.issubdtype(arr.dtype, np.floating):
        return arr
    blob, _ = encode_blob(get_scheme(scheme_name), arr, with_deq=False)
    return blob


class WireCompressor:
    """Per-client compression state: policy + EF residuals + counters.

    Thread-safety: the residual/counter maps are lock-guarded, but the
    subsystem inherits the wire tier's single-writer-per-key contract
    — two threads pushing the *same* tensor
    concurrently would race their residuals exactly as they would race
    the version guard.
    """

    def __init__(self, policy: CompressionPolicy, stats=None):
        self._policy = policy
        self._stats = stats
        self._lock = threading.Lock()
        self._residual: dict = {}     # wire name -> fp32 residual array
        self._count: dict = {}        # wire name -> committed push count

    @property
    def policy(self) -> CompressionPolicy:
        return self._policy

    def _observe(self, name: str, raw: int, wire: int) -> None:
        if self._stats is not None:
            self._stats.observe(name, raw, wire)

    def encode_mutation(
        self, name: str, arr: np.ndarray
    ) -> Tuple[Union[np.ndarray, WireBlob], Optional[Callable[[], None]]]:
        """Prepare one PUSH/PUSH_PULL payload.  Returns ``(payload,
        commit)``: payload is the raw array (policy pass-through) or a
        ``WireBlob``; ``commit`` publishes the EF residual and must be
        called exactly once, *after* the mutation is acknowledged."""
        nbytes = arr.nbytes
        scheme = self._policy.scheme_for(name, nbytes, arr.dtype)
        if scheme is None:
            self._observe(name, nbytes, nbytes)
            return arr, None
        if not scheme.biased:
            blob, _ = encode_blob(scheme, arr, ratio=self._policy.ratio,
                                  with_deq=False)
            self._observe(name, nbytes, blob.nbytes)
            return blob, None
        with self._lock:
            residual = self._residual.get(name)
            count = self._count.get(name, 0)
        corrected = _f32(arr)
        if residual is not None:
            corrected = corrected + residual
        seed = derive_seed(self._policy.seed, name, count)
        if isinstance(arr, torch.Tensor):   # corrected.astype(bfloat16)
            rounded = torch.from_numpy(np.ascontiguousarray(
                corrected)).to(arr.dtype)
        else:
            rounded = corrected.astype(arr.dtype, copy=False)
        blob, deq = encode_blob(scheme, rounded, seed=seed,
                                ratio=self._policy.ratio)
        pending = corrected - deq.astype(np.float32)

        def commit() -> None:
            with self._lock:
                self._residual[name] = pending
                self._count[name] = count + 1

        self._observe(name, nbytes, blob.nbytes)
        return blob, commit

    def residual_norm(self, name: str) -> float:
        """Test/debug hook: L2 norm of the committed residual."""
        with self._lock:
            r = self._residual.get(name)
        return 0.0 if r is None else float(np.linalg.norm(r))

    def residual_bytes(self, prefix: str = "") -> int:
        """Client-side error-feedback residual footprint in bytes,
        optionally restricted to wire names starting with ``prefix``.

        Residuals are keyed per wire name, so a client that only ever
        pushes the span keys it owns holds ~1/world of the replicated
        client's residual state."""
        with self._lock:
            return sum(int(r.nbytes) for n, r in self._residual.items()
                       if n.startswith(prefix))
