"""Frame codec — the port's byte-compatible copy of the framing in
``byteps_tpu/engine/wire.py:124-300`` (``_encode`` / ``_decode``, the
scatter-gather ``_encode_buffers`` / ``_send_buffers`` and
``hard_reset``), the subset the serve frontend, its client and the
disaggregated KV ship speak.

Frame layout (little-endian)::

    u8 op | u32 name_len | [ext: u8 version, u8 len, body] | name
    | u32 dtype_len | dtype name | u8 ndim | ndim x u64 shape
    | u64 payload_len | payload

A frame whose op byte has bit 0x80 set carries the versioned header
extension (version 1: an 8-byte trace id).  This codec reads it (and
drops the id) so frames from a tracing JAX peer decode; it never writes
it.  Compressed payloads (the ``bpsc`` dtype tag of the gradient wire)
belong to the parameter-server tier and are refused here.
"""

from __future__ import annotations

import os
import socket
import struct
from typing import List, Sequence

import numpy as np

_MAX_NAME = 1 << 16
_MAX_PAYLOAD = 1 << 34  # 16 GiB sanity bound
_EXT_FLAG = 0x80
_EXT_VERSION = 1
_TRACE_ID_LEN = 8
_COMPRESSED_MAGIC = "bpsc"


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Read exactly ``n`` bytes into one preallocated buffer."""
    buf = bytearray(n)
    if n:
        view = memoryview(buf)
        got = 0
        while got < n:
            r = sock.recv_into(view[got:])
            if r == 0:
                raise ConnectionError("peer closed mid-message")
            got += r
    return buf


def hard_reset(sock: socket.socket) -> None:
    """Close with an RST (SO_LINGER 0), not a FIN: the peer sees
    ECONNRESET mid-RPC, the way a crashed process looks
    (``ServeFrontend.kill``)."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _payload_view(arr):
    """Zero-copy byte view of a contiguous CPU ``torch.Tensor`` or numpy
    array: what a frame's payload slot hands to ``sendmsg`` instead of a
    ``tobytes()`` copy.  A tensor is reinterpreted as ``uint8``
    (``tensor.view(torch.uint8)``, bf16 included) and handed out as the
    numpy array sharing its memory."""
    if hasattr(arr, "numpy"):   # a torch tensor
        import torch

        if arr.numel() == 0:
            return b""
        return arr.reshape(-1).view(torch.uint8).numpy()
    if arr.size == 0:
        return b""
    return arr.reshape(-1).view(np.uint8)


def _encode_buffers(op: int, name: str, arr, raw: bytes = b"") -> List:
    """One frame as a buffer list for scatter-gather send: ``[header,
    payload...]``, the payload a zero-copy view of the array (or
    ``raw``).  ``b"".join`` of the result is byte-identical to
    :func:`_encode`."""
    nb = name.encode()
    if arr is not None:
        arr = np.ascontiguousarray(arr)
        dt = np.dtype(arr.dtype).name.encode()
        shape = arr.shape
        view = _payload_view(arr)
        payload_bufs: Sequence = (view,) if len(view) else ()
        plen = arr.nbytes
    else:
        dt = b""
        shape = ()
        payload_bufs = (raw,) if len(raw) else ()
        plen = len(raw)
    head = struct.pack("<BI", op, len(nb)) + nb
    head += struct.pack("<I", len(dt)) + dt
    head += struct.pack("<B", len(shape)) + struct.pack(
        f"<{len(shape)}Q", *shape)
    head += struct.pack("<Q", plen)
    return [head, *payload_bufs]


def _encode(op: int, name: str, arr, raw: bytes = b"") -> bytes:
    """One frame: the header, then the array's bytes (or ``raw``) — the
    join of :func:`_encode_buffers`."""
    return b"".join(bytes(b) if not isinstance(b, bytes) else b
                    for b in _encode_buffers(op, name, arr, raw))


# sendmsg refuses iovecs longer than IOV_MAX (1024 on Linux) with
# EMSGSIZE; the sender caps each call there
try:
    _IOV_MAX = min(1024, os.sysconf("SC_IOV_MAX"))
except (AttributeError, OSError, ValueError):  # pragma: no cover
    _IOV_MAX = 1024


def _send_buffers(sock: socket.socket, buffers: Sequence) -> None:
    """``sendall`` a buffer list with ``sendmsg`` scatter-gather (no
    user-space join), across partial sends and at most ``IOV_MAX``
    buffers a call."""
    views = [memoryview(b).cast("B") for b in buffers if len(b)]
    while views:
        sent = sock.sendmsg(views[:_IOV_MAX])
        while views and sent >= len(views[0]):
            sent -= len(views[0])
            views.pop(0)
        if sent and views:
            views[0] = views[0][sent:]


def _decode(sock: socket.socket):
    """Read one frame: ``(op, name, arr, payload)``."""
    op, nlen = struct.unpack("<BI", _recv_exact(sock, 5))
    if nlen > _MAX_NAME:
        raise ValueError(f"name too long: {nlen}")
    if op & _EXT_FLAG:
        ver, elen = struct.unpack("<BB", _recv_exact(sock, 2))
        _recv_exact(sock, elen)
        if ver != _EXT_VERSION:
            raise ValueError(f"unknown wire header extension version "
                             f"{ver} (peer newer than this build?)")
        op &= ~_EXT_FLAG
    name = _recv_exact(sock, nlen).decode()
    (dlen,) = struct.unpack("<I", _recv_exact(sock, 4))
    dt = _recv_exact(sock, dlen).decode()
    (ndim,) = struct.unpack("<B", _recv_exact(sock, 1))
    shape = (struct.unpack(f"<{ndim}Q", _recv_exact(sock, 8 * ndim))
             if ndim else ())
    (plen,) = struct.unpack("<Q", _recv_exact(sock, 8))
    if plen > _MAX_PAYLOAD:
        raise ValueError(f"payload too large: {plen}")
    payload = _recv_exact(sock, plen) if plen else b""
    arr = None
    if dt:
        if dt.startswith(_COMPRESSED_MAGIC):
            raise ValueError(f"compressed wire payload {dt!r} is not "
                             f"supported by the serve frontend")
        arr = np.frombuffer(payload, dtype=np.dtype(dt)).reshape(shape)
    return op, name, arr, payload
