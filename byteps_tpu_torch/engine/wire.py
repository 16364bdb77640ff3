"""Frame codec — the port's byte-compatible copy of the framing in
``byteps_tpu/engine/wire.py:149-300`` (``_encode`` / ``_decode``), the
subset the serve frontend and its client speak.

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

import socket
import struct

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


def _encode(op: int, name: str, arr, raw: bytes = b"") -> bytes:
    """One frame: the header, then the array's bytes (or ``raw``)."""
    nb = name.encode()
    if arr is not None:
        arr = np.ascontiguousarray(arr)
        dt = np.dtype(arr.dtype).name.encode()
        shape = arr.shape
        payload = arr.tobytes()
    else:
        dt = b""
        shape = ()
        payload = raw
    head = struct.pack("<BI", op, len(nb)) + nb
    head += struct.pack("<I", len(dt)) + dt
    head += struct.pack("<B", len(shape)) + struct.pack(
        f"<{len(shape)}Q", *shape)
    head += struct.pack("<Q", len(payload))
    return head + payload


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
