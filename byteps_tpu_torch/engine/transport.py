"""Endpoint helpers — the port's TCP subset of
``byteps_tpu/engine/transport.py``: :func:`free_port` and
:func:`maybe_nodelay` (the router tier, its autoscaler, the chaos
proxy), and what the parameter-server tier's shard and client use —
:func:`peer_label`, :func:`connection_kind`, :func:`parse_overrides`,
:func:`resolve_transport` and :func:`transport_connect`.

Only the TCP transport is served.  ``auto`` resolves to TCP (the port's
shards advertise no local rendezvous); the JAX module's Unix-socket and
shared-memory endpoints (``unix``, ``shm``, ``unix:/path``,
``shm:/path``: rendezvous paths, rings, ``LocalEndpoints``,
``ShmConnection``, ``RegisteredBufferPool``) are not ported, and
``resolve_transport`` refuses them through
``common/config.py:check_transport``.
"""

from __future__ import annotations

import socket
from typing import Dict, Optional, Tuple

__all__ = ["free_port", "maybe_nodelay", "peer_label", "connection_kind",
           "parse_overrides", "resolve_transport", "transport_connect"]


def free_port() -> int:
    """Grab an ephemeral loopback TCP port (bind-and-release).  The
    one implementation behind every test/bench/chaos harness that
    spawns endpoints on fresh ports."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def maybe_nodelay(sock) -> None:
    """TCP_NODELAY on a TCP socket (anything else is left alone)."""
    if getattr(sock, "family", None) in (socket.AF_INET, socket.AF_INET6):
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass


def peer_label(client_address) -> str:
    """Human label for a connection's peer (a TCP address tuple)."""
    if isinstance(client_address, tuple) and len(client_address) >= 2:
        return "%s:%s" % client_address[:2]
    return str(client_address) or "local"


def connection_kind(sock) -> str:
    """The transport a connection rides: always ``tcp`` in the port."""
    return "tcp"


def parse_overrides(spec: str) -> Dict[str, str]:
    """``BYTEPS_TRANSPORT_OVERRIDES`` = ``"host:port=spec,..."``; spec
    may itself contain ``:`` (``unix:/path``), so split on the LAST
    ``=``."""
    out: Dict[str, str] = {}
    for pair in (spec or "").split(","):
        pair = pair.strip()
        if not pair:
            continue
        addr, sep, tspec = pair.rpartition("=")
        if not sep or not addr:
            raise ValueError(
                f"bad BYTEPS_TRANSPORT_OVERRIDES entry {pair!r} "
                f"(want host:port=transport)")
        out[addr] = tspec.strip()
    return out


def resolve_transport(addr: str, spec: str) -> Tuple[str, Optional[str]]:
    """Map one ``host:port`` endpoint and transport spec to ``(kind,
    rendezvous_path)``: ``("tcp", None)`` for ``auto`` and ``tcp``;
    every local transport is refused by name."""
    from ..common.config import check_transport

    check_transport(spec)
    return "tcp", None


def transport_connect(kind: str, path: Optional[str], addr: str,
                      timeout: float = 30.0):
    """Open one connection to ``addr`` over a resolved transport.
    Failures raise ``OSError`` as a refused TCP connect does."""
    if kind != "tcp":
        raise ValueError(f"unknown transport kind {kind!r}")
    host, _, port_s = addr.rpartition(":")
    s = socket.create_connection((host, int(port_s)), timeout=timeout)
    maybe_nodelay(s)
    return s
