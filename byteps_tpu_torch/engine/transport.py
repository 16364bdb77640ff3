"""Endpoint helpers — the port's subset of ``byteps_tpu/engine/transport.py``:
:func:`free_port` and :func:`maybe_nodelay`, which the router tier, its
autoscaler and the chaos proxy use.

Only the TCP transport is served.  The JAX module's Unix-socket and
shared-memory endpoints (their rendezvous paths, rings and resolution)
are not ported; ``common/config.py:check_transport`` refuses them.
"""

from __future__ import annotations

import socket

__all__ = ["free_port", "maybe_nodelay"]


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
