"""The port's resilience pieces (``byteps_tpu_torch/resilience``,
``common/context.ServerSharder``), held against the JAX package's on the
same scripted inputs.

* ``ServerSharder``: placements, per-shard byte counts and the
  degraded-mode remap over a key sweep, with and without hash mode.
* ``DegradedModeRouter``: the same down/up/grow script routes the same
  way, with the same failover ledger.
* ``RetryPolicy``: backoffs under one seeded generator, attempt budgets
  against deadlines, the sleep.
* ``FailureDetector``: the same scripted pings (fed through
  ``report_failure`` / ``report_success`` and through the heartbeat
  loop) fire the same down/up transitions and counter totals.
* ``FaultInjectingProxy`` at rate 0 relays every request and reply
  frame byte for byte, a stream's frame sequence included; its frame
  reader agrees with JAX's; a ``cut_stream`` fault cuts after exactly k
  frames in both.
"""

import random
import socket
import struct
import threading
import time

import numpy as np
import pytest

from byteps_tpu.common.context import ServerSharder as JaxSharder
from byteps_tpu.resilience import DegradedModeRouter as JaxDegraded
from byteps_tpu.resilience import FailureDetector as JaxDetector
from byteps_tpu.resilience import FaultInjectingProxy as JaxProxy
from byteps_tpu.resilience import ResilienceCounters as JaxCounters
from byteps_tpu.resilience import RetryPolicy as JaxRetry
from byteps_tpu.resilience import chaos as jax_chaos
from byteps_tpu_torch.common.context import ServerSharder
from byteps_tpu_torch.engine.wire import _encode
from byteps_tpu_torch.resilience import (DegradedModeRouter,
                                         FailureDetector,
                                         FaultInjectingProxy,
                                         ResilienceCounters, RetryPolicy)
from byteps_tpu_torch.resilience import chaos
from byteps_tpu_torch.resilience import counters as cn

KEYS = ([0, 1, 2, 65535, 65536, 65537, (7 << 16) | 3, (1 << 31) + 5]
        + [int(k) for k in np.random.RandomState(3).randint(
            0, 1 << 40, size=64, dtype=np.int64)])


# ------------------------------------------------------------- sharding


@pytest.mark.parametrize("use_hash", [False, True])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_server_sharder_matches_jax(use_hash, n):
    mine, ref = ServerSharder(n, use_hash), JaxSharder(n, use_hash)
    for i, k in enumerate(KEYS + KEYS[:5]):   # repeats hit the cache
        assert mine.place(k, nbytes=i * 4) == ref.place(k, nbytes=i * 4)
    assert mine.load() == ref.load()
    for down in ([], [0], list(range(n - 1)), [n - 1]):
        if len(down) >= n:
            continue
        for s in range(n):
            assert (ServerSharder.remap(s, set(down), n)
                    == JaxSharder.remap(s, set(down), n))
    with pytest.raises(RuntimeError, match="all PS shards"):
        ServerSharder.remap(0, set(range(n)), n)
    with pytest.raises(ValueError):
        ServerSharder(0)


def _route_script(router):
    out = []
    for op, arg in (("down", 1), ("down", 1), ("down", 2), ("down", 0),
                    ("grow", 2), ("down", 0), ("up", 1), ("up", 3),
                    ("down", 4), ("up", 2)):
        if op == "down":
            out.append(("down", arg, router.mark_down(arg)))
        elif op == "up":
            out.append(("up", arg, router.mark_up(arg)))
        else:
            out.append(("grow", router.grow(arg)))
        out.append(tuple(router.route(p) for p in range(router.num_shards)))
        out.append((router.is_degraded(), tuple(router.down_shards())))
    router.note_failover("w0", 1, 2)
    router.note_failover("w1", 1, 3)
    router.note_failover("w2", 0, 2)
    out.append((router.fallback_for("w1"), router.fallback_for("nope"),
                sorted(router.failed_over_names(1))))
    router.clear_failover("w1")
    out.append(sorted(router.failed_over_names(1)))
    return out


def test_degraded_mode_router_matches_jax():
    got = _route_script(DegradedModeRouter(3, counters=ResilienceCounters()))
    want = _route_script(JaxDegraded(3, counters=JaxCounters()))
    assert got == want
    with pytest.raises(ValueError):
        DegradedModeRouter(0)


# ---------------------------------------------------------------- retry


def test_retry_policy_budgets_match_jax():
    kw = dict(max_attempts=5, backoff_base=0.05, backoff_mult=2.0,
              backoff_cap=0.3, jitter=0.25, deadline=2.0)
    mine, ref = RetryPolicy(**kw), JaxRetry(**kw)
    ra, rb = random.Random(11), random.Random(11)
    for a in range(0, 9):
        assert mine.backoff(a, ra) == ref.backoff(a, rb)
    no_jit = dict(kw, jitter=0.0)
    for a in range(0, 8):
        assert (RetryPolicy(**no_jit).backoff(a)
                == JaxRetry(**no_jit).backoff(a))
    # attempt budgets: the no-jitter policy (jitter draws from the
    # global generator inside should_retry)
    mine, ref = RetryPolicy(**no_jit), JaxRetry(**no_jit)
    now = time.monotonic()
    for a in range(0, 7):
        for d in (now - 1.0, now + 0.06, now + 0.2, now + 100.0):
            assert mine.should_retry(a, d) == ref.should_retry(a, d)
    assert RetryPolicy(deadline=0).start() == JaxRetry(deadline=0).start()
    slept = RetryPolicy(**no_jit).sleep(2)
    assert slept == JaxRetry(**no_jit).backoff(2) == 0.05


# ------------------------------------------------------------- detector

PINGS = [(0, False), (1, False), (0, False), (0, False), (1, True),
         (0, True), (2, False), (2, False), (2, False), (2, False),
         (1, False), (1, False), (1, False), (2, True), (1, True),
         (0, False)]


def _detector_script(cls, counters):
    events = []
    det = cls(3, lambda s: True, miss_threshold=3,
              on_down=lambda s: events.append(("down", s)),
              on_up=lambda s: events.append(("up", s)),
              counters=counters)
    for shard, ok in PINGS:
        (det.report_success if ok else det.report_failure)(shard)
        events.append(tuple(det.down_shards()))
    det.mark_down(0)
    events.append((det.is_up(0), det.grow(2), tuple(det.down_shards())))
    det.report_failure(4)
    det.report_success(0)
    events.append(tuple(det.down_shards()))
    return events, counters.snapshot()


def test_failure_detector_transitions_match_jax():
    got = _detector_script(FailureDetector, ResilienceCounters())
    want = _detector_script(JaxDetector, JaxCounters())
    assert got == want
    # mark_down fires nothing; the success after it fires the 4th up
    assert got[1][cn.SHARD_DOWN] == 3 and got[1][cn.SHARD_UP] == 4


def _heartbeat_run(cls, counters):
    """The detector's own loop over a scripted ping table (shard ->
    answers in order): the transitions it fires, in order."""
    script = {0: [False] * 4 + [True] * 50, 1: [True] * 54}
    events = []
    done = threading.Event()

    def ping(s):
        seq = script[s]
        ok = seq.pop(0) if seq else True
        if s == 1 and not script[1]:
            done.set()
        return ok

    det = cls(2, ping, interval=0.01, miss_threshold=3,
              on_down=lambda s: events.append(("down", s)),
              on_up=lambda s: events.append(("up", s)),
              counters=counters).start()
    assert det.running
    assert done.wait(10.0)
    det.stop()
    return events, counters.snapshot()


def test_failure_detector_heartbeat_loop_matches_jax():
    got = _heartbeat_run(FailureDetector, ResilienceCounters())
    want = _heartbeat_run(JaxDetector, JaxCounters())
    assert got == want == ([("down", 0), ("up", 0)],
                           {cn.HEARTBEAT_MISS: 4, cn.SHARD_DOWN: 1,
                            cn.SHARD_UP: 1})


def test_resilience_counters_registry_and_reset():
    c = ResilienceCounters()
    assert c.bump(cn.RETRY, shard=2) == 1
    assert c.bump(cn.RETRY, 4) == 5
    assert c.get(cn.RETRY) == 5 and c.get("never") == 0
    assert c.snapshot() == {cn.RETRY: 5}
    assert c.registry.snapshot()["counters"] == {cn.RETRY: 5}
    g = cn.get_counters()
    g.bump(cn.FAILOVER)
    assert cn.get_counters().get(cn.FAILOVER) >= 1
    cn.reset_counters()
    assert cn.get_counters().get(cn.FAILOVER) == 0


# ------------------------------------------------------------ the proxy


def _frames():
    """Request and reply frames as both wires write them: plain, with a
    payload, with the versioned trace-id extension, and a stream's
    token frames ending in ``end`` (op 3 = STREAM)."""
    ext = bytearray(_encode(0, "tok", np.asarray([5], np.int32)))
    ext[0] |= 0x80
    # u8 op | u32 name_len | u8 ver | u8 len | 8-byte trace id | ...
    ext = bytes(ext[:5]) + struct.pack("<BB", 1, 8) + b"T" * 8 + bytes(
        ext[5:])
    reqs = [_encode(2, "", None),
            _encode(0, '{"max_new_tokens": 3}',
                    np.arange(7, dtype=np.int32)),
            _encode(3, '{"max_new_tokens": 3}', np.arange(5,
                                                          dtype=np.int32)),
            _encode(1, "", None)]
    replies = [[_encode(0, "", None)],
               [_encode(0, "rid", np.asarray([1, 2, 3], np.int32))],
               [ext, _encode(0, "t", np.asarray([6], np.int32)),
                _encode(0, "end", np.asarray([5, 6], np.int32))],
               [_encode(0, "", None, b'{"k": 1}')]]
    return reqs, replies


class _RecordingServer:
    """A TCP server answering request i with ``replies[i]`` (a frame
    sequence) and recording the exact request bytes it received."""

    def __init__(self, replies):
        self.replies = list(replies)
        self.got = []
        self._lst = socket.socket()
        self._lst.bind(("127.0.0.1", 0))
        self._lst.listen(4)
        self.addr = "127.0.0.1:%d" % self._lst.getsockname()[1]
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        conn, _ = self._lst.accept()
        with conn:
            for seq in self.replies:
                try:
                    self.got.append(jax_chaos._read_frame(conn))
                except (ConnectionError, OSError):
                    return
                for f in seq:
                    conn.sendall(f)

    def close(self):
        self._lst.close()


def test_fault_injecting_proxy_relays_frames_byte_for_byte():
    reqs, replies = _frames()
    for f in reqs + [f for seq in replies for f in seq]:
        got = chaos._read_frame(_feed(f))
        assert got == jax_chaos._read_frame(_feed(f)) == f
        assert chaos._frame_meta(f) == jax_chaos._frame_meta(f)
    srv = _RecordingServer(replies)
    proxy = FaultInjectingProxy(srv.addr, serve_stream_op=3)
    proxy.set_rates(0.0, 0.0, 0.0, 0.0)
    try:
        host, _, port = proxy.addr.rpartition(":")
        with socket.create_connection((host, int(port)), timeout=10) as c:
            for req, seq in zip(reqs, replies):
                c.sendall(req)
                for f in seq:
                    assert chaos._read_frame(c) == f
        assert srv.got == reqs
        assert proxy.requests_seen == len(reqs)
        assert proxy.faults_injected == 0
    finally:
        proxy.close()
        srv.close()


def _feed(frame):
    a, b = socket.socketpair()
    a.sendall(frame)
    a.close()
    return b


@pytest.mark.parametrize("cls", [FaultInjectingProxy, JaxProxy])
def test_cut_stream_cuts_after_k_frames(cls):
    """The router tests' fault: ``cut_stream`` relays exactly k reply
    frames of a stream, then resets — the same in both proxies."""
    reqs, replies = _frames()
    srv = _RecordingServer([replies[2]])
    proxy = cls(srv.addr, serve_stream_op=3)
    proxy.script(("cut_stream", 2))
    try:
        host, _, port = proxy.addr.rpartition(":")
        with socket.create_connection((host, int(port)), timeout=10) as c:
            c.sendall(reqs[2])
            assert chaos._read_frame(c) == replies[2][0]
            assert chaos._read_frame(c) == replies[2][1]
            with pytest.raises((ConnectionError, OSError)):
                chaos._read_frame(c)
        assert proxy.faults_injected == 1
    finally:
        proxy.close()
        srv.close()

