"""The port's elastic-capacity subsystem (``byteps_tpu_torch/serving/
autoscale``), held against the JAX package's on the same inputs.

* ``ScalePolicy``: the decisions of JAX's scripted traces
  (``tests/test_autoscale.py``) and of hypothesis-drawn traces are equal,
  action, target, reason and dry-run flag alike.
* ``TierSignals``: load folding (queue depth, the KV-pressure floor),
  window eviction and the aggregate are equal.
* ``AdmissionController``: the wait estimate, the shed verdicts and the
  service-time EWMA are equal; ``OverloadShedError`` is the port's
  ``AdmissionError``, typed and retryable as JAX's.
* ``TenantShares``: the same borrow / clawback / release script leaves
  the same pools and loans.
* ``AutoscaleController`` scales a port router up and down through an
  in-process ``spawn_fn`` (real port replicas on the CPU), and a failed
  spawn journals its abort.
* ``ReplicaLauncher``'s default path runs ``python -m
  byteps_tpu_torch.launcher`` with ``DMLC_ROLE=serve`` (a stub ``Popen``
  stands a CPU replica up on the port it was given: a real serve child
  needs a GPU).
* A port router sheds best-effort at the door, typed, while guaranteed
  queues and completes.
"""

import sys
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from byteps_tpu.common.scheduler import ScheduledQueue as JaxQueue
from byteps_tpu.serving.autoscale import AdmissionController as JaxAdmission
from byteps_tpu.serving.autoscale import OverloadShedError as JaxShed
from byteps_tpu.serving.autoscale import ScalePolicy as JaxPolicy
from byteps_tpu.serving.autoscale import SignalSample as JaxSample
from byteps_tpu.serving.autoscale import TenantShares as JaxShares
from byteps_tpu.serving.autoscale import TierSignals as JaxSignals
from byteps_tpu.serving.autoscale import normalize_slo as jax_normalize_slo
from byteps_tpu.serving.scheduler import AdmissionError as JaxAdmissionError
from byteps_tpu_torch.common.scheduler import ScheduledQueue
from byteps_tpu_torch.models.transformer import (Transformer,
                                                 TransformerConfig,
                                                 init_weights)
from byteps_tpu_torch.observability.metrics import MetricsRegistry
from byteps_tpu_torch.resilience.policy import RetryPolicy
from byteps_tpu_torch.serving import (AutoscaleController, OverloadShedError,
                                      ReplicaLauncher, ScalePolicy,
                                      ServeMetrics, ServeRouter,
                                      ServingEngine, TenantShares,
                                      TierSignals, normalize_slo, serve)
from byteps_tpu_torch.serving import metrics as sm
from byteps_tpu_torch.serving import router as rt
from byteps_tpu_torch.serving.autoscale import actuator
from byteps_tpu_torch.serving.autoscale.actuator import ReplicaHandle
from byteps_tpu_torch.serving.autoscale.admission import AdmissionController
from byteps_tpu_torch.serving.autoscale.signals import (SignalSample,
                                                        poll_router)
from byteps_tpu_torch.serving.scheduler import AdmissionError

M = 6
KW = dict(vocab_size=61, num_layers=2, num_heads=2, d_model=32, d_ff=64,
          max_seq_len=64)


# ------------------------------------------------------------- policy


def _dec(d):
    return (d.action, d.target, d.reason, d.dry_run, d.acts)


# the three scripted traces of JAX's policy tests: (policy kwargs,
# [(load, current, now), ...])
TRACES = [
    (dict(min_replicas=1, max_replicas=4, up_threshold=0.8,
          down_threshold=0.3, up_cooldown_s=5.0, down_cooldown_s=15.0),
     [(0.5, 2, 0.0), (3.2, 1, 1.0), (2.0, 2, 2.0), (9.9, 4, 3.0),
      (0.1, 4, 10.0), (0.1, 4, 16.5), (0.1, 3, 17.0), (0.0, 1, 1000.0)]),
    (dict(min_replicas=2, max_replicas=3, up_cooldown_s=1e9,
          down_cooldown_s=1e9),
     [(0.0, 1, 0.0), (5.0, 5, 0.0)]),
    (dict(up_threshold=0.8, up_cooldown_s=5.0, dry_run=True),
     [(1.5, 1, 0.0), (1.5, 1, 1.0)]),
]


@pytest.mark.parametrize("i", range(len(TRACES)))
def test_scale_policy_scripted_traces_match_jax(i):
    kw, trace = TRACES[i]
    mine, ref = ScalePolicy(**kw), JaxPolicy(**kw)
    got = [_dec(mine.decide(*step)) for step in trace]
    assert got == [_dec(ref.decide(*step)) for step in trace]
    if i == 0:   # JAX's own expectations on its first trace
        assert [g[:2] for g in got] == [
            ("hold", 2), ("up", 4), ("hold", 2), ("hold", 4),
            ("hold", 4), ("down", 3), ("hold", 3), ("hold", 1)]


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 3), st.integers(0, 3), st.booleans(),
       st.lists(st.tuples(st.floats(0.0, 6.0, allow_nan=False),
                          st.integers(0, 8),
                          st.floats(0.0, 20.0, allow_nan=False)),
                min_size=1, max_size=25))
def test_scale_policy_drawn_trace_matches_jax(lo, extra, dry, trace):
    kw = dict(min_replicas=lo, max_replicas=lo + extra, up_threshold=0.8,
              down_threshold=0.3, up_cooldown_s=2.0, down_cooldown_s=5.0,
              dry_run=dry)
    mine, ref = ScalePolicy(**kw), JaxPolicy(**kw)
    now = 0.0
    for load, cur, dt in trace:
        now += dt
        assert _dec(mine.decide(load, cur, now)) == _dec(
            ref.decide(load, cur, now))


def test_scale_policy_refusals_match_jax():
    for kw in (dict(min_replicas=3, max_replicas=2),
               dict(up_threshold=0.3, down_threshold=0.8)):
        with pytest.raises(ValueError) as a:
            ScalePolicy(**kw)
        with pytest.raises(ValueError) as b:
            JaxPolicy(**kw)
        assert str(a.value) == str(b.value)
    s, js = SignalSample(3, 2, queued=1), JaxSample(3, 2, queued=1)
    assert _dec(ScalePolicy().decide(s, 1, 0.0)) == _dec(
        JaxPolicy().decide(js, 1, 0.0))


# ------------------------------------------------------------- signals


def _agg(a):
    return (round(a.load, 12), a.n_samples, a.queued,
            round(a.utilization, 12), a.ttft_p99_s)


def test_tier_signals_folding_and_eviction_match_jax():
    samples = [(2, 4), (4, 4, 4), (0, 4, 0, 0.0, 0.0, 1, 10), (3, 0),
               (0, 2), (2, 2, 2), (2, 2, 4, 0.7)]
    for args in samples:
        assert SignalSample(*args).load == JaxSample(*args).load
    script = [(0, 2), (2, 2, 2), (2, 2, 4, 0.7), (1, 1), (1, 3, 0, 0.2),
              (0, 1, 0, 0.0, 0.0, 2, 8)]
    mine = TierSignals(iter(SignalSample(*a) for a in script).__next__,
                       window_s=5.0)
    ref = JaxSignals(iter(JaxSample(*a) for a in script).__next__,
                     window_s=5.0)
    for now in (0.0, 1.0, 2.0, 4.0, 7.0, 12.5):
        assert _agg(mine.sample(now=now)) == _agg(ref.sample(now=now))
    assert _agg(mine.aggregate()) == _agg(ref.aggregate())


# ------------------------------------------------------------ admission


def test_admission_wait_and_shed_math_match_jax():
    for seed in (2.0, 0.5):
        mine, ref = (AdmissionController(service_estimate_s=seed),
                     JaxAdmission(service_estimate_s=seed))
        for obs in (3.0, 0.1, 1.7):
            mine.note_service(obs)
            ref.note_service(obs)
            assert mine.service_estimate_s == ref.service_estimate_s
        for slo in ("guaranteed", "standard", "best-effort"):
            for inflight, queued, cap in ((2, 0, 4), (4, 2, 4), (40, 40, 4),
                                          (9, 30, 2), (1, 0, 0)):
                assert mine.estimate_wait(inflight, queued, cap) == \
                    ref.estimate_wait(inflight, queued, cap)
                a = b = None
                try:
                    a = ("ok", mine.admit(slo, inflight, queued, cap))
                except OverloadShedError as e:
                    a = ("shed", e.slo, e.est_wait_s, e.deadline_s, str(e))
                try:
                    b = ("ok", ref.admit(slo, inflight, queued, cap))
                except JaxShed as e:
                    b = ("shed", e.slo, e.est_wait_s, e.deadline_s, str(e))
                assert a == b
        assert mine.shed_count == ref.shed_count
    e = OverloadShedError("best-effort", 2.5, 1.0)
    assert isinstance(e, AdmissionError) and e.retryable
    assert str(e) == str(JaxShed("best-effort", 2.5, 1.0))
    for v in (None, "", "Guaranteed", "BEST_EFFORT", "  standard  "):
        assert normalize_slo(v) == jax_normalize_slo(v)
    with pytest.raises(AdmissionError) as a:
        normalize_slo("platinum")
    with pytest.raises(JaxAdmissionError) as b:
        jax_normalize_slo("platinum")
    assert str(a.value) == str(b.value)


def _shares_script(queue_cls, shares_cls):
    pools = {"big": queue_cls(scheduled=True, credit_bytes=10, name="b"),
             "small": queue_cls(scheduled=True, credit_bytes=1, name="s")}
    shares = shares_cls(pools)
    log = []

    def snap():
        log.append((pools["big"].credits, pools["small"].credits,
                    shares.borrowed_total, shares.clawbacks_total,
                    shares.outstanding_loans("big")))

    own = shares.acquire("small")
    loan = shares.acquire("small", reclaimable=True)
    snap()
    big = [shares.acquire("big") for _ in range(9)]
    snap()
    log.append((loan.lender, loan.borrowed, shares.clawback("big"),
                loan.reclaimed))
    shares.release(loan)
    snap()
    got = shares.acquire("big", timeout=0.0)
    log.append((got.borrowed, got.lender))
    for lease in [own, got] + big:
        shares.release(lease)
    snap()
    strict = shares_cls(pools, borrow=False)
    a1 = strict.acquire("small")
    log.append(strict.acquire("small", timeout=0.02))
    strict.release(a1)
    free = strict.acquire("nobody")
    log.append((free.borrowed, free.tenant))
    strict.release(free)
    snap()
    return log


def test_tenant_shares_match_jax():
    assert (_shares_script(ScheduledQueue, TenantShares)
            == _shares_script(JaxQueue, JaxShares))


# ------------------------------------------------------ the controller


def _model(seed=0):
    m = Transformer(TransformerConfig(dtype=torch.float32, **KW),
                    device="cpu")
    init_weights(m, seed)
    return m


def _replica(model):
    eng = ServingEngine(model, n_slots=2, max_seq=64, device="cpu",
                        metrics=ServeMetrics(), paged=True, block=8,
                        chunk=16)
    srv, t = serve(eng, 0, host="127.0.0.1", in_thread=True)
    return eng, srv, t, f"127.0.0.1:{srv.server_address[1]}"


def _stop(srv, t):
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


def _retry():
    return RetryPolicy(max_attempts=5, backoff_base=0.02, jitter=0.0,
                       backoff_cap=0.1, deadline=0.0)


def test_controller_scales_a_port_tier_up_and_down():
    """A real port tier: one seed replica, a load spike scales it to two
    through an in-process ``spawn_fn`` (the new replica passes the
    weights handshake and serves), idle load retires it again — LIFO,
    journaled intent then done each way."""
    model = _model()
    seed = _replica(model)
    spawned, stopped = [], []

    def spawn():
        eng, srv, t, addr = _replica(model)
        spawned.append((eng, srv, t))
        return ReplicaHandle(addr)

    def stop(handle):
        stopped.append(handle.addr)
        for eng, srv, t in spawned:
            if f"127.0.0.1:{srv.server_address[1]}" == handle.addr:
                _stop(srv, t)

    router = ServeRouter([seed[3]], affinity=False, credits=2,
                         deadline=20.0, stream_timeout=5.0,
                         ping_timeout=10.0, retry=_retry(),
                         registry=MetricsRegistry())
    journal = []
    inner = router.journal_scale

    def record(op, addr=None, idx=None, phase="intent"):
        journal.append((op, addr is not None, phase))
        return inner(op, addr=addr, idx=idx, phase=phase)

    router.journal_scale = record
    load = {"s": SignalSample(2, 1)}
    ctl = AutoscaleController(
        router, ScalePolicy(1, 2, 0.8, 0.3, up_cooldown_s=0.0,
                            down_cooldown_s=0.0),
        TierSignals(lambda: load["s"], window_s=0.0),
        ReplicaLauncher(spawn_fn=spawn, stop_fn=stop), interval_s=0.01)
    try:
        router.start()
        d = ctl.step(now=0.0)
        assert d.action == "up" and d.target == 2
        assert router.placeable_count() == 2 and ctl.scale_ups == 1
        p = np.arange(3, 12, dtype=np.int32)
        want = list(router.stream(p, M))
        assert [list(router.stream(p, M)) for _ in range(3)] == [want] * 3
        assert spawned[0][0].metrics.get(sm.SUBMITTED) >= 1
        load["s"] = SignalSample(0, 2)
        d = ctl.step(now=1.0)
        assert d.action == "down" and d.target == 1
        assert router.placeable_count() == 1 and ctl.scale_downs == 1
        assert stopped == [router._replicas[1].addr]
        assert journal == [("up", False, "intent"), ("up", True, "done"),
                           ("down", True, "intent"), ("down", True, "done")]
        assert router.pending_scale() is None
        assert router._registry.get("autoscale.replicas").value == 1
        assert list(router.stream(p, M)) == want
    finally:
        router.close()
        _stop(seed[1], seed[2])


class _FakeRouter:
    def __init__(self):
        self._registry = MetricsRegistry()
        self.journal = []
        self._pending = None

    def placeable_count(self):
        return 1

    def journal_scale(self, op, addr=None, idx=None, phase="intent"):
        self.journal.append((op, addr, phase))
        self._pending = None if phase != "intent" else {"op": op}

    def pending_scale(self):
        return self._pending


def test_controller_failed_spawn_journals_abort():
    r = _FakeRouter()

    def boom():
        raise RuntimeError("no capacity")

    ctl = AutoscaleController(
        r, ScalePolicy(1, 4, 0.8, 0.3, up_cooldown_s=0.0),
        TierSignals(lambda: SignalSample(2, 1), window_s=0.0),
        ReplicaLauncher(spawn_fn=boom), interval_s=0.01)
    with pytest.raises(RuntimeError, match="no capacity"):
        ctl.step(now=0.0)
    assert ctl.spawn_failures == 1 and ctl.scale_ups == 0
    assert r.journal == [("up", None, "intent"), ("up", None, "abort")]
    assert r.pending_scale() is None


class _StubProc:
    """What ``subprocess.Popen`` returns, with a CPU replica standing in
    for the serve child the command line names."""

    def __init__(self, cmd, env):
        self.cmd, self.env, self.returncode = cmd, env, None
        eng = ServingEngine(_model(), n_slots=1, max_seq=64, device="cpu",
                            metrics=ServeMetrics())
        self.srv, self.t = serve(eng, int(env["BYTEPS_SERVE_PORT"]),
                                 host="127.0.0.1", in_thread=True)

    def poll(self):
        return self.returncode

    def terminate(self):
        _stop(self.srv, self.t)
        self.returncode = -15

    def wait(self, timeout=None):
        return self.returncode

    def kill(self):
        self.terminate()


def test_replica_launcher_runs_the_ports_launcher(monkeypatch):
    procs = []

    def fake_popen(cmd, env=None):
        procs.append(_StubProc(cmd, env))
        return procs[-1]

    monkeypatch.setattr(actuator.subprocess, "Popen", fake_popen)
    launcher = ReplicaLauncher(base_env={"BYTEPS_SERVE_SLOTS": "1",
                                         "PATH": "/usr/bin"},
                               startup_timeout_s=20.0)
    assert launcher.startup_timeout_s == 20.0
    assert ReplicaLauncher().startup_timeout_s == 30.0
    h = launcher.spawn()
    try:
        (p,) = procs
        assert p.cmd == [sys.executable, "-m", "byteps_tpu_torch.launcher"]
        assert p.env["DMLC_ROLE"] == "serve"
        assert p.env["BYTEPS_SERVE_SLOTS"] == "1"
        assert h.addr == f"127.0.0.1:{p.env['BYTEPS_SERVE_PORT']}"
        assert h.proc is p
    finally:
        launcher.stop(h)
    assert p.returncode == -15


# ---------------------------------------------------- the router's door


def test_port_router_sheds_best_effort_at_the_door():
    """With the one credit held by a live stream, a best-effort arrival's
    estimated wait (10 s) blows its 1 s deadline: typed, retryable shed;
    an unknown class is refused typed; guaranteed queues and
    completes."""
    model = _model()
    eng, srv, t, addr = _replica(model)
    router = ServeRouter([addr], affinity=False, credits=1, deadline=20.0,
                         stream_timeout=5.0, ping_timeout=10.0,
                         retry=_retry(), registry=MetricsRegistry(),
                         slo_deadlines={"best-effort": 1.0},
                         service_estimate_s=10.0).start()
    p0, p1 = (np.arange(5, 14, dtype=np.int32),
              np.arange(20, 31, dtype=np.int32))
    try:
        want1 = list(router.stream(p1, M))
        held = router.stream(p0, M)
        first = next(held)
        snap = poll_router(router)()
        assert (snap.capacity, snap.inflight) == (1, 1)
        with pytest.raises(OverloadShedError) as ei:
            list(router.stream(p1, M, slo="best-effort"))
        assert ei.value.retryable and ei.value.slo == "best-effort"
        with pytest.raises(AdmissionError, match="platinum"):
            list(router.stream(p1, M, slo="platinum"))
        done = threading.Event()
        rest = []

        def finish():
            rest.extend(held)
            done.set()

        threading.Thread(target=finish, daemon=True).start()
        assert list(router.stream(p1, M, slo="guaranteed")) == want1
        assert done.wait(20.0) and len([first] + rest) == M
        st_ = router.stats()
        assert st_[rt.SHED_BEST_EFFORT] == 1 and st_[rt.SHED_GUARANTEED] == 0
    finally:
        router.close()
        _stop(srv, t)
